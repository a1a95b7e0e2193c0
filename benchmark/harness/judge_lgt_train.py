"""Whether the LGT-Net training program's first steps are the recipe's.

As harness/judge_train.py judges HorizonNet's: after the window, with the
program's state freed, the reference (reference/lgt.py: float32, TF32
off) takes the same first steps from the same seeded weights, on the
same rooms, the augmentation worked out again by reference/augment.py
from the same generator and the labels by reference/lgt.py, with Adam
and the warmup-poly rate of reference/train.py. Leaves are kept by
judge_train's rule (QUIET). The numbers (``gaps``; every gap relative):

``grad_gap``    the first gradient (Adam's mu / (1 - b1) after step 1):
                the median leaf's gap of norms, as judge_train's.
``update_gap``  the change over the checked steps: the worst leaf's gap
                of norms over the larger of its reference norm and the
                median leaf's, as judge_train's.
``turn_gap``    that change's direction: the median leaf's one less the
                cosine between the program's change and the reference's.
                Not the worst leaf's, as judge_train takes: the depth
                head's bias is one number whose first gradient is a sum of
                L1 signs over 6144 columns that nearly cancels, and its
                change over three steps turns around under bf16 rounding
                alone (the reference with bf16 operands does it too, the
                program in float32 does not; PERF.md).
``rpe_turn``    the worst relative-position table's turn: a table the
                program leaves out, misreads or reads at unshifted columns
                moves another way than the reference's.
``loss_gap``    the first step's loss, relative; read by the tools, with
                no limit: sound bf16 seeds read up to 4.7e-3, over a
                third of the train cell's limit of 8e-3.

``readings`` gives the numbers of a control, a planted fault or a witness
in the program's place, for setting the limits (benchmark/tools/
lgt_control.py): ``bf16`` the program's checked steps, ``fp8`` the
reference with every product's operands in float8 e4m3, the reference
built with one of reference/lgt.py's FAULTS (``no_rg``: the global blocks
without their panoramic bias; ``unshifted``: the shifted blocks not
shifted; ``rw_transposed``: the window tables read at i - j), and the
witnesses ``f32`` (the program computing in float32, TF32 off) and
``ref_bf16`` (the reference with bf16 operands).
"""

import numpy as np
import torch

from harness.judge_train import QUIET, _leaf_gaps, _leaf_turns
from reference import augment as ref_aug
from reference import lgt as ref_lgt
from reference import train as ref_train


def reference_batch(driver, k, device):
    """Step k's batch worked out by the reference: (x [B, 3, H, W],
    y_depth [B, W/4], y_ratio [B, 1]) on ``device``."""
    H, W = driver.H, driver.W
    idx, aug_seed = driver.plan(k)
    rng = np.random.default_rng(aug_seed)
    cors = [driver.cors[i] for i in idx]
    ps = [ref_aug.sample_aug_params(rng, c, W) for c in cors]
    vec = lambda key, dt: torch.tensor(  # noqa: E731
        [p[key] for p in ps], dtype=dt, device=device)
    imgs = torch.from_numpy(driver.imgs[idx]).to(device)
    x = ref_aug.augment_images(
        imgs, vec("kx", torch.float32), vec("ky", torch.float32),
        vec("flip", torch.bool), vec("dx", torch.int64),
        vec("p", torch.float32))
    labels = [ref_lgt.horizon_depth(ref_aug.transform_corners(c, p, W), H,
                                    W, W // 4) for c, p in zip(cors, ps)]
    y_depth = np.stack([d for d, _ in labels])
    y_ratio = np.array([[r] for _, r in labels], np.float32)
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return x.permute(0, 3, 1, 2), t(y_depth), t(y_ratio)


def reference_steps(driver, lowp=None, fault=None):
    """The reference's checked steps -> {"losses", "grad1", "params0",
    "params3"} (host tensors). ``lowp`` rounds every product's operands
    (the control); ``fault`` builds reference/lgt.py's planted fault."""
    device = driver.device
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = ref_lgt.build(driver.state_dict, device, driver.W, fault)
        ref_lgt.set_lowp(net, lowp)
        params = dict(net.named_parameters())
        params0 = {k: p.detach().cpu().clone() for k, p in params.items()}
        r = driver.recipe
        opt = ref_train.Adam(params, ref_train.warmup_poly(
            r["lr"], r["warmup_poly_iters"]), b1=r["beta1"])
        losses, grad1 = [], None
        for k in range(driver.checked):
            x, y_depth, y_ratio = reference_batch(driver, k, device)
            loss, grads = ref_lgt.step(net, opt, x, y_depth, y_ratio)
            losses.append(loss)
            if k == 0:
                grad1 = {n: g.cpu() for n, g in grads.items()}
        params3 = {k: p.detach().cpu() for k, p in params.items()}
        del net, opt
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return {"losses": losses, "grad1": grad1, "params0": params0,
            "params3": params3}


def gaps(mine, ref):
    """{number: gap} of ``mine`` (losses, grad1, params3 of the program
    or a control) against the reference's steps ``ref``."""
    loss, each = leaf_numbers(mine, ref)
    _, grad, update, turn = zip(*each.values())
    return {"loss_gap": loss, "grad_gap": float(np.median(grad)),
            "update_gap": max(update), "turn_gap": float(np.median(turn)),
            "rpe_turn": max(t for k, (*_, t) in each.items()
                            if k.endswith(".attn.rpe"))}


def compare(driver, ref):
    mine = {"losses": driver.losses, "grad1": driver.grad1,
            "params3": driver.params3}
    return gaps(mine, ref)


def leaf_numbers(mine, ref):
    """(the first loss's gap, {leaf: (reference gradient norm, gradient
    gap, update gap, turn)}) over the leaves judge_train keeps."""
    gnorm = {k: float(g.norm()) for k, g in ref["grad1"].items()}
    med = float(np.median(list(gnorm.values())))
    keep = [k for k, v in gnorm.items() if v >= QUIET * med]
    d_mine = {k: mine["params3"][k] - ref["params0"][k] for k in keep}
    d_ref = {k: ref["params3"][k] - ref["params0"][k] for k in keep}
    grad = _leaf_gaps(mine["grad1"], ref["grad1"], keep)
    update = _leaf_gaps(d_mine, d_ref, keep)
    turn = _leaf_turns(d_mine, d_ref, keep)
    loss = abs(mine["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    return loss, {k: (gnorm[k], grad[k], update[k], turn[k]) for k in keep}


def bf16(t):
    """``t`` rounded to bfloat16, back in float32; the gradient passes the
    rounding unchanged (a witness: the reference with the program's
    operand precision)."""
    with torch.no_grad():
        q = t.to(torch.bfloat16).float()
    return t + (q - t).detach() if t.requires_grad else q


PATHS = ("bf16", "fp8") + ref_lgt.FAULTS
#: witnesses of what a sound program's readings come from: the program
#: computing in float32 with TF32 off, and the reference with bf16
#: operands
WITNESSES = ("f32", "ref_bf16")


def _base(cell, seed, device):
    """A driver holding the cell's rooms and seeded weights at ``seed``,
    with no program."""
    from harness.kinds.lgt_train import Driver
    from harness.kinds.train import make_rooms
    from harness.lgt_weights import seeded_weights
    from harness.trace import Spans

    d = Driver(cell, seed, device, Spans())
    d._plans = []
    d.imgs, d.cors = make_rooms(seed, d.n_rooms, d.H, d.W)
    d.state_dict = seeded_weights(cell.config, seed, device)
    return d


def path_steps(cell, seed, path, device):
    """The checked steps of ``path`` (PATHS or WITNESSES) in the program's
    place: {"losses", "grad1", "params3"}."""
    from harness.kinds.lgt_train import Driver
    from harness.trace import Spans
    from reference.model import fp8

    if path in ("bf16", "f32"):
        d = Driver(cell, seed, device, Spans())
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        if path == "f32":
            d.dtype = torch.float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        try:
            d.setup()
            d.release()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        return {"losses": d.losses, "grad1": d.grad1, "params3": d.params3}
    d = _base(cell, seed, device)
    if path in ref_lgt.FAULTS:
        return reference_steps(d, fault=path)
    return reference_steps(d, lowp={"fp8": fp8, "ref_bf16": bf16}[path])


def readings(cell, seed, path, device, ref=None):
    """{number: reading} of ``path`` (PATHS or WITNESSES) in the program's
    place, for the cell at ``seed``, against the reference's steps
    ``ref`` (worked out when not given)."""
    if ref is None:
        ref = reference_steps(_base(cell, seed, device))
    return gaps(path_steps(cell, seed, path, device), ref)
