"""Whether the training program's first steps are the recipe's.

After the window, with the program's state freed, the reference
(reference/train.py: float32, TF32 off) takes the same first steps from
the same seeded weights: the same rooms, the augmentation worked out
again by reference/augment.py from the same generator, the labels by
reference/rooms.py, the dropout masks drawn from a generator seeded as
the program's. Compared (every gap relative):

``loss_gap``    the first step's total loss.
``grad_gap``    the first step's gradient, as the program's Adam state
                holds it after one step (mu / (1 - b1)): the median leaf's
                gap between the two norms, over the larger of the
                reference leaf's norm and the median leaf's.
``update_gap``  the parameters' change over the checked steps, as the
                step after them keeps it: the worst leaf's gap between the
                two norms, over the larger of the reference leaf's and the
                median leaf's.
``turn_gap``    the direction of that change: the worst leaf's one less
                the cosine between the program's change and the
                reference's (0 where they point alike, 2 where opposite).
                Adam moves each weight by about the learning rate whatever
                its gradient's size, so the norms above read a step taken
                the wrong way as sound; this does not.

The later steps' losses and the worst leaf's gradient are not compared:
Adam's first update moves each weight by the learning rate times the
sign of its gradient, so where a gradient is near nought a rounding flips
the move, and the second step's loss departs by about a tenth on every
seed, in bf16 as against float32 (PERF.md has the readings).

Leaves whose reference gradient is under a thousandth of the median
leaf's (nought but for rounding, as a bias in front of a batch norm) move
under Adam by round-off alone and are left out of both by that rule.
"""

import numpy as np
import torch

from reference import augment as ref_aug
from reference import model as ref_model
from reference import rooms as ref_rooms
from reference import train as ref_train

#: a leaf is left out where its reference gradient norm is under this
#: share of the median leaf's
QUIET = 1e-3


def reference_batch(driver, k, device):
    """Step k's batch worked out by the reference: (x [B, 3, H, W], y_bon,
    y_cor) on ``device``."""
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
    aug = [ref_aug.transform_corners(c, p, W) for c, p in zip(cors, ps)]
    occ = [ref_rooms.find_occlusion(c[::2].copy(), W, H).repeat(2)
           for c in cors]
    y_bon = np.stack([ref_rooms.cor_2_1d(c, H, W) for c in aug])
    y_cor = np.stack([ref_rooms.corner_heatmap(c[~o, 0], W)[None]
                      for c, o in zip(aug, occ)])
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    return x.permute(0, 3, 1, 2), t(y_bon), t(y_cor)


def reference_steps(driver, lowp=None, rows=None, adam=ref_train.Adam):
    """The reference's checked steps -> {"losses", "grad1", "params0",
    "params3"} (host tensors). ``lowp`` rounds every product's operands
    (the control); ``rows`` keeps only those rows of each batch, ``adam``
    takes the optimizer's place (faults)."""
    device = driver.device
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        net = ref_model.build(driver.state_dict, device)
        ref_model.set_lowp(net, lowp)
        params = ref_train.trained_params(net)
        params0 = {k: p.detach().cpu().clone() for k, p in params.items()}
        r = driver.recipe
        opt = adam(params, ref_train.warmup_poly(
            r["lr"], r["warmup_poly_iters"]), b1=r["beta1"])
        gen = torch.Generator(device=device).manual_seed(driver.seed)
        losses, grad1 = [], None
        for k in range(driver.checked):
            x, y_bon, y_cor = reference_batch(driver, k, device)
            if rows is not None:
                x, y_bon, y_cor = x[rows], y_bon[rows], y_cor[rows]
            loss, grads = ref_train.step(net, opt, x, y_bon, y_cor, gen)
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


def _leaf_gaps(mine, ref, keep):
    """{leaf: gap of the two norms over the larger of the reference
    leaf's norm and the median leaf's}."""
    n = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(n.values())))
    return {k: abs(float(mine[k].norm()) - n[k]) / max(n[k], med)
            for k in keep}


def _leaf_turns(mine, ref, keep):
    """{leaf: one less the cosine between the two tensors}."""
    return {k: 1.0 - float(torch.nn.functional.cosine_similarity(
        mine[k].flatten().double(), ref[k].flatten().double(), dim=0,
        eps=1e-30)) for k in keep}


def gaps(mine, ref):
    """{number: gap} of ``mine`` (losses, grad1, params3 of the program
    or a control; params0 the weights both started from) against the
    reference's."""
    gnorm = {k: float(g.norm()) for k, g in ref["grad1"].items()}
    med = float(np.median(list(gnorm.values())))
    keep = [k for k, v in gnorm.items() if v >= QUIET * med]
    d_mine = {k: mine["params3"][k] - ref["params0"][k] for k in keep}
    d_ref = {k: ref["params3"][k] - ref["params0"][k] for k in keep}
    l_mine, l_ref = mine["losses"][0], ref["losses"][0]
    grad = _leaf_gaps(mine["grad1"], ref["grad1"], keep)
    update = _leaf_gaps(d_mine, d_ref, keep)
    return {"loss_gap": abs(l_mine - l_ref) / abs(l_ref),
            "grad_gap": float(np.median(list(grad.values()))),
            "update_gap": max(update.values()),
            "turn_gap": max(_leaf_turns(d_mine, d_ref, keep).values())}


def compare(driver, ref):
    mine = {"losses": driver.losses, "grad1": driver.grad1,
            "params3": driver.params3}
    return gaps(mine, ref)
