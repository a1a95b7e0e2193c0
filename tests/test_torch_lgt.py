"""LGT-Net in the port (models/lgt.py, models/swg.py) against the
benchmark's plain float32 reference (benchmark/reference/lgt.py, loaded by
path), on the CPU at 512x128: 32 columns, two windows of 16, a global
table of 17 entries, at the published width 1024 (8 heads of 128,
feed-forward 2048) on seeded random weights.

Held: the train-mode forward's depth and ratio, the loss and every
parameter's gradient, the horizon-depth and ratio labels, the
relative-position index maps at the full 256 columns, the train CLI's
``--model lgt`` with --resume, and (on a card only) one captured step.

Tolerances, float32 against float32: the two forwards differ in the
order of their sums (the port's height stage resizes by a product with
an interpolation matrix, its attention scales the logits after the
product), so outputs agree within 2e-4 of their largest magnitude, the
losses within 1e-4 of their values, and a gradient within 2e-4 of the
larger of the leaf's norm and the median leaf's for the transformer and
the head (the median leaf reads about 2e-5), 1e-2 for the shared encoder
and height stage, where the train-mode batch norms of fifty layers at
this small size carry an order-of-sum difference up to 3.4e-3; labels
within 1e-5.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.data.labels import horizon_depth
from horizonnet_tpu_torch.data.synth import synth_room
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.models import swg
from horizonnet_tpu_torch.train import checkpoint
from horizonnet_tpu_torch.utils.image import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
H, W, B = 512, 128, 2
#: the shared feature extractor's parameters
ENCODER = ("feature_extractor.", "reduce_height_module.")


def _reference():
    """benchmark/reference/lgt.py, loaded by path (it imports its
    siblings as ``reference.*``)."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    spec = importlib.util.spec_from_file_location(
        "reference.lgt", os.path.join(BENCH, "reference", "lgt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference()


def _seeded(model, seed=7):
    """The model's own random init, shaped as a trained network's (as the
    benchmark seeds it): relative-position tables 0.2 z, norms and biases
    off their identity by 0.05 z, each bottleneck's last batch-norm gamma
    x 0.2 (a train-mode forward of resnet50 at gain 1 is chaotic)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        z = torch.randn(v.shape, generator=gen)
        if k.endswith(".rpe"):
            sd[k] = 0.2 * z
        elif k.endswith((".bias", "running_mean")) or (
                v.dim() == 1 and k.endswith(".weight")):
            sd[k] = v + 0.05 * z
        if k.endswith(".bn3.weight"):
            sd[k] = sd[k] * 0.2
    model.load_state_dict(sd)
    return sd


@pytest.fixture(scope="module")
def pair():
    """(port model, reference, input, targets) at 512x128, float32."""
    model = build_model("resnet50", arch="lgt", W=W, device="cpu",
                        param_dtype=torch.float32, seed=3)
    sd = _seeded(model)
    net = ref.build(sd, "cpu", W=W)
    gen = torch.Generator().manual_seed(11)
    x = torch.rand(B, 3, H, W, generator=gen)
    y_depth = 1.0 + 3.0 * torch.rand(B, W // 4, generator=gen)
    y_ratio = 0.5 + torch.rand(B, 1, generator=gen)
    return model, net, x, (y_depth, y_ratio)


def test_forward_matches_the_reference(pair):
    model, net, x, _ = pair
    model.train(), net.train()
    with torch.no_grad():
        depth, ratio = model(x)
        want_d, want_r = net(x)
    assert depth.shape == (B, W // 4) and ratio.shape == (B, 1)
    assert depth.dtype == ratio.dtype == torch.float32
    scale = float(want_d.abs().max())
    assert float((depth - want_d).abs().max()) <= 2e-4 * scale
    assert float((ratio - want_r).abs().max()) <= 2e-4 * max(
        float(want_r.abs().max()), 1.0)


def _grads(params):
    return {k: p.grad.detach().clone() for k, p in params.items()}


def test_loss_and_gradients_match_the_reference(pair):
    model, net, x, targets = pair
    model.train(), net.train()
    mine_p = dict(model.named_parameters())
    ref_p = dict(net.named_parameters())
    assert sorted(mine_p) == sorted(ref_p)
    for p in list(mine_p.values()) + list(ref_p.values()):
        p.grad = None
    losses = model.losses(model(x), targets)
    losses["total"].backward()
    terms = ref.loss_terms(*net(x), *targets)
    want = ref.total_loss(terms)
    want.backward()
    for k, v in terms.items():
        assert float(losses[k].detach()) == pytest.approx(float(v.detach()),
                                                          rel=1e-4)
    assert float(losses["total"].detach()) == pytest.approx(float(want),
                                                            rel=1e-4)
    g_mine, g_ref = _grads(mine_p), _grads(ref_p)
    norms = {k: float(g.norm()) for k, g in g_ref.items()}
    med = float(np.median(list(norms.values())))
    for k in g_ref:
        gap = float((g_mine[k] - g_ref[k]).norm()) / max(norms[k], med)
        tol = 1e-2 if k.startswith(ENCODER) else 2e-4
        assert gap <= tol, (k, gap)
    for p in list(mine_p.values()) + list(ref_p.values()):
        p.grad = None


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_labels_match_the_reference(seed):
    _, cor = synth_room(np.random.default_rng(seed), H, 1024)
    depth, ratio = horizon_depth(cor, H, 1024, 256)
    want_d, want_r = ref.horizon_depth(cor, H, 1024, 256)
    assert depth.shape == (256,) and np.isfinite(depth).all()
    np.testing.assert_allclose(depth, want_d, rtol=1e-5, atol=1e-5)
    assert ratio == pytest.approx(want_r, rel=1e-5)


def test_labels_of_a_square_room():
    """A 2 m square room centred on the camera, ceiling 1 m above it: the
    depth along longitude t is 1 / max(|cos t|, |sin t|), and the ratio
    is 1 / 1.6."""
    from horizonnet_tpu_torch.geometry.equirect_host import u2coorx, v2coory

    cor = []
    for u in np.array([-3, -1, 1, 3]) * np.pi / 4:
        r = np.sqrt(2.0)
        x = u2coorx(u)
        cor += [[x, v2coory(-np.arctan(1.0 / r))],
                [x, v2coory(np.arctan(1.6 / r))]]
    depth, ratio = horizon_depth(np.array(cor), H, 1024, 256)
    t = ((np.arange(256) + 0.5) / 256 - 0.5) * 2 * np.pi
    want = 1.0 / np.maximum(np.abs(np.cos(t)), np.abs(np.sin(t)))
    np.testing.assert_allclose(depth, want, rtol=1e-5)
    assert ratio == pytest.approx(1.0 / 1.6)


# the relative-position index maps at the published 256 columns

def _shifted_window_columns():
    cols = torch.arange(256)
    return torch.roll(cols, 8)[:16].tolist()


@pytest.mark.parametrize("case", ["symmetric", "entries", "seam",
                                  "shifted_window", "window_offsets"])
def test_index_maps(case):
    g = swg.global_index(256)
    if case == "symmetric":
        assert torch.equal(g, g.T) and int(g.diagonal().abs().sum()) == 0
    elif case == "entries":
        assert sorted(set(g.flatten().tolist())) == list(range(129))
    elif case == "seam":
        assert int(g[0, 255]) == 1 and int(g[3, 250]) == 9
        assert int(g[0, 128]) == 128 and int(g[0, 129]) == 127
    elif case == "shifted_window":
        assert _shifted_window_columns() == list(range(248, 256)) + list(
            range(8))
    else:
        w = swg.window_index(16)
        assert int(w[0, 15]) == 30 and int(w[15, 0]) == 0
        assert int(w[3, 5]) == 5 - 3 + 15
        assert sorted(set(w.flatten().tolist())) == list(range(31))


def test_a_shifted_block_attends_across_the_seam():
    """Column 0 of a shifted block sees column 255 (they share its first
    window); an unshifted window block's column 0 does not."""
    torch.manual_seed(0)
    n = 256
    for kind, sees in (("shifted", True), ("window", False)):
        blk = swg.Attention(64, 8, kind, n, 16)
        with torch.no_grad():
            for p in blk.parameters():
                p.normal_(0, 0.1)
        x = torch.randn(1, n, 64, requires_grad=True)
        blk(x)[0, 0].sum().backward()
        assert bool(x.grad[0, 255].abs().sum() > 0) == sees


def test_mark_backward_passes_the_gradient_unchanged():
    """The backward-pass stage mark is the identity both ways (off a
    capture it records nothing)."""
    from horizonnet_tpu_torch.utils import profiling

    x = torch.randn(3, 4, requires_grad=True)
    y = profiling.mark_backward(x, "stage")
    assert torch.equal(y, x) and y.requires_grad
    (y * torch.arange(12.0).view(3, 4)).sum().backward()
    assert torch.equal(x.grad, torch.arange(12.0).view(3, 4))
    z = torch.randn(2)
    assert profiling.mark_backward(z, "stage") is z


# the train CLI and its checkpoints

def _rooms(root, n, width, seed0=100):
    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "label_cor"))
    for i in range(n):
        img, cor = synth_room(np.random.default_rng(seed0 + i), H, width)
        write_png(os.path.join(root, "img", f"room{i}.png"), img)
        np.savetxt(os.path.join(root, "label_cor", f"room{i}.txt"), cor,
                   fmt="%.4f")
    return root


def _args(tmp_path, run_id, data, *extra):
    return ["--id", run_id, "--ckpt", str(tmp_path / "ck"), "--logs",
            str(tmp_path / "lg"), "--model", "lgt", "--backbone",
            "resnet18", "--train_root_dir", data, "--valid_root_dir", data,
            "--batch_size_train", "2", "--batch_size_valid", "2",
            "--num_workers", "1", "--save_every", "100", "--lr", "1e-3",
            "--device", "cpu", *extra]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def test_cli_trains_lgt_and_resumes(tmp_path, capsys):
    """``--model lgt`` on 2 rooms at 512x128 (resnet18: width 256): the
    run stopped after epoch 1 and resumed writes the checkpoint of the
    unbroken 2-epoch run, bit for bit (weights, statistics, Adam's
    moments, its count), and the checkpoint loads as LGT-Net."""
    from horizonnet_tpu_torch.cli.train import main

    data = _rooms(str(tmp_path / "data"), 2, W)
    assert main(_args(tmp_path, "a", data, "--epochs", "2")) == 0
    assert "Ep  2" in capsys.readouterr().out
    path_a = str(tmp_path / "ck" / "a" / "checkpoint.ckpt")
    head_a, pay_a = checkpoint.read_checkpoint(path_a)
    assert head_a["kwargs"] == {"arch": "lgt", "backbone": "resnet18",
                                "W": W}
    assert main(_args(tmp_path, "b", data, "--epochs", "1")) == 0
    assert main(_args(tmp_path, "b", data, "--epochs", "2", "--resume",
                      str(tmp_path / "ck" / "b"))) == 0
    assert "Resumed from" in capsys.readouterr().out
    _, pay_b = checkpoint.read_checkpoint(
        str(tmp_path / "ck" / "b" / "checkpoint.ckpt"))
    assert int(pay_b["step"]) == int(pay_a["step"]) == 2
    la, lb = list(_leaves(pay_a)), list(_leaves(pay_b))
    assert [p for p, _ in la] == [p for p, _ in lb] and len(la) > 100
    assert any(p[:2] == ("opt_state", "nu") for p, _ in la)
    for (p, a), (_, b) in zip(la, lb):
        np.testing.assert_array_equal(a, b, err_msg="/".join(p))
    model, sd = checkpoint.load_trained_model(path_a, device="cpu")
    assert model.ARCH == "lgt" and model.n == W // 4
    assert torch.equal(model.state_dict()["swg.blocks.1.attn.rpe"],
                       sd["swg.blocks.1.attn.rpe"])


# on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step is captured as a CUDA "
                    "graph only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_step_equals_the_eager_step(cuda):
    """One step captured as a CUDA graph gives the eager step's losses
    and first moments (the relative-position tables' gradients sum by
    atomics, so not bit for bit), its block counters add 4 of each kind a
    replay, and the device stages of a traced replay come out in order."""
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)
    from horizonnet_tpu_torch.utils import profiling

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (B, H, 1024, 3)).astype(np.float32)
    y = (rng.uniform(1, 4, (B, 256)).astype(np.float32),
         rng.uniform(0.5, 1.5, (B, 1)).astype(np.float32))
    out = []
    for graph in (True, False):
        model = build_model("resnet50", arch="lgt", device=cuda,
                            dtype=torch.bfloat16, param_dtype=torch.float32)
        tx = make_optimizer("Adam", warmup_poly_schedule(1e-4, 100))
        state = create_train_state(model, tx)
        eng = TrainEngine(model, state, B, H, 1024, device=cuda,
                          graph=graph)
        c0 = (swg.window_blocks, swg.global_blocks)
        with profiling.enable():
            m = eng.step(x, *y, torch.Generator(device=cuda))
            torch.cuda.synchronize()
        out.append((m, {k: v.detach().cpu() for k, v in
                        state.opt.moments["mu"].items()}))
        if graph:
            assert (swg.window_blocks - c0[0],
                    swg.global_blocks - c0[1]) == (4, 4)
            names = [s.name for s in profiling.spans()
                     if s.name.startswith("device.")][-6:]
            assert names == ["device.encoder_fwd", "device.swg_fwd",
                             "device.head_loss", "device.swg_bwd",
                             "device.encoder_bwd", "device.optim"]
    (m_g, mu_g), (m_e, mu_e) = out
    for k in m_g:
        assert float(m_g[k]) == pytest.approx(float(m_e[k]), rel=1e-6), k
    for k in mu_g:
        gap = float((mu_g[k] - mu_e[k]).norm())
        assert gap <= 1e-3 * float(mu_e[k].norm()) + 1e-12, k
