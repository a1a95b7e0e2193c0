"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
a CUDA device). This file imports no jax, so it also runs on a GPU host
without the JAX package's dependencies:

    python -m pytest -m cuda tests/test_torch_cuda.py -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.ops import cuda_lstm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# f32: the same f32 cell on both sides, sums in another order: 1e-5.
# bf16: outputs round to bf16 (half-ulp near 1 is 2e-3): 1e-2. The kernel
# is one persistent cooperative launch: a single step (T=1), one batch row,
# a batch over the 64-row tile (B=70), one direction, and the widths the
# register-resident W takes (H=32 leaves most warps without a K slice).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("T,D,B,H", [(8, 2, 3, 32), (16, 1, 70, 64),
                                     (1, 2, 4, 64), (12, 2, 1, 32),
                                     (12, 2, 70, 64), (9, 1, 5, 512),
                                     (20, 2, 64, 512)])
def test_bilstm_kernel_matches_twin(cuda, dtype, tol, T, D, B, H):
    rng = np.random.default_rng(B)
    tdt = getattr(torch, dtype)
    xw = torch.from_numpy(rng.normal(0, 1, (T, D, B, 4 * H)).astype(
        np.float32)).to(cuda, tdt)
    w = torch.from_numpy((rng.uniform(-1, 1, (D, H, 4 * H))
                          / np.sqrt(H)).astype(np.float32)).to(cuda, tdt)
    before = cuda_lstm.launches
    got = cuda_lstm.bilstm_recurrence(xw, w)
    torch.cuda.synchronize()
    assert cuda_lstm.launches == before + 1
    want = cuda_lstm.bilstm_recurrence_plain(xw, w)
    assert got.dtype == tdt and got.shape == (T, D, B, H)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_bilstm_bf16_keeps_the_f32_product(cuda):
    """At the serving shape the bf16 kernel's outputs equal the twin's bit
    for bit on at least 99.98 % of entries: its three exact bf16 products
    sum to the f32 product, so only a sum in another order that straddles a
    bf16 rounding boundary flips one. Products of one or two of the terms
    flip more (horizonnet_tpu_torch/tools/split_check.py)."""
    rng = np.random.default_rng(0)
    T, D, B, H = 256, 2, 64, 512
    xw = torch.from_numpy(rng.normal(0, 1, (T, D, B, 4 * H)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy((rng.uniform(-1, 1, (D, H, 4 * H))
                          / np.sqrt(H)).astype(np.float32)).to(
                              cuda, torch.bfloat16)
    got = cuda_lstm.bilstm_recurrence_cuda(xw, w)
    want = cuda_lstm.bilstm_recurrence_plain(xw, w)
    assert (got == want).float().mean().item() >= 0.9998


@pytest.mark.cuda
def test_bilstm_kernel_rejects_what_it_cannot_run(cuda):
    xw = torch.zeros(4, 2, 3, 4 * 12, device=cuda)
    with pytest.raises(ValueError, match="multiple of"):
        cuda_lstm.bilstm_recurrence_cuda(xw, torch.zeros(2, 12, 48,
                                                         device=cuda))
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        cuda_lstm.bilstm_recurrence_cuda(xw.half(), torch.zeros(
            2, 12, 48, device=cuda).half())
    # (H / 8) x D = 512 CTAs cannot all be resident at one per SM: the
    # cooperative launch is refused and the wrapper raises, with no fallback
    xw = torch.zeros(2, 4, 1, 4 * 1024, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(4, 1024, 4 * 1024, device=cuda, dtype=torch.bfloat16)
    before = cuda_lstm.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_lstm.bilstm_recurrence_cuda(xw, w)
    assert cuda_lstm.launches == before
    with pytest.raises(ValueError, match="at most"):
        cuda_lstm.bilstm_recurrence_cuda(
            torch.zeros(2, 1, 1, 4 * 1040, device=cuda),
            torch.zeros(1, 1040, 4 * 1040, device=cuda))


def _train_inputs(cuda, T, D, B, H, dtype, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        cuda, getattr(torch, dtype))
    xw = f(rng.normal(0, 1, (T, D, B, 4 * H)))
    w = f(rng.uniform(-1, 1, (D, H, 4 * H)) / np.sqrt(H))
    dys = f(rng.normal(0, 1, (T, D, B, H)))
    return xw, w, dys


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


# K2: as K1 (f32 1e-5; bf16 outputs round to bf16: 1e-2). K3: dxw and dW
# of order 1-10 here, so the bar is relative to the largest entry: f32
# sums in another order (1e-5), bf16 dxw rounds to bf16 (1e-2). Both are
# one persistent cooperative launch: B=3 and B=70 are not multiples of K2's
# 64-row batch tile or K3's 8-row pass, B=1 is one row, T=1 a single step
# (K3 never multiplies), H=48 gives some warps fewer K slices than others,
# and H=512 at B=64 is the width of the training shape.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("T,D,B,H", [(8, 2, 3, 32), (16, 1, 70, 64),
                                     (12, 2, 1, 64), (1, 2, 4, 64),
                                     (10, 2, 8, 48), (6, 2, 64, 512)])
def test_train_kernels_match_twins(cuda, dtype, tol, T, D, B, H):
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    xw, w, dys = _train_inputs(cuda, T, D, B, H, dtype, B)
    before = (clt.fwd_launches, clt.bwd_launches)
    got = clt.train_fwd(xw, w)
    torch.cuda.synchronize()
    want = clt.train_fwd_plain(xw, w)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _rel_err(g, r) <= tol
    ys, gates, cs = want
    dxw = clt.train_bwd(gates, cs, dys, w)
    torch.cuda.synchronize()
    assert (clt.fwd_launches, clt.bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    dxw_p = clt.train_bwd_plain(gates, cs, dys, w)
    assert dxw.dtype == dxw_p.dtype and dxw.shape == (T, D, B, 4 * H)
    assert _rel_err(dxw, dxw_p) <= tol
    assert _rel_err(clt.weight_grad(ys, dxw, w),
                    clt.weight_grad(ys, dxw_p, w)) <= tol


# Shares of bf16 outputs equal to the twin's bit for bit at the training
# shape, below which a kernel has lost the f32 contract of its products:
# set from horizonnet_tpu_torch/tools/split_check.py, which builds the
# kernels with 3, 2 and 1 terms of the split: three terms reached 99.990 %
# (K2, its lowest output) and 99.984 % (K3), two 99.961 % and 99.955 %,
# one 89.950 % and 88.707 % (PERF.md).
K2_SAME_BAR = 0.9998
K3_SAME_BAR = 0.9997


@pytest.mark.cuda
def test_train_bf16_keeps_the_f32_product(cuda):
    """At the training shape (T=256, D=2, B=8, H=512) K2's bf16 ys, gates
    and cs, and K3's bf16 dxw, equal the twins' bit for bit on at least the
    measured share: the three exact bf16 products of the split sum to the
    f32 product, so only a sum in another order that straddles a bf16
    rounding boundary flips an output."""
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    xw, w, dys = _train_inputs(cuda, 256, 2, 8, 512, "bfloat16", 0)
    got = clt.train_fwd_cuda(xw, w)
    want = clt.train_fwd_plain(xw, w)
    for name, g, r in zip(("ys", "gates", "cs"), got, want):
        same = (g == r).float().mean().item()
        assert same >= K2_SAME_BAR, (name, same)
    ys, gates, cs = want
    dxw = clt.train_bwd_cuda(gates, cs, dys, w)
    same = (dxw == clt.train_bwd_plain(gates, cs, dys, w)).float().mean()
    assert same.item() >= K3_SAME_BAR


@pytest.mark.cuda
def test_train_kernels_at_the_recipe_batch(cuda):
    """At the reference recipe's batch of 24 (T=256, D=2, H=512, bf16: what
    horizonnet_tpu_torch/tools/train_throughput.py runs) K2's ys, gates and
    cs and K3's dxw lie within 1e-2 of the twins' and equal them bit for
    bit on at least the training shape's shares."""
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    xw, w, dys = _train_inputs(cuda, 256, 2, 24, 512, "bfloat16", 24)
    got = clt.train_fwd_cuda(xw, w)
    want = clt.train_fwd_plain(xw, w)
    for name, g, r in zip(("ys", "gates", "cs"), got, want):
        assert g.shape == r.shape and _rel_err(g, r) <= 1e-2, name
        assert (g == r).float().mean().item() >= K2_SAME_BAR, name
    ys, gates, cs = want
    dxw = clt.train_bwd_cuda(gates, cs, dys, w)
    dxw_p = clt.train_bwd_plain(gates, cs, dys, w)
    assert dxw.shape == (256, 2, 24, 2048) and _rel_err(dxw, dxw_p) <= 1e-2
    assert (dxw == dxw_p).float().mean().item() >= K3_SAME_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_kernels_take_their_largest_hidden_size(cuda, dtype):
    """Each kernel runs at the largest H its wrapper admits on this card
    (bf16: W's slice in registers; f32: in shared memory), with one
    direction so the grid is resident, and refuses the next multiple."""
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    lib = clt._library()
    is_bf16 = int(dtype == "bfloat16")
    tol = 1e-2 if is_bf16 else 1e-5
    h2, h3 = lib.bilstm_train_fwd_max_h(is_bf16), lib.bilstm_bwd_max_h(is_bf16)
    if is_bf16:
        assert (h2, h3) == (1024, 1024)
    xw, w, _ = _train_inputs(cuda, 3, 1, 2, h2, dtype, 0)
    for g, r in zip(clt.train_fwd_cuda(xw, w), clt.train_fwd_plain(xw, w)):
        assert _rel_err(g, r) <= tol
    xw, w, dys = _train_inputs(cuda, 3, 1, 2, h3, dtype, 1)
    _, gates, cs = clt.train_fwd_plain(xw, w)
    assert _rel_err(clt.train_bwd_cuda(gates, cs, dys, w),
                    clt.train_bwd_plain(gates, cs, dys, w)) <= tol
    xw, w, dys = _train_inputs(cuda, 2, 1, 1, max(h2, h3) + 16, dtype, 2)
    with pytest.raises(ValueError, match="at most"):
        clt.train_fwd_cuda(xw, w)
    with pytest.raises(ValueError, match="at most"):
        clt.train_bwd_cuda(xw, dys, dys, w)


@pytest.mark.cuda
def test_train_kernels_refuse_a_grid_the_card_cannot_hold(cuda):
    """(H / 8) x D = 256 CTAs for K2 and (H / 16) x D = 192 for K3 cannot
    all be resident at one per SM: the cooperative launch is refused and
    the wrapper raises, with no fallback and no launch counted."""
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    before = (clt.fwd_launches, clt.bwd_launches)
    xw = torch.zeros(2, 2, 1, 4 * 1024, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(2, 1024, 4 * 1024, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        clt.train_fwd_cuda(xw, w)
    g = torch.zeros(2, 3, 1, 4 * 1024, device=cuda, dtype=torch.bfloat16)
    c = torch.zeros(2, 3, 1, 1024, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3, 1024, 4 * 1024, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="launch failed"):
        clt.train_bwd_cuda(g, c, c, w)
    assert (clt.fwd_launches, clt.bwd_launches) == before


@pytest.mark.cuda
def test_train_kernels_back_to_back_on_one_stream(cuda):
    """K2 then K3, twice, queued on one stream without a sync between them:
    each launch's counters and scratch start afresh."""
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    runs = [_train_inputs(cuda, 16, 2, 8, 128, "bfloat16", s)
            for s in range(2)]
    got = []
    for xw, w, dys in runs:
        ys, gates, cs = clt.train_fwd_cuda(xw, w)
        got.append((ys, clt.train_bwd_cuda(gates, cs, dys, w)))
    torch.cuda.synchronize()
    for (xw, w, dys), (ys, dxw) in zip(runs, got):
        ys_p, gates, cs = clt.train_fwd_plain(xw, w)
        assert _rel_err(ys, ys_p) <= 1e-2
        assert _rel_err(dxw, clt.train_bwd_plain(gates, cs, dys, w)) <= 1e-2


@pytest.mark.cuda
def test_train_function_grads_match_plain_autograd(cuda):
    """f32: the autograd.Function (K2, K3, dW) against torch.autograd
    through K1's plain twin, relative 1e-5 as above."""
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    xw, w, dys = _train_inputs(cuda, 24, 2, 10, 64, "float32", 1)
    grads = []
    for fn in (clt.bilstm_recurrence_trainable,
               cuda_lstm.bilstm_recurrence_plain):
        a, b = xw.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(a, b) * dys).sum().backward()
        grads.append((a.grad, b.grad))
    torch.cuda.synchronize()
    for g, r in zip(*grads):
        assert _rel_err(g, r) <= 1e-5


@pytest.mark.cuda
def test_train_kernels_reject_what_they_cannot_run(cuda):
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    xw, w, dys = _train_inputs(cuda, 4, 2, 3, 40, "float32", 0)
    with pytest.raises(ValueError, match="multiple of 16"):
        clt.train_fwd_cuda(xw, w)
    with pytest.raises(ValueError, match="multiple of 16"):
        clt.train_bwd_cuda(xw, dys, dys, w)
    xw, w, dys = _train_inputs(cuda, 4, 2, 3, 32, "float32", 0)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        clt.train_fwd_cuda(xw, w.bfloat16())
    with pytest.raises(ValueError, match="CUDA tensors"):
        clt.train_bwd_cuda(xw, dys, dys.cpu(), w)


def _block_inputs(cuda, B, H, W, C, dtype, seed):
    """x and folded weights with nonzero biases (relu(b1) != 0 at the
    image's top and bottom rows is what the zero halo must undo)."""
    rng = np.random.default_rng(seed)
    Wd = C // 4
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)  # noqa
    x = f(rng.normal(0, 1, (B, H, W, C))).to(getattr(torch, dtype))
    return (x, f(rng.normal(0, 1, (C, Wd)) / np.sqrt(C)),
            f(rng.normal(0, 1, Wd)),
            f(rng.normal(0, 1, (3, 3, Wd, Wd)) / np.sqrt(9 * Wd)),
            f(rng.normal(0, 1, Wd)), f(rng.normal(0, 1, (Wd, C)) / np.sqrt(Wd)),
            f(rng.normal(0, 1, C)))


# K4. f32: the same f32 sums in another order, relative 2e-5 (the JAX
# package's fused-block bar). bf16: m and m2 round to bf16 at the same
# points, but a sum in another order can flip a rounding: 3e-2 relative,
# the JAX package's bf16 bar. The shapes are tests/test_pallas_block.py's
# plus the edges of the bf16 tile plans: ragged tiles (H, W not multiples
# of the tile), W narrower than the tile (8 < 16), grids that are not a
# multiple of the cluster (W=40 at width 256: 3 tiles of 16 in clusters of
# 2; W=24 at width 512: 3 tiles of 8 in clusters of 4), and each resnet50
# width (64-512) at a small batch.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("B,H,W,C", [(2, 16, 32, 64), (1, 64, 32, 64),
                                     (2, 32, 16, 256), (1, 16, 8, 2048),
                                     (1, 13, 10, 64), (2, 9, 21, 128),
                                     (2, 16, 8, 256), (1, 17, 23, 256),
                                     (2, 11, 30, 512), (1, 9, 40, 1024),
                                     (1, 7, 24, 2048), (2, 12, 32, 1024),
                                     (2, 8, 16, 2048), (1, 20, 48, 768)])
def test_fused_bottleneck_kernel_matches_twin(cuda, dtype, tol, B, H, W, C):
    from horizonnet_tpu_torch.ops import fused_block

    args = _block_inputs(cuda, B, H, W, C, dtype, C + H)
    before = fused_block.launches
    got = fused_block.fused_bottleneck(*args)
    torch.cuda.synchronize()
    assert fused_block.launches == before + 1
    want = fused_block.fused_bottleneck_plain(*args)
    assert got.dtype == want.dtype and got.shape == (B, H, W, C)
    assert _rel_err(got, want) <= tol


@pytest.mark.cuda
def test_fused_bottleneck_kernel_rejects_what_it_cannot_run(cuda):
    from horizonnet_tpu_torch.ops import fused_block

    x, w1, b1, w2, b2, w3, b3 = _block_inputs(cuda, 1, 8, 8, 96, "float32", 0)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_block.fused_bottleneck_cuda(x, w1, b1, w2, b2, w3, b3)
    x, w1, b1, w2, b2, w3, b3 = _block_inputs(cuda, 1, 8, 8, 64, "float32", 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_block.fused_bottleneck_cuda(x.half(), w1, b1, w2, b2, w3, b3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_block.fused_bottleneck_cuda(x, w1.cpu(), b1, w2, b2, w3, b3)
    # bf16 widths over 512 have no tile plan: the wrapper raises instead of
    # falling back to another kernel or the twin
    args = _block_inputs(cuda, 1, 4, 4, 4 * 576, "bfloat16", 0)
    before = fused_block.launches
    with pytest.raises(ValueError, match="no bf16 tile plan for width 576"):
        fused_block.fused_bottleneck_cuda(*args)
    assert fused_block.launches == before


@pytest.mark.cuda
def test_bilstm_back_to_back_on_one_stream(cuda):
    """Two recurrences queued on one stream without a sync between them:
    the second's counters and scratch start afresh."""
    rng = np.random.default_rng(2)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        cuda, torch.bfloat16)
    a = [f(rng.normal(0, 1, (16, 2, 8, 4 * 128))) for _ in range(2)]
    w = [f(rng.uniform(-1, 1, (2, 128, 4 * 128)) / np.sqrt(128))
         for _ in range(2)]
    got = [cuda_lstm.bilstm_recurrence_cuda(x, v) for x, v in zip(a, w)]
    torch.cuda.synchronize()
    for g, x, v in zip(got, a, w):
        want = cuda_lstm.bilstm_recurrence_plain(x, v)
        assert (g.float() - want.float()).abs().max().item() <= 1e-2


# (B, H, W, C, O, kernel, stride, pad, groups): the stem, stage 1's 3x3,
# a strided 1x1, ResNeXt's grouped 3x3 (4 outputs a group) and 8 pixels
# (rows padded to more than 16): the shapes _int_mm takes only padded
@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,k,s,p,groups", [
    (2, 64, 128, 3, 64, 7, 2, 3, 1), (2, 32, 64, 64, 64, 3, 1, 1, 1),
    (2, 32, 64, 64, 128, 1, 2, 0, 1), (2, 8, 16, 128, 128, 3, 1, 1, 32),
    (1, 2, 4, 16, 8, 3, 1, 1, 1)])
def test_int8_conv_on_card_equals_cpu(cuda, B, H, W, C, O, k, s, p, groups):
    """cuBLASLt's int8 GEMM through ops/int8_conv.py: the int32 sums equal
    the CPU's bit for bit (integer sums are exact in any order)."""
    from horizonnet_tpu_torch.ops.int8_conv import int8_conv_nhwc

    g = torch.Generator().manual_seed(B + C + O)
    xq = torch.randint(-127, 128, (B, H, W, C), generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (O, C // groups, k, k), generator=g,
                       dtype=torch.int8)
    want = int8_conv_nhwc(xq, wq, (s, s), (p, p), groups)
    got = int8_conv_nhwc(xq.to(cuda), wq.to(cuda), (s, s), (p, p), groups)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrap_conv_seam_fix_on_card(cuda, dtype):
    """WrapConv(seam_fix=True) on the card equals the materialized pad's
    output bit for bit, at stage 1's 3x3 and the stem's 7x7/2."""
    from horizonnet_tpu_torch.models.layers import WrapConv

    g = torch.Generator().manual_seed(0)
    for cin, cout, k, s, p, H, W in ((64, 64, 3, 1, 1, 32, 64),
                                     (3, 64, 7, 2, 3, 64, 128)):
        x = torch.randn(2, cin, H, W, generator=g).to(
            cuda, getattr(torch, dtype)).contiguous(
                memory_format=torch.channels_last)
        convs = [WrapConv(cin, cout, k, s, (p, p), seam_fix=f).to(
            cuda, getattr(torch, dtype)) for f in (False, True)]
        convs[1].load_state_dict(convs[0].state_dict())
        with torch.no_grad():
            assert torch.equal(convs[1](x), convs[0](x))


def _yaw_tilt(yaw, tilt):
    a, b = np.radians(yaw), np.radians(tilt)
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]) @ np.array([[1, 0, 0],
                                             [0, np.cos(b), -np.sin(b)],
                                             [0, np.sin(b), np.cos(b)]])


@pytest.mark.cuda
def test_preprocess_device_warps_on_card_match_host(cuda):
    """The preprocess's device backend on the card (the 26 view cuts and
    the alignment rotation) against the host backend, at the JAX package's
    bars between its two backends: grays 0.15 (f16 download), RGB views
    0.2, float rotation mean 0.05, uint8 rotation under 1 % of pixels."""
    from horizonnet_tpu_torch.preprocess import rotate, views

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (128, 256, 3), np.uint8)
    dev = dict(backend="device", device=cuda)
    g = views.cut_views_gray(img, size=64, **dev)
    gh = views.cut_views_gray(img, size=64, backend="host")
    assert g.dtype == np.float16 and g.shape == gh.shape == (26, 64, 64)
    assert np.abs(g.astype(np.float32) - gh).max() < 0.15
    f = img.astype(np.float64)
    assert np.abs(views.cut_views(f, size=64, **dev)
                  - views.cut_views(f, size=64, backend="host")).max() < 0.2
    R = _yaw_tilt(33.0, 16.5)
    fr = rotate.rotate_panorama(img.astype(np.float32), R=R, **dev)
    assert np.abs(fr - rotate.rotate_panorama(
        img.astype(np.float32), R=R, backend="host")).mean() < 0.05
    u = rotate.rotate_panorama_uint8(img, R=R, **dev)
    uh = rotate.rotate_panorama_uint8(img, R=R, backend="host")
    assert u.dtype == np.uint8 and (u != uh).mean() < 0.01


@pytest.mark.cuda
def test_preprocess_device_warps_ignore_tf32(cuda):
    """The rotation's per-pixel Rinv product and the luma are broadcast
    products and sums, so TF32 matmuls cannot touch them: the same output
    with allow_tf32 off and on."""
    from horizonnet_tpu_torch.preprocess import rotate, views

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (128, 256, 3), np.uint8)
    R = _yaw_tilt(-35.0, 5.0)
    prev = torch.backends.cuda.matmul.allow_tf32
    outs = []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            outs.append((rotate.rotate_panorama(
                img.astype(np.float32), R=R, backend="device", device=cuda),
                views.cut_views_gray(img, size=64, backend="device",
                                     device=cuda)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for off, on in zip(*outs):
        np.testing.assert_array_equal(off, on)


def _trace_events(trace_dir):
    import glob
    import json

    (path,) = glob.glob(f"{trace_dir}/*.pt.trace.json")
    with open(path) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.cuda
@pytest.mark.parametrize("extra,spans", [
    (["--force_cuboid"], {"serve/ingest", "serve/forward+postproc"}),
    (["--device_postproc"], {"serve/ingest", "serve/general_finish"}),
])
def test_profile_dir_on_card(cuda, tmp_path, extra, spans):
    """--profile_dir on the card: the JAX CLI's serve/* spans (the general
    tail's from serve_stream's worker threads) and the K1 kernel's events
    (recurrence_bf16/f32). The profiler can lose kernel records, so a trace
    without K1 is taken again, up to 3 times; the spans are required in
    every one."""
    import os

    from horizonnet_tpu_torch.cli.inference import main

    fixdir = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
    k1 = 0
    for i in range(3):
        trace = tmp_path / f"trace{i}"
        assert main(["--pth", os.path.join(fixdir, "resnet18_rnn_synth.ckpt"),
                     "--img_glob", os.path.join(fixdir, "val_room.png"),
                     "--output_dir", str(tmp_path / "out"), "--profile_dir",
                     str(trace), "--device", "cuda", *extra]) == 0
        events = _trace_events(trace)
        assert spans <= {e.get("name") for e in events}
        k1 = sum(e.get("cat") == "kernel"
                 and "recurrence_" in e.get("name", "") for e in events)
        if k1:
            break
    assert k1 > 0


@pytest.mark.cuda
def test_dataset_vis_on_card_with_augmentation(cuda, tmp_path):
    """dataset_vis --device cuda with every augmentation: the warp runs on
    the card and the strip is written at its shape."""
    import os

    from horizonnet_tpu_torch.cli import dataset_vis
    from horizonnet_tpu_torch.data.synth import synth_room
    from horizonnet_tpu_torch.utils.image import read_png, write_png

    root = tmp_path / "rooms"
    os.makedirs(root / "img")
    os.makedirs(root / "label_cor")
    img, cor = synth_room(np.random.default_rng(0), 512, 1024)
    write_png(str(root / "img" / "room0.png"), img)
    np.savetxt(root / "label_cor" / "room0.txt", cor, fmt="%.4f")
    assert dataset_vis.main(["--root_dir", str(root), "--out_dir",
                             str(tmp_path / "vis"), "--flip", "--rotate",
                             "--gamma", "--stretch", "--device", "cuda"]) == 0
    out = read_png(str(tmp_path / "vis" / "room0.png"))
    assert out.shape == (33 + 512, 1024, 3) and out.dtype == np.uint8
    assert out.std() > 0


# The engines' captured programs (horizonnet_tpu_torch/program.py): a CUDA
# graph replays the eager program's kernels on the same inputs, so the
# outputs are equal bit for bit; a replay counts its kernels' launches.
def _small_serving(graph, fused_blocks="", seed=0, device="cuda"):
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.models import build_model

    model = build_model("resnet50", True, device=device, seed=seed,
                        dtype=torch.bfloat16, fused_blocks=fused_blocks)
    return InferenceEngine(model, model.state_dict(), batch_size=2, W=256,
                           postproc="cuboid", input_format="uint8",
                           device=device, graph=graph)


def _uint8_batches(n, B=2, W=256, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, 512, W, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("fused_blocks,per_batch", [("", (2, 0)),
                                                    ("kernel", (2, 12))])
def test_graphed_serving_equals_eager(cuda, fused_blocks, per_batch):
    """resnet50_rnn bf16 cuboid serving at 512x256, B=2: the captured
    program equals the eager one bit for bit on three batches, and a replay
    counts K1's (and, fused, K4's) launches as the eager call does."""
    from horizonnet_tpu_torch.ops import fused_block

    eager = _small_serving(False, fused_blocks)
    graphed = _small_serving(True, fused_blocks)
    assert eager.program is None and graphed.program is not None
    for x in _uint8_batches(3):
        n0 = (cuda_lstm.launches, fused_block.launches)
        want = eager(x)
        torch.cuda.synchronize()
        n1 = (cuda_lstm.launches, fused_block.launches)
        got = graphed(x)
        torch.cuda.synchronize()
        n2 = (cuda_lstm.launches, fused_block.launches)
        assert torch.equal(got, want)
        assert tuple(b - a for a, b in zip(n0, n1)) == per_batch
        assert tuple(b - a for a, b in zip(n1, n2)) == per_batch


@pytest.mark.cuda
def test_graphed_serving_times_its_device_stages(cuda):
    """While tracing is on, each replay of the captured serving program
    records its stages' device times (decode, encoder, head, fit) as
    ``device.<stage>`` spans with its batch's number; they add up to the
    replay's device time; the outputs are those of an untraced replay, and
    off, no stage is recorded and the graph's nodes hold their own events
    again."""
    import time

    from horizonnet_tpu_torch.inference import serve_stream
    from horizonnet_tpu_torch.utils import profiling

    eng = _small_serving(True)
    prog = eng.program
    assert prog.stages == ["decode", "encoder", "head", "fit"]
    xs = _uint8_batches(6, seed=2)
    want = [eng(x) for x in xs]
    t0 = time.perf_counter_ns()
    with profiling.enable():
        got = list(serve_stream(eng, iter(xs), depth=3, finish=lambda o: o))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    spans = profiling.spans(t0)
    for stage in prog.stages:
        mine = [s for s in spans if s.name == "device." + stage]
        assert sorted(s.req for s in mine) == list(range(6)), stage
        assert all(s.end > s.start for s in mine), stage
    assert sorted(s.req for s in spans
                  if s.name == "serve.wait_written") == list(range(6))
    assert prog._pointed
    # the stages against the replay's device time, on one replay
    with profiling.enable():
        t1 = time.perf_counter_ns()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        prog.replay()
        b.record()
        torch.cuda.synchronize()
    total = a.elapsed_time(b)
    stages = sum((s.end - s.start) / 1e6 for s in profiling.spans(t1)
                 if s.name.startswith("device."))
    assert 0.8 * total <= stages <= total
    t2 = time.perf_counter_ns()
    assert torch.equal(eng(xs[0]), want[0])
    torch.cuda.synchronize()
    assert not prog._pointed
    assert not [s for s in profiling.spans(t2)
                if s.name.startswith("device.")]


@pytest.mark.cuda
def test_put_does_not_wait_for_the_device(cuda):
    """With the card busy for ~200 ms, put returns in a few ms (pinned
    staging and a copy stream), and the batch it uploads is served right."""
    import time

    from horizonnet_tpu_torch.inference import serve_stream

    eng = _small_serving(True)
    xs = _uint8_batches(6, seed=1)
    want = [eng(x) for x in xs]
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)          # ~0.2 s of the card's clock
    t0 = time.perf_counter()
    up = eng.put(xs[0])
    put_s = time.perf_counter() - t0
    got = eng.run(up)
    done = torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert put_s < 0.02 and not done        # neither call waited
    assert torch.equal(got, want[0])
    # serve_stream at depth 3 over six batches: each its own result
    for g, w in zip(serve_stream(eng, iter(xs), depth=3), want):
        assert torch.equal(g, w)


_AUG_FLAGS = dict(flip=True, rotate=True, gamma=True, stretch=True)


def _aug_rooms(n, seed):
    """``n`` synthetic 512x1024 rooms: uint8 images [n, 512, 1024, 3] and
    their corner lists."""
    from horizonnet_tpu_torch.data.synth import synth_room

    rng = np.random.default_rng(seed)
    rooms = [synth_room(rng, 512, 1024) for _ in range(n)]
    return np.stack([r[0] for r in rooms]), [r[1] for r in rooms]


def _plain_augment(imgs, ps, wire, device):
    """augment_images on a plain ``.to(device)`` upload of the pixels (or
    of their packed wire, decoded) and on parameter vectors made by
    torch.tensor from the draws ``ps``."""
    from horizonnet_tpu_torch.data.augment import augment_images
    from horizonnet_tpu_torch.ops import dct

    def vec(k, dtype):
        return torch.tensor([p[k] for p in ps], dtype=dtype, device=device)

    if wire == "uint8":
        rgb = torch.from_numpy(imgs).to(device)
    else:
        rgb = dct.unpack_dct4_to_rgb(
            torch.from_numpy(dct.pack_dct4(imgs)).to(device), 512, 1024)
    return augment_images(rgb, vec("kx", torch.float32),
                          vec("ky", torch.float32), vec("flip", torch.bool),
                          vec("dx", torch.int64), vec("p", torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["uint8", "dct4"])
def test_augment_batch_does_not_wait_for_the_device(cuda, wire):
    """With the card busy for ~0.5 s, augment_batch returns while the card
    is still busy (pinned staging, the copies and the warp on its copy
    stream), the uint8 wire in under 20 ms (the dct4 wire packs on the
    host first), and counts the batch. Its output read on the default
    stream equals the warp of a plain upload bit for bit, also where the
    next call's warp runs before that read (record_stream keeps the
    output's memory from it) and where the warp is held back on the copy
    stream (the default stream waits for it)."""
    import time

    from horizonnet_tpu_torch.data import augment

    imgs, cors = _aug_rooms(2, seed=0)

    def call(seed):
        return augment.augment_batch(
            imgs, cors, np.random.default_rng(seed), 512, 1024, wire=wire,
            device="cuda", **_AUG_FLAGS)

    call(0)                                 # the stream, pinned blocks
    torch.cuda.synchronize()
    n0 = augment.stream_uploads
    torch.cuda._sleep(1_000_000_000)        # ~0.5 s of the card's clock
    t0 = time.perf_counter()
    x, _, ps = call(1)
    call_s = time.perf_counter() - t0
    got = x.clone()
    del x
    x, _, ps2 = call(2)
    got2 = x.clone()
    done = torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert not done                         # neither call waited
    assert call_s < 0.02 or wire != "uint8"
    assert augment.stream_uploads == n0 + 2
    assert torch.equal(got, _plain_augment(imgs, ps, wire, cuda))
    assert torch.equal(got2, _plain_augment(imgs, ps2, wire, cuda))
    with torch.cuda.stream(augment._card(cuda).stream):
        torch.cuda._sleep(400_000_000)
    x, _, ps = call(3)
    got = x.clone()
    torch.cuda.synchronize()
    assert torch.equal(got, _plain_augment(imgs, ps, wire, cuda))


@pytest.mark.cuda
def test_augment_batch_runs_ahead_of_its_caller_only_so_far(cuda):
    """With the caller's stream held busy, RUN_AHEAD calls return at once;
    the next waits on the host, in the span augment.runahead_wait, until
    the caller's stream has reached the oldest batch's hand-over."""
    import time

    from horizonnet_tpu_torch.data import augment
    from horizonnet_tpu_torch.utils import profiling

    imgs, cors = _aug_rooms(2, seed=0)

    def call(seed):
        return augment.augment_batch(
            imgs, cors, np.random.default_rng(seed), 512, 1024,
            device="cuda", **_AUG_FLAGS)

    call(0)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)        # ~0.5 s of the card's clock
    slept = torch.cuda.Event()
    slept.record()
    t0 = time.perf_counter_ns()
    with profiling.enable():
        for s in range(augment.RUN_AHEAD):
            call(1 + s)
        assert not slept.query()
        call(9)
        assert slept.query()
    torch.cuda.synchronize()
    waits = [s for s in profiling.spans(t0)
             if s.name == "augment.runahead_wait"]
    assert len(waits) == 1 and waits[0].end - waits[0].start > 50_000_000


@pytest.mark.cuda
def test_augment_batch_threads_keep_their_own_batches(cuda):
    """Two threads augment their own rooms at once, round after round, the
    first rounds while the default stream is held busy: each output, read
    on the default stream, equals its single-threaded result bit for bit
    (no staging buffer, device block or hand-over is shared)."""
    import threading

    from horizonnet_tpu_torch.data import augment

    rounds = 4
    rooms = [_aug_rooms(2, seed=10 + t) for t in range(2)]

    def call(t, r):
        imgs, cors = rooms[t]
        return augment.augment_batch(
            imgs, cors, np.random.default_rng([t, r]), 512, 1024,
            device="cuda", **_AUG_FLAGS)[0]

    want = {(t, r): call(t, r).cpu() for t in range(2) for r in range(rounds)}
    got = {}
    barrier = threading.Barrier(2)

    def worker(t):
        barrier.wait(timeout=60)
        for r in range(rounds):
            got[t, r] = call(t, r).clone()

    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)        # ~0.5 s of the card's clock
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k].cpu(), w), k


@pytest.mark.cuda
def test_graphed_update_variables_equals_a_fresh_engine(cuda):
    """update_variables copies into the captured parameters: the next
    replay equals an engine built with the new weights."""
    from horizonnet_tpu_torch.models import build_model

    eng = _small_serving(True, seed=0)
    new_sd = build_model("resnet50", True, device="cuda", seed=1,
                         dtype=torch.bfloat16).state_dict()
    x = _uint8_batches(1, seed=2)[0]
    before = eng(x)
    eng.update_variables(new_sd)
    fresh = _small_serving(True, seed=1)
    got = eng(x)
    assert torch.equal(got, fresh(x))
    assert not torch.equal(got, before)


def _small_trainer(graph, device="cuda"):
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.train.engine import TrainEngine
    from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
    from horizonnet_tpu_torch.train.step import (create_train_state,
                                                 make_optimizer)

    model = build_model("resnet18", True, device=device, seed=0,
                        dtype=torch.bfloat16, lstm_impl="kernel_train",
                        param_dtype=torch.float32)
    state = create_train_state(model, make_optimizer(
        "Adam", warmup_poly_schedule(1e-3, 20, 1e-6, 2)))
    return TrainEngine(model, state, 2, 512, 256, device=device, graph=graph)


@pytest.mark.cuda
def test_graphed_train_steps_equal_eager(cuda):
    """Three captured steps against three eager ones from the same state,
    the third with a new generator (the train CLI makes one an epoch): the
    losses, the parameters, the running statistics and Adam's state are
    equal bit for bit (the step has no atomics: ops/resize.py), the
    generators advance alike, and a replay counts K2's and K3's launches
    (two each a step)."""
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    rng = np.random.default_rng(0)
    batch = (rng.uniform(0, 1, (2, 512, 256, 3)).astype(np.float32),
             rng.normal(0, 0.5, (2, 2, 256)).astype(np.float32),
             rng.uniform(0, 1, (2, 1, 256)).astype(np.float32))
    engs = {"eager": _small_trainer(False), "graphed": _small_trainer(True)}
    assert engs["graphed"].program is not None
    out, gens = {}, {}
    for name, eng in engs.items():
        gens[name] = [torch.Generator(device="cuda").manual_seed(s)
                      for s in (0, 0, 1)]
        n0 = (clt.fwd_launches, clt.bwd_launches)
        out[name] = [eng.step(*batch, g) for g in gens[name]]
        torch.cuda.synchronize()
        assert (clt.fwd_launches - n0[0], clt.bwd_launches - n0[1]) == (6, 6)
    for a, b in zip(gens["graphed"], gens["eager"]):
        assert torch.equal(a.get_state(), b.get_state())

    for mg, me in zip(out["graphed"], out["eager"]):
        for k in me:
            assert torch.equal(mg[k], me[k]), k
    g, e = engs["graphed"], engs["eager"]
    for (k, a), b in zip(g.model.state_dict().items(),
                         e.model.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(g.state.opt.state_tensors(), e.state.opt.state_tensors()):
        assert torch.equal(a, b)
    assert g.state.step == e.state.step == 3


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["serve", "train"])
def test_graphed_engine_captures_on_its_own_card(cuda, engine):
    """An engine given a card by index captures, and replays, on that card
    whichever card is current: with two cards or more the last one while
    cuda:0 is current, with one card cuda:0 by its index. Its replays
    equal its eager program and move the kernels' launch counts."""
    from horizonnet_tpu_torch.ops import cuda_lstm_train as clt

    n = torch.cuda.device_count()
    dev = f"cuda:{n - 1}"
    with torch.cuda.device(0):
        if engine == "serve":
            engs = {g: _small_serving(g, device=dev) for g in (False, True)}
            x = _uint8_batches(1, seed=3)[0]
            n0 = cuda_lstm.launches
            got = engs[True](x)
            torch.cuda.synchronize(dev)
            assert cuda_lstm.launches - n0 == 2
            assert got.device == torch.device(dev)
            assert torch.equal(got, engs[False](x))
        else:
            rng = np.random.default_rng(1)
            batch = (rng.uniform(0, 1, (2, 512, 256, 3)).astype(np.float32),
                     rng.normal(0, 0.5, (2, 2, 256)).astype(np.float32),
                     rng.uniform(0, 1, (2, 1, 256)).astype(np.float32))
            engs = {g: _small_trainer(g, device=dev) for g in (False, True)}
            n0 = clt.fwd_launches
            got = engs[True].step(
                *batch, torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize(dev)
            assert clt.fwd_launches - n0 == 2
            want = engs[False].step(
                *batch, torch.Generator(device=dev).manual_seed(0))
            for k in want:
                assert torch.equal(got[k], want[k]), k
            for a, b in zip(engs[True].model.parameters(),
                            engs[False].model.parameters()):
                assert torch.equal(a, b)
