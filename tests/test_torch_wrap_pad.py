"""The wrap pad's autograd.Function (ops/pad.py) on the CPU: its forward
and its fold equal torch.cat and cat's autograd bit for bit where W >= 2 p,
in a whole train-mode encoder too, and the plain fold down to W = p; what
K5 refuses raises; the launch counters stay 0.
K5 itself runs on the card only (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.models import layers
from horizonnet_tpu_torch.models.height import GlobalHeightStage
from horizonnet_tpu_torch.models.resnet import (ResNetEncoder,
                                                resnet_feature_channels)
from horizonnet_tpu_torch.ops import pad as wp


def _bits(t):
    t = t.detach().contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _cat_pad(x, p):
    """Yesterday's pad: torch.cat of two narrowed views, differentiated by
    autograd."""
    W = x.shape[3]
    return torch.cat([x.narrow(3, W - p, p), x, x.narrow(3, 0, p)], dim=3)


def _inputs(dtype, channels_last, W, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(2, 6, 5, W)).astype(
        np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(2, 6, 5, W + 6)).astype(
        np.float32))
    g[g.abs() < 0.2] = -0.0          # signed zeros: autograd's adds give +0
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x, g


@pytest.mark.parametrize("W", [3, 8, 33, 64])
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_equals_cat_and_its_autograd(dtype, channels_last, p, W):
    x, g = _inputs(dtype, channels_last, W, seed=W * 10 + p)
    g = g[..., :W + 2 * p].to(dtype)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = wp.wrap_pad_width(a, p, dim=3), _cat_pad(b, p)
    got.backward(g)
    want.backward(g)
    assert got.grad_fn.name() == "WrapPadFunctionBackward"
    assert torch.equal(_bits(got), _bits(want))
    assert a.grad.dtype == dtype
    assert torch.equal(_bits(a.grad), _bits(wp.wrap_fold_plain(g, p)))
    if W >= 2 * p:
        assert torch.equal(_bits(a.grad), _bits(b.grad))
    else:
        # a column takes three terms: the fold rounds once, autograd twice
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(a.grad, b.grad, rtol=tol, atol=tol)
    assert wp.fwd_launches == 0 and wp.bwd_launches == 0


@pytest.mark.parametrize("W,p", [(1, 1), (2, 1), (1, 3), (2, 3), (5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_sums_every_copy_of_a_narrow_width(dtype, W, p):
    """Down to W = p the pad wraps once: the fold gives each column its
    own gradient and every pad copy of it (an exact sum of small
    integers), and a pad wider than the width is refused."""
    dpad = torch.arange(1, W + 2 * p + 1, dtype=torch.float32).repeat(
        2, 3, 4, 1).to(dtype)
    if p > W:
        for fn in (wp.wrap_pad_cuda, wp.wrap_fold_cuda):
            with pytest.raises(ValueError, match="0 < pad <= W"):
                fn(dpad[..., :W], p)
        return
    want = torch.zeros(W)
    for j in range(W + 2 * p):
        want[(j - p) % W] += j + 1
    assert torch.equal(wp.wrap_fold_plain(dpad, p),
                       want.to(dtype).expand(2, 3, 4, W))
    x = torch.arange(W, dtype=dtype).repeat(1, 2, 3, 1)
    assert torch.equal(wp.wrap_pad_width(x, p)[0, 0, 0],
                       torch.tensor([(j - p) % W for j in range(W + 2 * p)],
                                    dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_and_height_stage_grads_equal_the_cat_path(monkeypatch,
                                                           dtype):
    """A train-mode resnet50 encoder and height stage at 64x128 on float32
    parameters: the same loss, and gradients equal bit for bit, with the
    Function as with cat's autograd. (In resnet18 they are not: a
    BasicBlock's shortcut adds its gradient to the input's between the
    pad's three parts, where the fold hands autograd their sum, so the sums
    round in another order.)"""
    def run(pad_fn):
        monkeypatch.setattr(layers, "wrap_pad_width", pad_fn)
        torch.manual_seed(0)
        enc = ResNetEncoder("resnet50").train()
        stage = GlobalHeightStage(resnet_feature_channels("resnet50")).train()
        x = torch.from_numpy(np.random.default_rng(3).uniform(
            0, 1, (2, 3, 64, 128)).astype(np.float32)).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        out = stage(enc(x), 32)
        loss = (out.float() ** 2).mean()
        loss.backward()
        grads = [p.grad for m in (enc, stage) for p in m.parameters()]
        return loss, grads

    loss_f, grads_f = run(wp.wrap_pad_width)
    loss_c, grads_c = run(lambda x, pad, dim=-1: _cat_pad(x, pad))
    assert torch.equal(_bits(loss_f), _bits(loss_c))
    assert len(grads_f) == len(grads_c) > 0
    for gf, gc in zip(grads_f, grads_c):
        assert torch.equal(_bits(gf), _bits(gc))
    assert wp.fwd_launches == 0 and wp.bwd_launches == 0


def test_meta_tensors_take_the_plain_path():
    """utils/flops.py counts a train step's FLOPs on the meta device: the
    Function pads and folds there as on the CPU."""
    x = torch.empty(2, 8, 4, 16, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    y = wp.wrap_pad_width(x, 3)
    assert y.shape == (2, 8, 4, 22) and y.device.type == "meta"
    y.backward(torch.empty_like(y))
    assert x.grad.shape == x.shape and x.grad.device.type == "meta"
    assert wp.fwd_launches == 0 and wp.bwd_launches == 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
def test_other_dtypes_raise(dtype):
    x = torch.zeros(1, 2, 3, 8, dtype=dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wp.wrap_pad_width(x, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wp.wrap_pad_cuda(x, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        wp.wrap_fold_cuda(torch.zeros(1, 2, 3, 10, dtype=dtype), 1)


def test_only_the_width_of_a_4d_tensor_pads():
    with pytest.raises(ValueError, match="dim 3"):
        wp.wrap_pad_width(torch.zeros(2, 3, 8), 1)
    with pytest.raises(ValueError, match="dim 3"):
        wp.wrap_pad_width(torch.zeros(1, 2, 3, 8), 1, dim=2)
    x = torch.zeros(1, 2, 3, 8)
    assert wp.wrap_pad_width(x, 0) is x


def test_layouts_k5_refuses_raise():
    """Neither dense NCHW nor dense channels_last: the wrappers refuse it
    before any launch."""
    x = torch.zeros(1, 4, 3, 16, dtype=torch.bfloat16)[:, ::2]
    with pytest.raises(ValueError, match="neither dense"):
        wp.wrap_pad_cuda(x, 1)
    with pytest.raises(ValueError, match="neither dense"):
        wp.wrap_fold_cuda(torch.zeros(1, 4, 3, 18)[:, ::2], 1)
