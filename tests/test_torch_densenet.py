"""The port's densenet encoders, seam-free pooling and seam_fix conv
against the JAX package.

Random weights come from numpy (a seed), shaped by the JAX model's
``eval_shape``: lecun-normal kernels, batch norm parameters and
statistics away from identity (so every one of them matters), U(-k, k)
LSTM weights. They reach the port through variables_to_state_dict. The
same numpy input goes through both packages in float32 at (1, 512, 128,
3): the input height is the reference's 512, the width is cut.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from horizonnet_tpu.models import build_model as jax_build_model
from horizonnet_tpu.models.densenet import (
    densenet_feature_channels as jax_densenet_channels)
from horizonnet_tpu.models.layers import WrapConv as JaxWrapConv
from horizonnet_tpu.models.layers import avg_pool_2x2 as jax_avg_pool
from horizonnet_tpu.models.layers import max_pool_same_as_torch as jax_pool
from horizonnet_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from horizonnet_tpu.models.torch_convert import torch_state_to_variables
from horizonnet_tpu.train.step import (
    encoder_freeze_mask as jax_freeze_mask)
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.models.densenet import densenet_feature_channels
from horizonnet_tpu_torch.models.layers import (WrapConv, avg_pool_2x2,
                                                max_pool_same_as_torch)
from horizonnet_tpu_torch.models.registry import ENCODER_DENSENET
from horizonnet_tpu_torch.models.torch_convert import (
    _module_path, variables_to_state_dict)
from horizonnet_tpu_torch.train import checkpoint
from horizonnet_tpu_torch.train.step import encoder_freeze_mask

SHAPE = (1, 512, 128, 3)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def numpy_variables(model, seed, shape=SHAPE):
    """Variables of the JAX ``model`` from numpy at ``seed``."""
    shapes = jax.eval_shape(
        lambda k: model.init({"params": k}, jnp.zeros(shape), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [getattr(p, "key", "") for p in path]
        leaf = names[-1]
        if leaf == "mean":
            a = rng.normal(0, 0.1, s.shape)
        elif leaf == "var":
            a = rng.uniform(0.8, 1.2, s.shape)
        elif names[-2] == "bn" and leaf == "scale":
            a = rng.uniform(0.8, 1.2, s.shape)
        elif "bi_rnn" in names:             # hidden size 512
            a = rng.uniform(-1 / np.sqrt(512), 1 / np.sqrt(512), s.shape)
        elif leaf == "kernel":
            a = rng.normal(0, np.sqrt(1 / np.prod(s.shape[:-1])), s.shape)
        elif leaf == "bias":
            a = rng.normal(0, 0.05, s.shape)
        else:
            raise KeyError("/".join(names))
        return a.astype(s.dtype)

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(fill, shapes))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_densenet121_forward_matches_jax():
    """The whole model, f32: bon and cor within 2e-4 of JAX's (sums in
    another order through ~120 convs; measured 1.2e-7)."""
    jm = jax_build_model("densenet121", use_rnn=True)
    v = numpy_variables(jm, 0)
    x = np.random.default_rng(1).uniform(0, 1, SHAPE).astype(np.float32)
    bon_j, cor_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x)
    port = build_model("densenet121", True, device="cpu")
    port.load_state_dict(variables_to_state_dict(v))
    with torch.no_grad():
        bon, cor = port(nchw(x))
    np.testing.assert_allclose(bon.numpy(), np.asarray(bon_j), atol=2e-4)
    np.testing.assert_allclose(cor.numpy(), np.asarray(cor_j), atol=2e-4)


class _Recorder(dict):
    """A state_dict that records the keys a converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


@pytest.mark.parametrize("backbone", ENCODER_DENSENET)
def test_densenet_keys_and_channels_match_jax(backbone):
    """Without a JAX forward: the taps' channels equal JAX's, JAX's
    torch_convert reads every key of the port's state_dict (the
    reference's keys; num_batches_tracked aside), and its tree comes back
    through variables_to_state_dict to the same key set."""
    assert densenet_feature_channels(backbone) == \
        jax_densenet_channels(backbone)
    sd = build_model(backbone, True, device="cpu").state_dict()
    rec = _Recorder({k: v.numpy() for k, v in sd.items()})
    variables = torch_state_to_variables(rec, backbone, True)
    assert {k for k in sd if not k.endswith("num_batches_tracked")} \
        <= rec.read
    assert set(variables_to_state_dict(variables)) == set(sd)


def _reference_pth(path, model, infix):
    """The model's state_dict as the reference's self-describing .pth;
    without the infix the LR_PAD Sequential's ``.1`` is gone from the
    width-padded convs' keys."""
    sd = model.state_dict()
    if not infix:
        padded = {n for n, m in model.named_modules()
                  if isinstance(m, torch.nn.Conv2d) and n.endswith(".1")}
        sd = {(f"{k.rsplit('.', 2)[0]}.{k.rsplit('.', 1)[1]}"
               if k.rsplit(".", 1)[0] in padded else k): t
              for k, t in sd.items()}
        assert "feature_extractor.encoder.features.conv0.weight" in sd
    torch.save({"args": {}, "kwargs": {"backbone": "densenet121",
                                       "use_rnn": True},
                "state_dict": sd}, path)


@pytest.mark.parametrize("infix", [True, False])
def test_reference_densenet_pth_loads(tmp_path, infix):
    model = build_model("densenet121", True, device="cpu", seed=3)
    sd = model.state_dict()
    assert any(k.endswith("conv2.1.weight") for k in sd)
    path = str(tmp_path / "ref.pth")
    _reference_pth(path, model, infix)
    got, _ = checkpoint.load_trained_model(path, device="cpu")
    assert got.backbone == "densenet121"
    for k, t in got.state_dict().items():
        assert torch.equal(t, sd[k]), k


def test_jax_densenet_ckpt_loads(tmp_path):
    """A densenet121 .ckpt written by the JAX package loads into the port
    with every tensor equal; the port writes it back leaf for leaf."""
    from horizonnet_tpu.train.checkpoint import save_model as jax_save
    from horizonnet_tpu.train.checkpoint import _read

    v = numpy_variables(jax_build_model("densenet121", use_rnn=True), 6)
    path = str(tmp_path / "dense.ckpt")
    jax_save(path, v, "densenet121", True)
    model, sd = checkpoint.load_trained_model(path, device="cpu")
    assert model.backbone == "densenet121"
    want = variables_to_state_dict(v)
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k]), k
    out = str(tmp_path / "port.ckpt")
    checkpoint.save_model(out, sd, "densenet121", True)
    got = jax.tree_util.tree_leaves_with_path(_read(out)[1])
    ref = dict(jax.tree_util.tree_leaves_with_path(v))
    assert len(got) == len(ref)
    for path_, a in got:
        assert np.array_equal(a, ref[path_]), path_


def test_seam_pool_encoder_matches_jax():
    """resnet18 with the wrap-padded stem pool: the four taps within 2e-4
    of JAX's ResNetEncoder(seam_pool=True)."""
    jm = jax_build_model("resnet18", use_rnn=True, seam_pool=True)
    v = numpy_variables(jm, 2)
    x = (np.random.default_rng(3).uniform(0, 1, SHAPE).astype(np.float32)
         - MEAN) / STD
    enc = JaxResNetEncoder("resnet18", seam_pool=True)
    want = enc.apply({"params": v["params"]["encoder"],
                      "batch_stats": v["batch_stats"]["encoder"]}, x)
    port = build_model("resnet18", True, device="cpu", seam_pool=True)
    port.load_state_dict(variables_to_state_dict(v))
    with torch.no_grad():
        got = port.feature_extractor.encoder(
            nchw(x).contiguous(memory_format=torch.channels_last))
    for a, b in zip(got, want):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=2e-4)


@pytest.mark.parametrize("wrap", [False, True])
def test_max_pool_forward_and_gradient_equal_jax(wrap):
    """The stem pool (3x3, stride 2, pad 1) and its gradient, equal to
    JAX's bit for bit: a max selects, so nothing is summed in another
    order (continuous inputs, so no ties)."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 16, 24, 8)).astype(np.float32)
    dy = rng.normal(0, 1, (2, 8, 12, 8)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a: jax_pool(a, 3, 2, 1, wrap_width=wrap), x)
    (dx_j,) = vjp(dy)
    xt = nchw(x).requires_grad_(True)
    y = max_pool_same_as_torch(xt, 3, 2, 1, wrap_width=wrap)
    y.backward(nchw(dy))
    assert np.array_equal(nhwc(y), np.asarray(y_j))
    assert np.array_equal(nhwc(xt.grad), np.asarray(dx_j))


def test_seam_pool_is_roll_equivariant():
    """Rolling the input by the pool's stride rolls the wrap-padded
    pool's output by one column, exactly; the edge-padded pool is not."""
    x = torch.randn(1, 4, 8, 16, generator=torch.Generator().manual_seed(0))
    rolled = torch.roll(x, 2, dims=3)
    y = max_pool_same_as_torch(x, 3, 2, 1, wrap_width=True)
    y_r = max_pool_same_as_torch(rolled, 3, 2, 1, wrap_width=True)
    assert torch.equal(torch.roll(y, 1, dims=3), y_r)
    edge = max_pool_same_as_torch(x, 3, 2, 1)
    assert not torch.equal(torch.roll(edge, 1, dims=3),
                           max_pool_same_as_torch(rolled, 3, 2, 1))


# tests/test_model.py::test_wrap_conv_seam_fix_bit_exact's cases:
# (kernel width, width stride, width pad, width, groups, bias), including
# the stem's 7x7/2 and an odd width that takes the materialized pad
SEAM_CASES = [(3, 1, 1, 32, 1, False), (7, 2, 3, 64, 1, False),
              (3, 2, 1, 32, 1, False), (5, 1, 2, 40, 1, True),
              (3, 1, 1, 32, 4, False), (3, 1, 1, 30, 2, False)]


@pytest.mark.parametrize("kw,sw,pw,W,groups,bias", SEAM_CASES)
def test_wrap_conv_seam_fix_bit_exact(kw, sw, pw, W, groups, bias):
    """WrapConv(seam_fix=True) equals the materialized-pad default bit for
    bit on random floats (the same products, the same library), and JAX's
    seam_fix conv bit for bit on integer-valued inputs and weights, whose
    float32 sums are exact in any order, so equality tests the seam
    geometry; on random floats it is within 1e-5 of JAX's."""
    rng = np.random.default_rng(kw * 100 + W)
    kh = min(kw, 5)
    shape = (kh, kw, 8 // groups, 16)
    for integer in (False, True):
        if integer:
            x = rng.integers(-3, 4, (2, 8, W, 8)).astype(np.float32)
            k = rng.integers(-2, 3, shape).astype(np.float32)
            b = rng.integers(-2, 3, 16).astype(np.float32)
        else:
            x = rng.normal(0, 1, (2, 8, W, 8)).astype(np.float32)
            k = rng.normal(0, 0.3, shape).astype(np.float32)
            b = rng.normal(0, 0.3, 16).astype(np.float32)
        conv = {"kernel": k, **({"bias": b} if bias else {})}
        want = np.asarray(JaxWrapConv(
            16, (kh, kw), (1, sw), (0, pw), use_bias=bias, groups=groups,
            seam_fix=True).apply({"params": {"conv": conv}}, x))
        outs = []
        for seam_fix in (False, True):
            m = WrapConv(8, 16, (kh, kw), (1, sw), (0, pw), bias, groups,
                         seam_fix=seam_fix)
            with torch.no_grad():
                m[1].weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
                if bias:
                    m[1].bias.copy_(torch.from_numpy(b))
                outs.append(nhwc(m(nchw(x).contiguous(
                    memory_format=torch.channels_last))))
        assert np.array_equal(outs[1], outs[0]), (kw, sw, pw, W)
        if integer:
            assert np.array_equal(outs[1], want), (kw, sw, pw, W)
        else:
            np.testing.assert_allclose(outs[1], want, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 32, 8), (3, 128, 256, 64),
                                   (1, 64, 16, 512)])
def test_avg_pool_2x2_equals_jax(shape):
    """Bit for bit: the sum is taken in JAX's order."""
    x = np.random.default_rng(5).normal(0, 1, shape).astype(np.float32)
    got = avg_pool_2x2(nchw(x).contiguous(memory_format=torch.channels_last))
    assert np.array_equal(nhwc(got), np.asarray(jax_avg_pool(x)))


@pytest.mark.parametrize("n_frozen", [-1, 0, 1, 2, 3, 4])
def test_freeze_mask_on_densenet_equals_jax(n_frozen):
    """--freeze_earlier_blocks on densenet121: the port's mask over its
    parameter names equals JAX's block map over the same tree."""
    model = build_model("densenet121", True, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    mask = encoder_freeze_mask(names, n_frozen)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = torch_state_to_variables(sd, "densenet121", True)["params"]
    want = jax_freeze_mask(params, n_frozen)["encoder"]
    enc = [n for n in names if n.startswith("feature_extractor.encoder.")]
    for n in enc:
        block = _module_path(n.split(".")[:-1])[0][1]
        assert set(jax.tree.leaves(want[block])) == {mask[n]}, n
    assert all(mask[n] for n in names if n not in enc)
    if n_frozen < 0:
        assert all(mask[n] for n in enc)
    if n_frozen == 4:       # norm5 is block 4: the whole encoder
        assert not any(mask[n] for n in enc)
