"""The port's model (horizonnet_tpu_torch/models) against the JAX package.

Random JAX variables (flax init, with batch-norm parameters and statistics
perturbed so every one of them matters) go through
variables_to_state_dict into the port; the same numpy input goes through
both packages in float32. Input height is the reference's 512 (the
bi-LSTM's input width depends on it); widths are cut to 128.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from horizonnet_tpu.models import build_model as jax_build_model
from horizonnet_tpu.models.height import GlobalHeightStage as JaxHeight
from horizonnet_tpu.models.layers import WrapConv as JaxWrapConv
from horizonnet_tpu.models.layers import max_pool_same_as_torch as jax_pool
from horizonnet_tpu.models.registry import init_model
from horizonnet_tpu.models.resnet import ResNetEncoder as JaxEncoder
from horizonnet_tpu.models.resnet import resnet_feature_channels
from horizonnet_tpu.ops.pad import wrap_pad_width as jax_pad
from horizonnet_tpu.ops.resize import wrap_resize_width as jax_resize
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.models.layers import WrapConv, max_pool_same_as_torch
from horizonnet_tpu_torch.models.torch_convert import variables_to_state_dict
from horizonnet_tpu_torch.ops.pad import wrap_pad_width
from horizonnet_tpu_torch.ops.resize import wrap_resize_width

SHAPE = (1, 512, 128, 3)


def jax_variables(backbone, use_rnn, seed):
    """(JAX model, numpy variables) with non-identity batch norm."""
    model = jax_build_model(backbone, use_rnn=use_rnn)
    v = jax.tree.map(np.asarray, init_model(model, jax.random.PRNGKey(seed),
                                            SHAPE))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "mean":
            return rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if names[-1] == "var":
            return rng.uniform(0.8, 1.2, a.shape).astype(a.dtype)
        if len(names) > 1 and names[-2] == "bn":
            if names[-1] == "scale":
                return rng.uniform(0.8, 1.2, a.shape).astype(a.dtype)
            return rng.normal(0, 0.05, a.shape).astype(a.dtype)
        return a

    return model, jax.tree_util.tree_map_with_path(perturb, v)


def port_model(variables, backbone, use_rnn, dtype=torch.float32):
    m = build_model(backbone, use_rnn, device="cpu", dtype=dtype)
    m.load_state_dict(variables_to_state_dict(variables))
    return m


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def resnet18_rnn():
    model, v = jax_variables("resnet18", True, 0)
    return model, v, port_model(v, "resnet18", True)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(7).uniform(0, 1, SHAPE).astype(np.float32)


@pytest.mark.parametrize("w,out_w", [(32, 128), (64, 128), (128, 128)])
def test_wrap_pad_and_resize_match_jax(w, out_w):
    x = np.random.default_rng(w).normal(size=(2, 4, 3, w)).astype(np.float32)
    np.testing.assert_array_equal(
        wrap_pad_width(torch.from_numpy(x), 2, dim=-1).numpy(),
        np.asarray(jax_pad(jnp.asarray(x), 2, axis=-1)))
    # JAX folds pad + resize + trim into one f32 matmul: 1e-5
    np.testing.assert_allclose(
        wrap_resize_width(torch.from_numpy(x), out_w).numpy(),
        np.asarray(jax_resize(jnp.asarray(x), out_w, axis=-1)), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w,out_w", [(8, 64), (32, 256), (16, 256)])
def test_wrap_resize_matrix_equals_interpolate(dtype, w, out_w):
    """The port's resize multiplies by its interpolation matrix (its
    backward is then a product too, with no atomics on the card); it
    equals F.interpolate's pad + resize + trim: bit for bit in bfloat16
    (two exact products summed in float32, rounded once), to 1 ulp in
    float32 (the products round there)."""
    import torch.nn.functional as F

    x = torch.from_numpy(np.random.default_rng(w).normal(
        size=(2, 16, 3, w)).astype(np.float32)).to(dtype)
    f = out_w // w
    want = F.interpolate(wrap_pad_width(x, 1, dim=-1),
                         size=(3, out_w + 2 * f), mode="bilinear",
                         align_corners=False)[..., f:-f]
    got = wrap_resize_width(x, out_w)
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1.2e-7, atol=1e-7)


@pytest.mark.parametrize("k,stride,bias", [(3, (2, 1), True), (7, (2, 2), False),
                                           (3, (1, 1), False)])
def test_wrapconv_matches_jax(k, stride, bias):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 10, 12, 4)).astype(np.float32)
    kernel = rng.normal(0, 0.2, (k, k, 4, 5)).astype(np.float32)
    b = rng.normal(0, 0.2, 5).astype(np.float32)
    p = k // 2
    jconv = JaxWrapConv(5, (k, k), stride, (p, p), use_bias=bias)
    params = {"conv": {"kernel": kernel, **({"bias": b} if bias else {})}}
    want = jconv.apply({"params": params}, jnp.asarray(x))
    conv = WrapConv(4, 5, k, stride, (p, p), bias=bias)
    assert list(conv.state_dict()) == (["1.weight", "1.bias"] if bias
                                       else ["1.weight"])
    with torch.no_grad():
        conv[1].weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            conv[1].bias.copy_(torch.from_numpy(b))
        got = conv(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


def test_max_pool_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 9, 14, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(max_pool_same_as_torch(nchw(x))),
        np.asarray(jax_pool(jnp.asarray(x))))


def test_encoder_and_height_match_jax(resnet18_rnn, image):
    model, v, port = resnet18_rnn
    sub = lambda k: {"params": v["params"][k],          # noqa: E731
                     "batch_stats": v["batch_stats"][k]}
    x = (image - np.array([0.485, 0.456, 0.406], np.float32)) \
        / np.array([0.229, 0.224, 0.225], np.float32)
    feats_j = JaxEncoder("resnet18").apply(sub("encoder"), jnp.asarray(x))
    with torch.no_grad():
        feats_t = port.feature_extractor.encoder(nchw(x))
        # the height stage gets JAX's own feature maps, so it is held alone
        feats_in = [torch.from_numpy(np.ascontiguousarray(
            np.asarray(f).transpose(0, 3, 1, 2))) for f in feats_j]
        height_t = port.reduce_height_module(feats_in, 32)
    for fj, ft in zip(feats_j, feats_t):
        np.testing.assert_allclose(nhwc(ft), np.asarray(fj), rtol=1e-4,
                                   atol=1e-4)
    height_j = JaxHeight(resnet_feature_channels("resnet18")).apply(
        sub("height"), feats_j, 32)
    assert height_t.shape == height_j.shape
    np.testing.assert_allclose(height_t.numpy(), np.asarray(height_j),
                               rtol=1e-4, atol=1e-4)


def _forward_parity(model, v, port, image):
    bon_j, cor_j = model.apply(v, jnp.asarray(image), train=False)
    with torch.no_grad():
        bon_t, cor_t = port(nchw(image))
    assert bon_t.shape == bon_j.shape and cor_t.shape == cor_j.shape
    # the 2e-4 the torch replica holds in tests/test_full_parity.py
    np.testing.assert_allclose(bon_t.numpy(), np.asarray(bon_j), rtol=1e-3,
                               atol=2e-4)
    np.testing.assert_allclose(cor_t.numpy(), np.asarray(cor_j), rtol=1e-3,
                               atol=2e-4)


def test_full_forward_matches_jax_resnet18(resnet18_rnn, image):
    _forward_parity(*resnet18_rnn, image)


@pytest.mark.parametrize("backbone,use_rnn", [("resnet50", True),
                                              ("resnet18", False)])
def test_full_forward_matches_jax(backbone, use_rnn, image):
    model, v = jax_variables(backbone, use_rnn, 1)
    _forward_parity(model, v, port_model(v, backbone, use_rnn), image)


def test_bf16_forward_tracks_jax_bf16(resnet18_rnn, image):
    """bf16 rounds at other points in cuDNN/ATen and XLA, so the bound is
    loose; JAX runs its Pallas LSTM (interpret), whose f32 h/c carry is
    the port's kernel contract."""
    model, v, _ = resnet18_rnn
    jb = jax_build_model("resnet18", True, dtype=jnp.bfloat16,
                         lstm_impl="pallas_interpret")
    bon_j, cor_j = jb.apply(v, jnp.asarray(image), train=False)
    port = port_model(v, "resnet18", True, torch.bfloat16)
    with torch.no_grad():
        bon_t, cor_t = port(nchw(image))
    assert bon_t.dtype == torch.float32
    np.testing.assert_allclose(bon_t.numpy(), np.asarray(bon_j), atol=0.1)
    np.testing.assert_allclose(cor_t.numpy(), np.asarray(cor_j), atol=0.1)


def test_build_model_contract():
    m = build_model("resnet18", True, device="cpu", dtype=torch.bfloat16)
    assert m.dtype == torch.bfloat16 and not m.training
    assert m.feature_extractor.encoder.bn1.weight.dtype == torch.float32
    assert m.bi_rnn.weight_hh_l0.dtype == torch.float32
    assert m.linear.weight.dtype == torch.bfloat16
    np.testing.assert_allclose(m.linear.bias.detach().float().numpy(),
                               [-1] * 4 + [-0.478] * 4 + [0.425] * 4,
                               rtol=1e-2)
    same = build_model("resnet18", True, device="cpu", dtype=torch.bfloat16)
    other = build_model("resnet18", True, device="cpu", dtype=torch.bfloat16,
                        seed=1)
    w = "feature_extractor.encoder.layer1.0.conv1.1.weight"
    assert torch.equal(m.state_dict()[w], same.state_dict()[w])
    assert not torch.equal(m.state_dict()[w], other.state_dict()[w])
    with pytest.raises(ValueError, match="unknown backbone"):
        build_model("vgg16", device="cpu")
    dense = build_model("densenet121", True, device="cpu")
    assert dense.bi_rnn.weight_ih_l0.shape == (2048, 896)
    assert "feature_extractor.encoder.features.conv0.1.weight" in \
        dense.state_dict()
