"""The port's int8 serving against the JAX package: the fold
(models/quant.py), QuantConvBN and its int8 product (ops/int8_conv.py),
the resnet18 quant model, and the golden's corners under int8.

Random float weights come from numpy, shaped by the JAX model
(test_torch_densenet.numpy_variables). Integer sums are exact, so the
int32 accumulators are held to JAX's bit for bit.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

from horizonnet_tpu.models import build_model as jax_build_model
from horizonnet_tpu.models.layers import QuantConvBN as JaxQuantConvBN
from horizonnet_tpu.models.quant import quantize_variables
from horizonnet_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from horizonnet_tpu.ops.pad import wrap_pad_width as jax_pad
from horizonnet_tpu_torch.inference import InferenceEngine, inference
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.models.layers import QuantConvBN
from horizonnet_tpu_torch.models.quant import ENCODER, quantize_state_dict
from horizonnet_tpu_torch.models.torch_convert import (
    _module_path, variables_to_state_dict)
from horizonnet_tpu_torch.ops.int8_conv import int8_conv_nhwc
from horizonnet_tpu_torch.train.checkpoint import load_trained_model
from horizonnet_tpu_torch.utils.image import read_png
from test_torch_densenet import MEAN, SHAPE, STD, nchw, nhwc, numpy_variables

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden")
CKPT = os.path.join(FIXDIR, "resnet18_rnn_synth.ckpt")


@pytest.fixture(scope="module")
def resnet18_variables():
    return numpy_variables(jax_build_model("resnet18", use_rnn=True), 7)


def test_quantize_state_dict_equals_jax(resnet18_variables):
    """weight_q equals JAX's kernel_q (OIHW against HWIO), scale and bias
    equal JAX's in f32 bit for bit (the same float64 fold); the encoder's
    batch norms drop out, every other entry passes through, and the keys
    are the quant model's."""
    v = resnet18_variables
    sd = variables_to_state_dict(v)
    sdq = quantize_state_dict(sd)
    vq = quantize_variables(v)
    assert "encoder" not in vq["batch_stats"]
    model = build_model("resnet18", True, device="cpu", quant_int8=True)
    assert set(sdq) == set(model.state_dict())
    n_conv = 0
    for key, t in sdq.items():
        if not key.startswith(ENCODER):
            assert torch.equal(t, sd[key]), key
            continue
        module, leaf = key.rsplit(".", 1)
        node = vq["params"]
        for name in _module_path(module.split("."))[0]:
            node = node[name]
        if leaf == "weight_q":
            n_conv += 1
            assert t.dtype == torch.int8
            assert np.array_equal(t.numpy(), np.asarray(
                node["kernel_q"]).transpose(3, 2, 0, 1)), key
        else:
            assert t.dtype == torch.float32
            assert np.array_equal(t.numpy(), np.asarray(node[leaf])), key
    assert n_conv == 20       # stem, 8 blocks x 2, 3 downsamples


# (B, H, W, C, O, kernel, stride, pad, groups): the stem (depth 147 padded
# to 152), stage 1's 3x3, the 1x1s, a strided 3x3, ResNeXt's grouped 3x3
# (4 outputs a group, padded to 8) and a map of 8 pixels (rows padded to
# more than 16)
CONV_CASES = [(1, 32, 64, 3, 64, 7, 2, 3, 1), (2, 16, 32, 64, 64, 3, 1, 1, 1),
              (2, 16, 32, 64, 256, 1, 1, 0, 1),
              (2, 16, 32, 64, 128, 1, 2, 0, 1),
              (2, 16, 32, 32, 64, 3, 2, 1, 1),
              (2, 8, 16, 128, 128, 3, 1, 1, 32),
              (1, 2, 4, 16, 8, 3, 1, 1, 1)]


@pytest.mark.parametrize("B,H,W,C,O,k,s,p,groups", CONV_CASES)
def test_quant_conv_bn_equals_jax(B, H, W, C, O, k, s, p, groups):
    """The int32 accumulators equal JAX's int8 conv (XLA, preferred
    element type int32) bit for bit on the same int8 input; the layer's
    output from a float input within 1e-6 of JAX's, relative to its
    largest entry (the same f32 dequantization; measured equal)."""
    rng = np.random.default_rng(B * 1000 + C + O + k)
    kq = rng.integers(-127, 128, (k, k, C // groups, O)).astype(np.int8)
    xq = rng.integers(-127, 128, (B, H, W, C)).astype(np.int8)
    want = lax.conv_general_dilated(
        jax_pad(jnp.asarray(xq), p, axis=2), jnp.asarray(kq), (s, s),
        ((p, p), (0, 0)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    got = int8_conv_nhwc(torch.from_numpy(xq),
                         torch.from_numpy(kq.transpose(3, 2, 0, 1).copy()),
                         (s, s), (p, p), groups)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))

    scale = rng.uniform(1e-3, 1e-2, O).astype(np.float32)
    bias = rng.normal(0, 0.2, O).astype(np.float32)
    x = rng.normal(0, 1.5, (B, H, W, C)).astype(np.float32)
    y_j = np.asarray(JaxQuantConvBN(O, (k, k), (s, s), (p, p), groups).apply(
        {"params": {"kernel_q": kq, "scale": scale, "bias": bias}}, x))
    layer = QuantConvBN(C, O, k, s, (p, p), groups)
    layer.weight_q.copy_(torch.from_numpy(kq.transpose(3, 2, 0, 1).copy()))
    layer.scale.copy_(torch.from_numpy(scale))
    layer.bias.copy_(torch.from_numpy(bias))
    with torch.no_grad():
        y = nhwc(layer(nchw(x).contiguous(memory_format=torch.channels_last)))
    assert np.abs(y - y_j).max() <= 1e-6 * np.abs(y_j).max()


def test_quant_model_matches_jax(resnet18_variables):
    """resnet18_rnn quant_int8, f32, on the same folded tree: bon and cor
    within 2e-4 of JAX's quant model (the float bar; measured 2.4e-7).
    The int8 encoder's four taps equal JAX's on at least 99.9 % of
    entries (measured: all): one activation that rounds the other way
    where a float sum straddles a .5 changes one int8 value."""
    v = resnet18_variables
    vq = quantize_variables(v)
    jm = jax_build_model("resnet18", use_rnn=True, quant_int8=True)
    x = np.random.default_rng(8).uniform(0, 1, SHAPE).astype(np.float32)
    bon_j, cor_j = jax.jit(lambda v, x: jm.apply(v, x, train=False))(vq, x)
    port = build_model("resnet18", True, device="cpu", quant_int8=True)
    port.load_state_dict(quantize_state_dict(variables_to_state_dict(v)))
    with torch.no_grad():
        bon, cor = port(nchw(x))
        taps = port.feature_extractor.encoder(
            nchw((x - MEAN) / STD).contiguous(
                memory_format=torch.channels_last))
    np.testing.assert_allclose(bon.numpy(), np.asarray(bon_j), atol=2e-4)
    np.testing.assert_allclose(cor.numpy(), np.asarray(cor_j), atol=2e-4)
    want = JaxResNetEncoder("resnet18", quant=True).apply(
        {"params": vq["params"]["encoder"]}, (x - MEAN) / STD)
    for a, b in zip(taps, want):
        assert np.mean(nhwc(a) == np.asarray(b)) >= 0.999


def test_quant_golden_corners_close_to_float():
    """JAX's bar (tests/test_quant.py): the golden's int8 cuboid corners
    within 4 px of the float ones, z1 within 5 % + 1 of float's, through
    the host path."""
    model, sd = load_trained_model(CKPT, device="cpu")
    img = read_png(os.path.join(FIXDIR, "val_room.png"))[None, ..., :3]
    x = img.astype(np.float32) / 255.0
    (cor_f, _, z1_f, _), = inference(model, sd, x, force_cuboid=True)
    qmodel = build_model("resnet18", True, device="cpu", quant_int8=True)
    sdq = quantize_state_dict(sd)
    qmodel.load_state_dict(sdq)
    (cor_q, _, z1_q, _), = inference(qmodel, sdq, x, force_cuboid=True)
    dpx = np.abs(cor_q - cor_f).max() * 512
    assert dpx < 4.0, f"int8 corners drifted {dpx:.2f}px from float"
    assert abs(z1_q - z1_f) < 0.05 * abs(z1_f) + 1.0, (z1_q, z1_f)


def test_engine_keeps_quant_buffer_dtypes(resnet18_variables):
    """A bf16 quant model in the engine: the int8 kernels stay int8 and the
    scales and biases f32 through load_state_dict; the forward is finite."""
    sdq = quantize_state_dict(variables_to_state_dict(resnet18_variables))
    model = build_model("resnet18", True, device="cpu", dtype=torch.bfloat16,
                        quant_int8=True)
    eng = InferenceEngine(model, sdq, W=128, device="cpu")
    stem = model.feature_extractor.encoder.conv1
    assert stem.weight_q.dtype == torch.int8
    assert stem.scale.dtype == stem.bias.dtype == torch.float32
    assert torch.equal(stem.weight_q,
                       sdq[f"{ENCODER}conv1.weight_q"])
    assert model.linear.weight.dtype == torch.bfloat16
    bon, cor = eng(np.random.default_rng(9).uniform(0, 1, SHAPE).astype(
        np.float32))
    assert bon.shape == (1, 2, 128) and bool(torch.isfinite(bon).all())


@pytest.mark.parametrize("kw,err", [
    (dict(backbone="resnet18", quant_int8=True, s2d_stem=True), ValueError),
    (dict(backbone="densenet121", quant_int8=True), NotImplementedError),
])
def test_build_model_refuses_like_jax(kw, err):
    with pytest.raises(err):
        jax_build_model(**kw).init(jax.random.PRNGKey(0),
                                   jnp.zeros((1, 64, 64, 3)))
    with pytest.raises(err):
        build_model(device="cpu", **kw)
