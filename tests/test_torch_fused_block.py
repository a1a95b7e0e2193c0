"""The port's fused identity bottleneck (K4's plain twin, ops/fused_block.py)
and the fused model against the JAX package, on the CPU.

Batch-norm affine parameters and running statistics are randomized
everywhere: a fresh batch norm is the identity and would hide a wrong fold.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from horizonnet_tpu.ops.pallas_block import fold_conv_bn as jax_fold
from horizonnet_tpu.ops.pallas_block import fused_bottleneck as jax_fused
from horizonnet_tpu_torch.models.resnet import Bottleneck
from horizonnet_tpu_torch.ops import fused_block
from horizonnet_tpu_torch.ops.fused_block import (fold_conv_bn,
                                                  fused_bottleneck,
                                                  fused_bottleneck_plain)


def _block_args(B, H, W, C, seed):
    """x and folded weights (numpy), with biases far from zero so that
    relu(b1) at the image's top and bottom rows would show."""
    rng = np.random.default_rng(seed)
    Wd = C // 4
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f(rng.normal(size=(B, H, W, C))),
            f(rng.normal(size=(C, Wd)) / np.sqrt(C)), f(rng.normal(size=Wd)),
            f(rng.normal(size=(3, 3, Wd, Wd)) / np.sqrt(9 * Wd)),
            f(rng.normal(size=Wd)), f(rng.normal(size=(Wd, C)) / np.sqrt(Wd)),
            f(rng.normal(size=C)))


def _jax_block(x, w1, b1, w2, b2, w3, b3, dtype=jnp.float32):
    return np.asarray(jax_fused(
        jnp.asarray(x, dtype), jnp.asarray(w1)[None, None], jnp.asarray(b1),
        jnp.asarray(w2), jnp.asarray(b2), jnp.asarray(w3)[None, None],
        jnp.asarray(b3), interpret=True).astype(jnp.float32))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# f32: the same f32 products, summed in another order: 2e-5 relative (the
# JAX package's fused-block bar). The shapes are tests/test_pallas_block.py's.
@pytest.mark.parametrize("B,H,W,C", [
    (2, 16, 32, 64),     # one JAX tile: both halos are zero rows
    (1, 64, 32, 64),     # 4 JAX tiles: halos cross tile boundaries
    (2, 32, 16, 256),    # stage-1 channel count
    (1, 16, 8, 2048),    # stage-4 channel count
])
def test_twin_matches_jax_interpret_f32(B, H, W, C):
    args = _block_args(B, H, W, C, C + H)
    want = _jax_block(*args)
    got = fused_bottleneck(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == (B, H, W, C)
    assert _rel(got.numpy(), want) < 2e-5


def test_twin_matches_jax_interpret_bf16():
    """bf16 x and weights, rounded at the same three points on both sides:
    3e-2 relative, the JAX package's bf16 bar."""
    args = _block_args(2, 32, 32, 64, 0)
    want = _jax_block(*args, dtype=jnp.bfloat16)
    t = [torch.from_numpy(a) for a in args]
    got = fused_bottleneck(t[0].bfloat16(), *t[1:])
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) < 3e-2


def test_fold_conv_bn_matches_jax():
    rng = np.random.default_rng(4)
    k = rng.normal(size=(3, 3, 16, 32)).astype(np.float32)
    gamma, beta, mean = (rng.normal(size=32).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.3, 2.0, 32).astype(np.float32)
    want = jax_fold(*(jnp.asarray(a) for a in (k, gamma, beta, mean, var)))
    got = fold_conv_bn(*(torch.from_numpy(a)
                         for a in (k, gamma, beta, mean, var)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_plain_twin_rejects_broken_shapes():
    x, w1, b1, w2, b2, w3, b3 = (torch.from_numpy(a)
                                 for a in _block_args(1, 4, 4, 64, 0))
    with pytest.raises(ValueError, match="contract"):
        fused_bottleneck(x, w1, b1, w2[:, :, :8], b2, w3, b3)
    with pytest.raises(ValueError, match="contract"):
        fused_bottleneck(x, w1, b1, w2, b2, w3[:, :32], b3)


def _randomize_bn(block, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in (block.bn1, block.bn2, block.bn3):
            n = bn.num_features
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
            bn.bias.copy_(torch.from_numpy(rng.normal(size=n)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(size=n)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.3, 2.0, n)))


def _block_pair(C, seed):
    torch.manual_seed(seed)
    ref = Bottleneck(C, C // 4).eval()
    fus = Bottleneck(C, C // 4, fused="kernel").eval()
    _randomize_bn(ref, seed)
    fus.load_state_dict(ref.state_dict())
    return (ref.to(memory_format=torch.channels_last),
            fus.to(memory_format=torch.channels_last))


@pytest.mark.parametrize("B,H,W,C", [(2, 16, 32, 64), (1, 16, 8, 256)])
def test_fused_block_matches_unfused(B, H, W, C):
    """The port's Bottleneck fused and unfused on one state_dict, f32:
    2e-5 relative, as JAX holds its own fused block."""
    ref, fus = _block_pair(C, C)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, C, H, W)).astype(np.float32)).contiguous(
            memory_format=torch.channels_last)
    before = fused_block.launches
    with torch.no_grad():
        want, got = ref(x), fus(x)
    assert fused_block.launches == before        # the CPU runs the twin
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got.numpy(), want.numpy()) < 2e-5


def test_state_dict_keys_identical_fused_or_not():
    ref, fus = _block_pair(256, 0)
    assert list(ref.state_dict()) == list(fus.state_dict())
    from horizonnet_tpu_torch.models import build_model
    a = build_model("resnet50", True, device="cpu", seed=5)
    b = build_model("resnet50", True, device="cpu", seed=5,
                    fused_blocks="kernel")
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_train_mode_takes_the_unfused_path():
    """Fused blocks serve only: in train mode the block runs unfused on
    batch statistics and updates its running statistics."""
    _, fus = _block_pair(64, 2)
    fus.train()
    x = torch.randn(2, 64, 8, 16).contiguous(
        memory_format=torch.channels_last)
    mean0 = fus.bn1.running_mean.clone()
    y = fus(x)
    assert y.shape == x.shape and y.requires_grad
    assert not torch.equal(fus.bn1.running_mean, mean0)
    assert int(fus.bn1.num_batches_tracked) == 1


def test_fused_only_where_jax_fuses():
    """Stride 2, a downsample or groups > 1 keep the unfused forward; an
    unknown mode is refused, and so is a backbone without bottlenecks."""
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.models.resnet import ResNetEncoder

    enc = ResNetEncoder("resnext50_32x4d", fused_blocks="kernel")
    assert all(b.fused == "kernel" for b in enc.layer1)
    assert enc.layer1[1].groups == 32      # resnext: never fused
    enc50 = ResNetEncoder("resnet50", fused_blocks="kernel")
    fusable = [f"layer{li}_{bi}" for li in range(1, 5)
               for bi, b in enumerate(getattr(enc50, f"layer{li}"))
               if b.stride == 1 and b.downsample is None and b.groups == 1]
    assert fusable == ["layer1_1", "layer1_2", "layer2_1", "layer2_2",
                       "layer2_3", "layer3_1", "layer3_2", "layer3_3",
                       "layer3_4", "layer3_5", "layer4_1", "layer4_2"]
    with pytest.raises(ValueError, match="fused block mode"):
        Bottleneck(64, 16, fused="pallas")
    with pytest.raises(ValueError, match="bottleneck family"):
        build_model("densenet121", True, device="cpu", fused_blocks="kernel")


def test_fused_resnet50_rnn_matches_jax_fused():
    """The whole fused resnet50_rnn against JAX's build_model(...,
    fused_blocks="pallas_interpret") on the same weights with randomized
    batch-norm statistics, f32 at (1, 512, 64): 2e-4, the bar of JAX's
    test_fused_full_model_forward."""
    from horizonnet_tpu.models import build_model as jax_build
    from horizonnet_tpu.models.registry import init_model
    from horizonnet_tpu_torch.models import build_model
    from horizonnet_tpu_torch.models.torch_convert import (
        variables_to_state_dict)

    shape = (1, 512, 64, 3)
    jm = jax_build("resnet50", use_rnn=True, fused_blocks="pallas_interpret")
    v = jax.tree.map(np.asarray, init_model(jm, jax.random.PRNGKey(0), shape))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "mean":
            return rng.normal(0, 0.1, a.shape).astype(a.dtype)
        if names[-1] == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if len(names) > 1 and names[-2] == "bn":
            if names[-1] == "scale":
                return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
            return rng.normal(0, 0.1, a.shape).astype(a.dtype)
        return a

    v = jax.tree_util.tree_map_with_path(perturb, v)
    x = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    bon_j, cor_j = jm.apply(v, jnp.asarray(x), train=False)

    model = build_model("resnet50", True, device="cpu",
                        fused_blocks="kernel")
    model.load_state_dict(variables_to_state_dict(v))
    with torch.no_grad():
        bon, cor = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(bon.numpy(), np.asarray(bon_j), atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(cor.numpy(), np.asarray(cor_j),
                               atol=2e-4, rtol=1e-3)
