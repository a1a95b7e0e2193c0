"""Weights into the port: variables_to_state_dict, the jax-free .ckpt
reader and its msgpack decoder, and the numpy PNG reader."""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import serialization

from horizonnet_tpu.models import build_model as jax_build_model
from horizonnet_tpu.models.torch_convert import torch_state_to_variables
from horizonnet_tpu.train.checkpoint import _read, load_trained_model \
    as jax_load_trained_model
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.models.torch_convert import variables_to_state_dict
from horizonnet_tpu_torch.train import checkpoint
from horizonnet_tpu_torch.utils.image import read_png
from tests.torch_replica import TorchHorizonNetReplica

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "golden")
CKPT = os.path.join(FIXDIR, "resnet18_rnn_synth.ckpt")


def random_variables(backbone, use_rnn, seed=0):
    """The JAX model's variable tree (shapes from eval_shape, no compute)
    filled with distinct random values."""
    model = jax_build_model(backbone, use_rnn=use_rnn)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 512, 64, 3)), train=False))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


CASES = [("resnet18", True), ("resnet18", False), ("resnet34", True),
         ("resnet50", True), ("resnext50_32x4d", True),
         ("densenet121", True)]


@pytest.mark.parametrize("backbone,use_rnn", CASES)
def test_state_dict_keys_and_shapes_match_port_model(backbone, use_rnn):
    sd = variables_to_state_dict(random_variables(backbone, use_rnn))
    want = build_model(backbone, use_rnn, device="cpu").state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("use_rnn", [True, False])
def test_port_keys_match_reference_replica(use_rnn):
    """The reference's own key layout (tests/torch_replica.py), including
    the ``.1`` infix of width-padded convs."""
    want = TorchHorizonNetReplica("resnet50", use_rnn).state_dict()
    got = build_model("resnet50", use_rnn, device="cpu").state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("backbone,use_rnn", CASES)
def test_state_dict_is_exact_inverse_of_torch_convert(backbone, use_rnn):
    """Every leaf comes back bit-exact through the JAX package's
    converter, so none is dropped or misplaced."""
    v = random_variables(backbone, use_rnn, seed=1)
    sd = variables_to_state_dict(v)
    back = torch_state_to_variables({k: t.numpy() for k, t in sd.items()},
                                    backbone, use_rnn)
    leaves = jax.tree_util.tree_leaves_with_path(v)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(back_leaves)
    for path, a in leaves:
        np.testing.assert_array_equal(np.asarray(back_leaves[path]), a,
                                      err_msg=str(path))


def test_unknown_leaf_is_refused():
    v = random_variables("resnet18", True)
    v["params"]["bi_rnn"]["l0_extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="l0_extra"):
        variables_to_state_dict(v)
    v = random_variables("resnet18", True)
    v["params"]["unexpected"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="unexpected"):
        variables_to_state_dict(v)


def test_ckpt_reader_equals_flax():
    header, payload = checkpoint.read_checkpoint(CKPT)
    want_header, want_payload = _read(CKPT)
    assert header == want_header
    got = jax.tree_util.tree_leaves_with_path(payload)
    want = jax.tree_util.tree_leaves_with_path(want_payload)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_load_trained_model_equals_jax_loader():
    model, sd = checkpoint.load_trained_model(CKPT, device="cpu")
    jax_model, variables = jax_load_trained_model(CKPT)
    assert (model.backbone, model.use_rnn) == (jax_model.backbone,
                                               jax_model.use_rnn)
    want = variables_to_state_dict(variables)
    assert sorted(sd) == sorted(want)
    live = model.state_dict()
    for k, v in want.items():
        assert sd[k].dtype == v.dtype, k      # float16 storage upcast
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
        torch.testing.assert_close(live[k], v, rtol=0, atol=0)


def test_msgpack_decoder_matches_flax():
    rng = np.random.default_rng(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 40,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                 -2 ** 40],
        "floats": [0.5, -1e300, 3.25],
        "misc": [True, False, None, b"\x00\x01", "a" * 31, "b" * 32,
                 "c" * 300, "d" * 70000],
        "lists": [list(range(15)), list(range(16)), list(range(70000))],
        "maps": [{str(i): i for i in range(15)},
                 {str(i): i for i in range(16)},
                 {str(i): i for i in range(70000)}],
        "arrays": {"f16": rng.normal(size=(3, 4)).astype(np.float16),
                   "i8": rng.integers(-128, 128, (5,), dtype=np.int8),
                   "u8": rng.integers(0, 256, (2, 2, 2), dtype=np.uint8),
                   "empty": np.zeros((0, 3), np.float32),
                   "scalar": np.float32(2.5),
                   "bf16": np.asarray(jnp.asarray(rng.normal(size=(4,)),
                                                  jnp.bfloat16))},
    }
    blob = serialization.msgpack_serialize(tree)
    got = checkpoint.msgpack_restore(blob)
    want = serialization.msgpack_restore(blob)
    for name in ("ints", "floats", "misc", "lists", "maps"):
        assert got[name] == want[name], name
    for k, a in want["arrays"].items():
        g = got["arrays"][k]
        if k == "bf16":   # decoded exactly, widened to float32
            np.testing.assert_array_equal(g, np.asarray(a, np.float32))
        else:
            assert np.asarray(g).dtype == np.asarray(a).dtype, k
            np.testing.assert_array_equal(g, a)
    with pytest.raises(ValueError, match="trailing"):
        checkpoint.msgpack_restore(blob + b"\x00")


@pytest.mark.parametrize("name", ["val_room.png", "val_room_raw.png"])
def test_read_png_matches_pillow(name):
    from PIL import Image

    path = os.path.join(FIXDIR, name)
    np.testing.assert_array_equal(read_png(path), np.asarray(Image.open(path)))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_read_png_modes_match_pillow(mode, tmp_path):
    from PIL import Image

    ch = len(mode)
    rng = np.random.default_rng(ch)
    # smooth ramps plus noise, so the encoder picks a mix of row filters
    arr = np.cumsum(rng.integers(0, 9, (37, 41, ch)), axis=1).astype(np.uint8)
    img = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    path = str(tmp_path / "x.png")
    img.save(path)
    np.testing.assert_array_equal(read_png(path), arr)


def test_load_pano_resizes_other_sizes_like_the_jax_cli():
    """PNG at 1024x512 decodes without Pillow; other sizes are resized
    bicubically to the input contract, as horizonnet_tpu's CLI does."""
    from PIL import Image
    from horizonnet_tpu_torch.utils.image import load_pano

    path = os.path.join(FIXDIR, "val_room.png")
    np.testing.assert_array_equal(load_pano(path), read_png(path))
    raw = os.path.join(FIXDIR, "val_room_raw.png")       # 1024x545
    want = np.asarray(Image.open(raw).resize((1024, 512), Image.BICUBIC))
    np.testing.assert_array_equal(load_pano(raw), want[..., :3])
