"""The port's training engine, checkpoints and CLI on the CPU.

A port-written .ckpt loads in the JAX package (load_trained_model and
load_checkpoint, Adam's moments included); a resumed engine reproduces an
unbroken run; the CLI trains from a PNG dataset and writes its epoch
checkpoints; and a training step imports no jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from horizonnet_tpu_torch.data import synth
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.models.torch_convert import state_dict_to_variables
from horizonnet_tpu_torch.train import checkpoint
from horizonnet_tpu_torch.train.engine import TrainEngine
from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
from horizonnet_tpu_torch.train.step import create_train_state, make_optimizer
from horizonnet_tpu_torch.utils.image import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 2, 512, 64


def _engine(seed=0, **opt):
    model = build_model("resnet18", True, device="cpu", seed=seed,
                        lstm_impl="kernel_train", param_dtype=torch.float32)
    tx = make_optimizer("Adam", warmup_poly_schedule(1e-3, 100), **opt)
    state = create_train_state(model, tx)
    return TrainEngine(model, state, B, H, W, device="cpu")


def _batch(step):
    rng = np.random.default_rng(1000 + step)
    return (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
            rng.normal(0, 0.5, (B, 2, W)).astype(np.float32),
            rng.uniform(0, 1, (B, 1, W)).astype(np.float32))


def _run(engine, steps):
    for s in steps:
        m = engine.step(*_batch(s), torch.Generator().manual_seed(s))
        assert all(np.isfinite(v.item()) for v in m.values())


@pytest.fixture(scope="module")
def trained():
    """An engine after two steps, and its host state."""
    eng = _engine()
    _run(eng, [0, 1])
    return eng, eng.host_state()


def test_msgpack_writer_round_trips_through_flax():
    from flax import serialization

    rng = np.random.default_rng(0)
    tree = {"a": {"k": rng.normal(size=(3, 4)).astype(np.float32),
                  "i": np.asarray(7, np.int32)},
            "b": {}, "c": [1, -3, 300, -70000, 2 ** 40, 0.5, "s" * 40,
                           None, True, b"\x00\x01"],
            "d": {str(i): np.zeros(i, np.float32) for i in range(20)}}
    blob = checkpoint.msgpack_serialize(tree)
    assert blob == serialization.msgpack_serialize(tree)
    back = serialization.msgpack_restore(blob)
    np.testing.assert_array_equal(back["a"]["k"], tree["a"]["k"])
    assert checkpoint.msgpack_restore(blob)["c"] == tree["c"]


def test_save_model_loads_in_jax(trained, tmp_path):
    from horizonnet_tpu.train.checkpoint import load_trained_model

    eng, host = trained
    path = str(tmp_path / "m.ckpt")
    checkpoint.save_model(path, host["state_dict"], "resnet18", True)
    model_j, v = load_trained_model(path)
    assert (model_j.backbone, model_j.use_rnn) == ("resnet18", True)
    want = state_dict_to_variables(host["state_dict"])
    for name in ("params", "batch_stats"):
        got = dict(jax.tree_util.tree_leaves_with_path(v[name]))
        ref = jax.tree_util.tree_leaves_with_path(want[name])
        assert len(got) == len(ref)
        for p, a in ref:
            np.testing.assert_array_equal(got[p], a)
    # and back into the port, bit for bit
    model, _ = checkpoint.load_trained_model(path, device="cpu")
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(t, host["state_dict"][k], rtol=0,
                                       atol=0)


def test_save_checkpoint_restores_in_jax(trained, tmp_path):
    from horizonnet_tpu.models.registry import build_model as jax_build
    from horizonnet_tpu.train import create_train_state as jax_state
    from horizonnet_tpu.train.checkpoint import load_checkpoint
    from horizonnet_tpu.train.schedule import warmup_poly_schedule as jsched
    from horizonnet_tpu.train.step import make_optimizer as jax_opt

    eng, host = trained
    path = checkpoint.save_checkpoint(str(tmp_path), host, "resnet18", True,
                                      3, 0.25, True)
    assert os.path.isfile(tmp_path / "best_model_3.ckpt")
    model_j = jax_build("resnet18", True)
    shapes = jax.eval_shape(lambda: model_j.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), train=False))
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    state = jax_state(model_j, zeros, jax_opt("Adam", jsched(1e-3, 100)))
    new, header = load_checkpoint(path, state)
    assert header["epoch"] == 3 and header["best_valid_score"] == 0.25
    assert int(new.step) == 2
    adam = new.opt_state[0]
    assert int(adam.count) == 2 and int(new.opt_state[1].count) == 2
    sd = host["state_dict"]
    for key, moments in (("mu", adam.mu), ("nu", adam.nu)):
        want = state_dict_to_variables({**{k: torch.zeros_like(t) for k, t
                                           in sd.items()},
                                        **host["moments"][key]})["params"]
        got = dict(jax.tree_util.tree_leaves_with_path(moments))
        for p, a in jax.tree_util.tree_leaves_with_path(want):
            np.testing.assert_array_equal(np.asarray(got[p]), a)
        assert max(float(np.abs(a).max()) for a in jax.tree.leaves(want)) > 0
    want_p = dict(jax.tree_util.tree_leaves_with_path(
        state_dict_to_variables(sd)["params"]))
    for p, a in jax.tree_util.tree_leaves_with_path(new.params):
        np.testing.assert_array_equal(np.asarray(a), want_p[p])


@pytest.mark.parametrize("opt", [{}, {"weight_decay": 1e-3}])
def test_resume_reproduces_an_unbroken_run(tmp_path, opt):
    """2 steps, save_checkpoint, a fresh engine that load_checkpoints the
    file and takes 1 more: the weights, statistics and moments of 3
    unbroken steps (CPU kernels are deterministic: exact)."""
    eng = _engine(**opt)
    _run(eng, [0, 1])
    path = checkpoint.save_checkpoint(str(tmp_path), eng.host_state(),
                                      "resnet18", True, 1, 0.0, False)
    fresh = _engine(seed=5, **opt)
    checkpoint.load_checkpoint(path, fresh.state)
    assert fresh.state.step == 2
    _run(fresh, [2])
    _run(eng, [2])
    a, b = eng.host_state(), fresh.host_state()
    assert a["step"] == b["step"] == 3
    for k, t in a["state_dict"].items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(b["state_dict"][k], t, rtol=0, atol=0)
    for k, m in a["moments"].items():
        for n, t in m.items():
            torch.testing.assert_close(b["moments"][k][n], t, rtol=0, atol=0)


def test_engine_refuses_what_it_cannot_run():
    eng = _engine()
    with pytest.raises(ValueError, match="shape"):
        eng.step(np.zeros((B, H, W + 4, 3), np.float32),
                 *_batch(0)[1:], torch.Generator())
    with pytest.raises(NotImplementedError, match="item 9"):
        TrainEngine(eng.model, eng.state, B, H, W, device="cpu",
                    mesh=object())
    with pytest.raises(ValueError, match="Generator"):
        eng.step(*_batch(0), None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TrainEngine(eng.model, eng.state, B, H, W, device="cuda")


def _png_dataset(root, n, width):
    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "label_cor"))
    for i in range(n):
        img, cor = synth.synth_room(np.random.default_rng(i), 512, width)
        write_png(os.path.join(root, "img", f"room{i}.png"), img)
        np.savetxt(os.path.join(root, "label_cor", f"room{i}.txt"), cor,
                   fmt="%.4f")


def test_cli_trains_and_writes_epoch_checkpoints(tmp_path):
    """resnet18 on 2 synthetic 512x128 panos, 2 epochs of one step,
    --save_every 1: both epoch checkpoints load back and differ."""
    from horizonnet_tpu_torch.cli.train import main

    _png_dataset(str(tmp_path / "train"), 2, 128)
    rc = main(["--id", "t", "--ckpt", str(tmp_path / "ckpt"), "--logs",
               str(tmp_path / "logs"), "--train_root_dir",
               str(tmp_path / "train"), "--valid_root_dir", "",
               "--backbone", "resnet18", "--batch_size_train", "2",
               "--epochs", "2", "--save_every", "1", "--lstm_impl",
               "pallas_train", "--device", "cpu"])
    assert rc == 0
    sds = []
    for e in (1, 2):
        model, sd = checkpoint.load_trained_model(
            str(tmp_path / "ckpt" / "t" / f"epoch_{e}.ckpt"), device="cpu")
        assert model.backbone == "resnet18"
        sds.append(sd)
    moved = [k for k in sds[0] if not torch.equal(sds[0][k], sds[1][k])]
    assert "bi_rnn.bias_ih_l0" in moved and len(moved) > 50


@pytest.mark.parametrize("extra,match", [
    (["--valid_root_dir", "some/valid"], "items 6 and 11"),
    (["--valid_root_dir", "", "--seam_pool"], "item 7"),
    (["--valid_root_dir", "", "--n_model", "2"], "item 9"),
    (["--valid_root_dir", "", "--backbone", "densenet121"], "item 7"),
])
def test_cli_refuses_paths_still_to_port(tmp_path, extra, match):
    from horizonnet_tpu_torch.cli.train import main

    _png_dataset(str(tmp_path / "train"), 1, 128)
    with pytest.raises(NotImplementedError, match=match):
        main(["--id", "t", "--ckpt", str(tmp_path / "ckpt"),
              "--train_root_dir", str(tmp_path / "train"), "--device", "cpu",
              *extra])


def test_training_step_never_imports_jax():
    """Every module of the port and a CPU TrainEngine step in a fresh
    process: neither jax, flax nor the JAX package gets imported."""
    code = """
import pkgutil, sys, importlib
import horizonnet_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import numpy as np, torch
from horizonnet_tpu_torch.data.augment import augment_batch
from horizonnet_tpu_torch.data.synth import synth_batch
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.train.engine import TrainEngine
from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
from horizonnet_tpu_torch.train.step import create_train_state, make_optimizer
rng = np.random.default_rng(0)
imgs, _, _, cors = synth_batch(rng, 1, 512, 64)
x, _, _ = augment_batch(imgs, cors, rng, 512, 64, device="cpu")
m = build_model("resnet18", True, device="cpu", lstm_impl="kernel_train",
                param_dtype=torch.float32)
st = create_train_state(m, make_optimizer("Adam", warmup_poly_schedule(1e-4, 10)))
eng = TrainEngine(m, st, 1, 512, 64, device="cpu")
out = eng.step(x, np.zeros((1, 2, 64), np.float32),
               np.zeros((1, 1, 64), np.float32), torch.Generator())
assert np.isfinite(out["total"].item())
bad = sorted(k for k in sys.modules if k.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "horizonnet_tpu"))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BAD []" in proc.stdout, proc.stdout
