"""The port's multi-process layout (horizonnet_tpu_torch/parallel) on the
CPU over gloo, against JAX's unsharded step.

Ranks are spawned processes joined through a file store in a new
temporary directory (parallel/dryrun.py::run_ranks), each run bounded by
a timeout. resnet18_rnn at 512x64 (the port's bi-LSTM needs height 512),
global batch 4, f32:
- tp_spec mirrors tests/test_parallel_tp.py::test_tp_spec_rules;
- one Adam step at layouts (2, 1), (1, 2) and (2, 2) against JAX's
  unsharded train step on the whole batch with the same dropout masks,
  and against the port's one-process step: losses, gathered gradients,
  global batch statistics and parameters; the conv stacks really shard;
- a tensor-parallel checkpoint loads in JAX;
- the train CLI on 2 ranks with --n_model 2, then --resume;
- data-parallel serving of the golden checkpoint, cuboid and general;
- dryrun_multichip(4) on the CPU;
and no rank imports jax.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from horizonnet_tpu.train.schedule import warmup_poly_schedule as jax_sched
from horizonnet_tpu.train.step import loss_terms as jax_loss_terms
from horizonnet_tpu.train.step import make_optimizer as jax_make_optimizer
from horizonnet_tpu_torch.models.torch_convert import (
    state_dict_to_variables, variables_to_state_dict)
from horizonnet_tpu_torch.parallel import tp_spec
from horizonnet_tpu_torch.parallel.dryrun import dryrun_multichip, run_ranks
from tests import torch_parallel_ranks as ranks
from tests.test_torch_train import jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "golden")
B, H, W = 4, 512, 64
LAYOUTS = [(2, 1), (1, 2), (2, 2)]
SCHED = (1e-4, 100)
TIMEOUT = 240


def test_tp_spec_rules():
    k4 = (128, 64, 3, 3)
    vec = (128,)
    conv = "feature_extractor.encoder.layer1.0.conv1.weight"
    bn = "reduce_height_module.ghc_lst.0.layer.0.layers.1.weight"
    assert tp_spec(conv, k4, 2) == 0
    assert tp_spec(bn, vec, 2) == 0
    for leaf in ("bias", "running_mean", "running_var"):
        assert tp_spec(bn[:-len("weight")] + leaf, vec, 2) == 0
    # head/LSTM replicate even when divisible (only the conv stacks shard)
    assert tp_spec("linear.bias", vec, 2) is None
    assert tp_spec("bi_rnn.weight_ih_l0", (2048, 128), 2) is None
    assert tp_spec(conv, k4, 1) is None               # n_model=1: pure dp
    assert tp_spec(conv, (3, 64, 3, 3), 2) is None    # indivisible
    assert tp_spec(bn[:-len("weight")] + "num_batches_tracked", (), 2) \
        is None


def _masks(seed):
    """The two dropout keep-masks [T, B, 2H] of the global batch, in draw
    order: between the LSTM layers, then after the LSTM."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(W // 4, B, 1024)) < 0.5 for _ in range(2)]


def _jax_step(v, batch, masks):
    """JAX's unsharded train step on the whole batch: losses, gradients,
    new batch statistics and the parameters after one Adam update."""
    model_j, _ = jax_variables("resnet18", True, 0)
    x, y_bon, y_cor = batch
    queue = list(masks)
    mp = pytest.MonkeyPatch()

    def bernoulli(key, p=None, shape=None):
        m = queue.pop(0)
        assert tuple(shape) == m.shape
        return jnp.asarray(m)

    mp.setattr(jax.random, "bernoulli", bernoulli)

    def loss_fn(params, stats):
        (bon, cor), new = model_j.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        b, c = jax_loss_terms(bon, cor, jnp.asarray(y_bon),
                              jnp.asarray(y_cor))
        return b + c, (b, c, new["batch_stats"])

    try:
        (total, (bon_l, cor_l, stats)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v["params"], v["batch_stats"])
    finally:
        mp.undo()
    tx = jax_make_optimizer("Adam", jax_sched(*SCHED))
    upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    return dict(losses=[float(total), float(bon_l), float(cor_l)],
                grads=grads, stats=stats,
                params=optax.apply_updates(v["params"], upd))


def _as_trees(out):
    """A port step's state dicts as the JAX package's trees."""
    sd = out["state"]["state_dict"]
    zeros = {k: torch.zeros_like(t) for k, t in sd.items()}
    return dict(losses=out["losses"],
                grads=state_dict_to_variables({**zeros, **out["grads"]})[
                    "params"],
                stats=state_dict_to_variables(sd)["batch_stats"],
                params=state_dict_to_variables(sd)["params"])


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's step, the port's one-process step and the port's step at each
    layout (4 spawned ranks), on the same weights, batch and masks."""
    tmp = tmp_path_factory.mktemp("layouts")
    _, v = jax_variables("resnet18", True, 0)
    rng = np.random.default_rng(2)
    batch = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             rng.normal(0, 0.5, (B, 2, W)).astype(np.float32),
             rng.uniform(0, 1, (B, 1, W)).astype(np.float32))
    inputs = {"state_dict": variables_to_state_dict(v), "batch": batch,
              "masks": _masks(3), "sched": SCHED}
    torch.save(inputs, tmp / "inputs.pt")
    bad = run_ranks(ranks.train_layouts, 4, str(tmp / "inputs.pt"), LAYOUTS,
                    str(tmp), timeout=TIMEOUT)
    one = ranks.port_step(inputs)
    one.pop("engine", None)
    layouts = {lay: torch.load(tmp / f"{lay[0]}x{lay[1]}.pt",
                               weights_only=False) for lay in LAYOUTS}
    return dict(jax=_jax_step(v, batch, inputs["masks"]), one=one,
                layouts=layouts, v=v, bad=bad, tmp=tmp)


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _hold_grads(got, want, bars):
    """tests/test_torch_train.py's gradient check: per leaf, the L2 norm of
    the difference over the leaf's norm, under bars[0] for the bi-LSTM and
    the head and bars[1] for the conv stacks; a leaf that is zero in exact
    arithmetic within 1e-6 of the largest gradient."""
    want, got = _leaves(want), _leaves(got)
    assert sorted(map(str, got)) == sorted(map(str, want))
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    worst = {True: 0.0, False: 0.0}
    for path, w in want.items():
        w, name = np.asarray(w), jax.tree_util.keystr(path)
        if np.abs(w).max() < 1e-6 * top:
            assert np.abs(got[path]).max() < 1e-6 * top, name
            continue
        head = "bi_rnn" in name or "linear" in name
        err = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
        assert err < bars[0 if head else 1], (name, err)
        worst[head] = max(worst[head], err)
    return worst


def _hold_params(got, want, frac):
    """After one Adam step at lr 1e-4 every entry has moved by about
    lr * sign(g): every entry within one step (2e-4) of ``want``, all but
    ``frac`` of them within 1e-6 (an entry whose gradient is within the
    f32 noise of zero can take another step)."""
    want, got = _leaves(want), _leaves(got)
    n_off = n_all = 0
    for path, w in want.items():
        d = np.abs(got[path] - np.asarray(w))
        assert d.max() <= 2.0001e-4, jax.tree_util.keystr(path)
        n_off += int((d > 1e-6).sum())
        n_all += d.size
    assert n_off <= frac * n_all, (n_off, n_all)


def _hold_stats(got, want, bar):
    """Running statistics: per leaf, max |got - want| within ``bar`` of
    the leaf's largest entry."""
    want, got = _leaves(want), _leaves(got)
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, w in want.items():
        w = np.asarray(w)
        d = np.abs(np.asarray(got[path]) - w).max()
        assert d <= bar * np.abs(w).max(), (jax.tree_util.keystr(path), d)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_step_matches_jax_unsharded_step(steps, layout):
    """The bars of tests/test_torch_train.py's one-process parity: losses
    1e-5 relative; gradients 1e-4 for the bi-LSTM and head, 3e-2 for the
    ill-conditioned encoder and height stage (JAX's own f32 gradients are
    ~0.8 % from its float64 ones there); parameters after Adam within one
    step (2e-4) of JAX, 99 % of entries within 1e-6. Measured on this
    input (all three layouts): losses 2.2e-7, gradients 4.4e-5 and
    1.02e-2, 0.17 % of entries past 1e-6, as the one-process step's
    4.4e-5, 9.3e-3 and 0.17 %."""
    want, got = steps["jax"], _as_trees(steps["layouts"][layout])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _hold_grads(got["grads"], want["grads"], (1e-4, 3e-2))
    _hold_params(got["params"], want["params"], 1e-2)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_batch_stats_are_jax_global_biased_update(steps, layout):
    """Running statistics after the step: flax's update, new = 0.9 old +
    0.1 batch, from the global batch's mean and biased variance; each leaf
    within 1e-4 of its largest entry of JAX's (measured 1.0e-5, the
    one-process step's 9.1e-6; the one-process parity's elementwise bar,
    rtol 1e-4 with atol 1e-6, is 1.6e-6 too tight for the one-process
    step itself on this input, at entries near 0). At layer4 (n = 4 x 16
    x 2 = 128 values a channel) torch's unbiased update would add 0.1
    var_batch / 127, over the bar."""
    want = steps["jax"]["stats"]
    _hold_stats(_as_trees(steps["layouts"][layout])["stats"], want, 1e-4)
    old, w = _leaves(steps["v"]["batch_stats"]), _leaves(want)
    worst = 0.0
    for path in w:
        if "layer4" in jax.tree_util.keystr(path) and \
                jax.tree_util.keystr(path).endswith("['var']"):
            new = np.asarray(w[path])
            batch = (new - 0.9 * old[path]) / 0.1
            worst = max(worst, float((0.1 * batch / 127).max()
                                     / np.abs(new).max()))
    assert worst > 1e-4


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_step_matches_one_process_step(steps, layout):
    """Against the port's own one-process step on the whole batch: the same
    arithmetic but the sums in another order (the batch-norm statistics
    from sums all-reduced over ranks where one process takes torch's
    batch norm; the input gradients of a sharded conv summed over ranks).
    Bars, tighter than JAX's: losses 1e-6 relative; gradients 5e-5
    (bi-LSTM, head) and 1.5e-2 (the ill-conditioned conv stacks);
    statistics within 2e-5 of each leaf's largest entry; parameters within
    one Adam step, 99.9 % of entries within 1e-6. Measured: 1.1e-7;
    1.7e-5 and 7.3e-3; 5.5e-6; 0.03 %."""
    one, got = _as_trees(steps["one"]), _as_trees(steps["layouts"][layout])
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-6)
    _hold_grads(got["grads"], one["grads"], (5e-5, 1.5e-2))
    _hold_stats(got["stats"], one["stats"], 2e-5)
    _hold_params(got["params"], one["params"], 1e-3)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_shards_the_conv_stacks(steps, layout):
    """Under n_model 2 every conv + batch-norm unit of the encoder and the
    height stage keeps its model index's half (resnet18's channels all
    divide 2), so a rank holds half the encoder; under n_model 1 nothing
    shards. No rank imported jax."""
    out = steps["layouts"][layout]
    assert steps["bad"] == [[]] * 4
    if layout[1] == 1:
        assert out["sharded"] == []
        assert out["encoder_local"] == out["encoder_whole"]
        return
    assert out["shards_are_slices"]
    names = out["sharded"]
    convs = [k for k in names if k.endswith(".weight")
             and out["state"]["state_dict"][k].ndim == 4]
    assert any(k.startswith("reduce_height_module.") for k in convs)
    n_conv = sum(1 for k, t in out["state"]["state_dict"].items()
                 if t.ndim == 4 and k.startswith(("feature_extractor.",
                                                  "reduce_height_module.")))
    assert len(convs) == n_conv
    assert not any(k.startswith(("bi_rnn.", "linear.")) for k in names)
    assert out["encoder_local"] * 2 == out["encoder_whole"]


def test_tp_checkpoint_restores_in_jax(steps):
    """The (1, 2) layout's rank 0 wrote checkpoint.ckpt from the gathered
    state: JAX's load_checkpoint restores its whole parameters and Adam
    moments."""
    host = steps["layouts"][(1, 2)]["state"]
    new, header = _jax_restore(str(steps["tmp"] / "checkpoint.ckpt"),
                               steps["v"])
    assert header["epoch"] == 1 and int(new.step) == 1
    want = _leaves(state_dict_to_variables(host["state_dict"])["params"])
    for p, a in _leaves(new.params).items():
        np.testing.assert_array_equal(np.asarray(a), want[p])
    sd = host["state_dict"]
    mu = state_dict_to_variables({**{k: torch.zeros_like(t) for k, t in
                                     sd.items()}, **host["moments"]["mu"]})
    got = _leaves(new.opt_state[0].mu)
    for p, a in _leaves(mu["params"]).items():
        np.testing.assert_array_equal(np.asarray(got[p]), a)


def _png_dataset(root, n, width, seed0=0):
    from horizonnet_tpu_torch.data import synth
    from horizonnet_tpu_torch.utils.image import write_png

    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "label_cor"))
    for i in range(n):
        img, cor = synth.synth_room(np.random.default_rng(seed0 + i), 512,
                                    width)
        write_png(os.path.join(root, "img", f"room{i}.png"), img)
        np.savetxt(os.path.join(root, "label_cor", f"room{i}.txt"), cor,
                   fmt="%.4f")


def _jax_restore(path, v):
    """JAX's load_checkpoint of ``path`` into a zero state shaped like the
    variables ``v``: (state, header)."""
    from horizonnet_tpu.models.registry import build_model as jax_build
    from horizonnet_tpu.train import create_train_state as jax_state
    from horizonnet_tpu.train.checkpoint import load_checkpoint

    zeros = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), v)
    state = jax_state(jax_build("resnet18", True), zeros,
                      jax_make_optimizer("Adam", jax_sched(*SCHED)))
    return load_checkpoint(path, state)


def test_cli_on_two_ranks_with_n_model_2_and_resume(tmp_path, steps):
    """The train CLI as torchrun runs it, 2 ranks, --n_model 2: one epoch
    with validation split over the ranks writes a whole checkpoint.ckpt
    that JAX restores and --resume continues to epoch 2, at the step of an
    unbroken run; a global batch the data axis does not split is refused
    on every rank."""
    _png_dataset(str(tmp_path / "train"), 2, 128)
    _png_dataset(str(tmp_path / "valid"), 2, 128, seed0=50)
    base = ["--ckpt", str(tmp_path / "ckpt"), "--logs",
            str(tmp_path / "logs"), "--train_root_dir",
            str(tmp_path / "train"), "--valid_root_dir",
            str(tmp_path / "valid"), "--backbone", "resnet18",
            "--batch_size_train", "2", "--lstm_impl", "pallas_train",
            "--device", "cpu"]
    runs = [["--id", "a", "--epochs", "1", "--n_model", "2", *base],
            ["--id", "a", "--epochs", "2", "--n_model", "2", "--resume",
             str(tmp_path / "ckpt" / "a"), *base],
            ["--id", "b", "--epochs", "1", *base, "--batch_size_train", "3"]]
    out = run_ranks(ranks.cli_runs, 2, runs, timeout=TIMEOUT)
    for refused, bad in out:
        assert refused == [None, None, "batch of 3 does not split over 2 "
                           "data ranks"]
        assert bad == []
    state, header = _jax_restore(
        str(tmp_path / "ckpt" / "a" / "checkpoint.ckpt"), steps["v"])
    assert header["epoch"] == 2 and int(state.step) == 2


def test_data_parallel_serving_of_the_golden():
    """InferenceEngine over a (2, 1) mesh, val_room twice in a batch of 2:
    each rank runs one row and returns both, cuboid and general, within
    1 px of golden_outputs.npz (the CPU bar) and z1 within 0.2."""
    want = np.load(os.path.join(GOLDEN, "golden_outputs.npz"))
    out = run_ranks(ranks.serve_golden, 2,
                    os.path.join(GOLDEN, "resnet18_rnn_synth.ckpt"),
                    os.path.join(GOLDEN, "val_room.png"), timeout=TIMEOUT)
    for cuboid, general in out:
        cor_id, z1 = cuboid
        assert cor_id.shape == (2, 8, 2)
        assert np.abs(cor_id - want["cuboid_uv"]).max() * 512 < 1.0
        assert np.abs(z1 - float(want["cuboid_z1"])).max() < 0.2
        assert len(general) == 2
        for uv, z0, gz1 in general:
            assert uv.shape == want["general_uv"].shape
            assert np.abs(uv - want["general_uv"]).max() * 512 < 1.0
            assert abs(gz1 - float(want["general_z1"])) < 0.2


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    dryrun_multichip(4, device="cpu", timeout=TIMEOUT)
    lines = capsys.readouterr().out.splitlines()
    assert sum("train step OK" in s for s in lines) == 2
    assert any("mesh=(data=2, model=2)" in s for s in lines)
    assert any("mesh=(data=4, model=1)" in s for s in lines)
    assert any("cuboid corners (4, 8, 2) serving OK" in s for s in lines)
    assert any("general-mode serving (4 panos" in s for s in lines)


def test_entry_is_the_flagship_forward():
    from horizonnet_tpu_torch.parallel.dryrun import entry

    fn, (sd, x) = entry(device="cpu")
    assert x.shape == (1, 3, 512, 1024)
    bon, cor = fn(sd, x)
    assert bon.shape == (1, 2, 1024) and cor.shape == (1, 1, 1024)
    assert torch.isfinite(bon).all() and torch.isfinite(cor).all()
