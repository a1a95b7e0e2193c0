"""The port's training step (horizonnet_tpu_torch/train) against JAX.

Losses, the schedule and the optimizer against horizonnet_tpu/train and
optax; one whole train step of resnet18_rnn (f32, input (2, 512, 128))
on the same weights and the same dropout masks: losses, the gradient of
every parameter (the folded LSTM bias included), the new batch
statistics and the parameters after one Adam update.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from horizonnet_tpu.train.schedule import warmup_poly_schedule as jax_sched
from horizonnet_tpu.train.step import loss_terms as jax_loss_terms
from horizonnet_tpu.train.step import make_optimizer as jax_make_optimizer
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.models.horizonnet import loss_terms
from horizonnet_tpu_torch.models.torch_convert import (
    state_dict_to_variables, variables_to_state_dict)
from horizonnet_tpu_torch.ops import dropout as port_dropout
from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
from horizonnet_tpu_torch.train.step import (
    create_train_state, encoder_freeze_mask, eval_losses, make_optimizer,
    train_step)


def jax_variables(backbone, use_rnn, seed):
    """(JAX model, numpy variables): the tree's shapes from eval_shape (no
    compute), filled like the JAX init (lecun-normal kernels, U(-k, k)
    LSTM) with non-identity batch norm, so every leaf matters."""
    from horizonnet_tpu.models.registry import build_model as jax_build

    model = jax_build(backbone, use_rnn)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 512, 64, 3)), train=False))
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(512)

    def fill(path, s):
        names = [getattr(p, "key", "") for p in path]
        last, shape = names[-1], s.shape
        if names[0] == "batch_stats":
            a = (rng.normal(0, 0.1, shape) if last == "mean"
                 else rng.uniform(0.8, 1.2, shape))
        elif "bi_rnn" in names:
            a = rng.uniform(-k, k, shape)
        elif last == "kernel":
            a = rng.normal(0, np.sqrt(1 / np.prod(shape[:-1])), shape)
        elif last == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.normal(0, 0.05, shape)
        return a.astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, shapes)


def test_loss_terms_match_jax():
    rng = np.random.default_rng(0)
    bp, bt = rng.normal(size=(2, 2, 2, 64)).astype(np.float32)
    cp = (rng.normal(size=(2, 1, 64)) * 30).astype(np.float32)   # saturating
    ct = rng.uniform(0, 1, (2, 1, 64)).astype(np.float32)
    want = jax_loss_terms(*map(jnp.asarray, (bp, cp, bt, ct)))
    got = loss_terms(*map(torch.from_numpy, (bp, cp, bt, ct)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_matches_jax(warmup):
    """float32 on both sides: equal to 1 ulp, at step 0, around the warmup
    edge, mid-decay and past the end."""
    args = (1e-4, 100, 1e-6, warmup, 0.9)
    s, s_j = warmup_poly_schedule(*args), jax_sched(*args)
    for step in (0, 1, warmup - 1, warmup, warmup + 1, 55, 99, 100, 130):
        if step >= 0:
            np.testing.assert_allclose(s(step), float(s_j(step)), rtol=2e-7,
                                       atol=0)


@pytest.mark.parametrize("optim", ["Adam", "SGD"])
@pytest.mark.parametrize("weight_decay,frozen", [(0.0, False), (1e-2, False),
                                                 (0.0, True), (1e-2, True)])
def test_optimizer_matches_optax(optim, weight_decay, frozen):
    """Three updates of a small parameter tree fed the same gradients;
    the schedule moves the learning rate each step (optax reads it at the
    count before the update). f32 arithmetic in another order: 1e-6."""
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    mask = {"a": True, "b": False, "c": True} if frozen else None
    sched = lambda n: 1e-2 / (1.0 + n)  # noqa: E731

    tx = jax_make_optimizer(optim, sched, 0.0, 0.9, weight_decay, mask)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(pj)
    for g in grads:
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             pj)
        pj = optax.apply_updates(pj, upd)

    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    port = make_optimizer(optim, sched, 0.0, 0.9, weight_decay,
                          mask).init(pt)
    for g in grads:
        for k, v in g.items():
            pt[k].grad = torch.from_numpy(v)
        port.step()
    assert port.count == 3
    for k in shapes:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    if frozen:
        np.testing.assert_array_equal(pt["b"].numpy(), p0["b"])


def test_freeze_mask_matches_jax_blocks():
    from horizonnet_tpu.train.step import encoder_freeze_mask as jax_mask

    _, v = jax_variables("resnet18", True, 0)
    sd = variables_to_state_dict(v)
    names = [n for n, _ in build_model("resnet18", True, device="cpu")
             .named_parameters()]
    for n_frozen in (-1, 0, 2):
        want = jax_mask(v["params"], n_frozen)
        got = encoder_freeze_mask(names, n_frozen)
        # the port's mask through the converter is the JAX mask's tree
        as_sd = {k: torch.full_like(t, float(got.get(k, True)))
                 for k, t in sd.items()}
        back = state_dict_to_variables(as_sd)["params"]
        flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
        for path, leaf in jax.tree_util.tree_leaves_with_path(back):
            assert bool(np.all(leaf > 0.5)) == flat_w[path], path


def _masks(seed):
    """Two dropout keep-masks [T, B, 2H] = [32, 2, 1024], in draw order:
    between the LSTM layers, then after the LSTM."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(32, 2, 1024)) < 0.5 for _ in range(2)]


@pytest.fixture(scope="module")
def one_step():
    """JAX and the port through one Adam step of resnet18_rnn, f32, on the
    same weights, batch and dropout masks."""
    model_j, v = jax_variables("resnet18", True, 0)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 512, 128, 3)).astype(np.float32)
    y_bon = rng.normal(0, 0.5, (2, 2, 128)).astype(np.float32)
    y_cor = rng.uniform(0, 1, (2, 1, 128)).astype(np.float32)
    sched_args = (1e-4, 100)

    mp = pytest.MonkeyPatch()
    queue = _masks(3)

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

    (total, (bon_l, cor_l, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"], v["batch_stats"])
    tx = jax_make_optimizer("Adam", jax_sched(*sched_args))
    upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
    params_j = optax.apply_updates(v["params"], upd)
    jax_out = dict(losses=[float(total), float(bon_l), float(cor_l)],
                   grads=grads, stats=stats, params=params_j)

    queue[:] = _masks(3)
    mp.setattr(port_dropout, "keep_mask",
               lambda shape, p, gen, device: torch.from_numpy(queue.pop(0)))
    model = build_model("resnet18", True, device="cpu",
                        lstm_impl="kernel_train",
                        param_dtype=torch.float32)
    model.load_state_dict(variables_to_state_dict(v))
    state = create_train_state(model, make_optimizer(
        "Adam", warmup_poly_schedule(*sched_args)))
    grads_t = {}
    step_opt = state.opt.step

    def capture_then_step():
        grads_t.update({n: p.grad.clone() for n, p in
                        model.named_parameters()})
        step_opt()

    state.opt.step = capture_then_step
    m = train_step(state, torch.from_numpy(x), torch.from_numpy(y_bon),
                   torch.from_numpy(y_cor), torch.Generator())
    mp.undo()
    sd = model.state_dict()
    zeros = {k: torch.zeros_like(t) for k, t in sd.items()}
    port_out = dict(
        losses=[m["total"].item(), m["bon"].item(), m["cor"].item()],
        grads=state_dict_to_variables({**zeros, **grads_t})["params"],
        stats=state_dict_to_variables(sd)["batch_stats"],
        params=state_dict_to_variables(sd)["params"],
        n_params=len(grads_t), model=model, state=state)
    return jax_out, port_out, v


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def test_train_step_losses_and_grads_match_jax(one_step):
    """Loss terms to 1e-5 relative (f32 forward parity is 2e-4,
    tests/test_torch_model.py). Gradients, as the L2 norm of the
    difference over the leaf's norm:
    - the bi-LSTM (the folded bias included) and the head: 1e-4 (they
      agree to ~3e-5; the autograd.Function's K2/K3 twins against JAX's
      scan);
    - the encoder and height stage: 3e-2. This random resnet18's f32
      encoder gradients are ill-conditioned: JAX's own f32 gradients
      differ from its float64 ones by ~0.8 % in those leaves (measured
      with jax_enable_x64 on this input), and the port lands as far from
      JAX's f32 as that. Leaves whose gradient is zero in exact arithmetic
      (a conv bias followed by batch norm) are held to 1e-6 of the largest
      gradient of the model instead."""
    jax_out, port_out, _ = one_step
    np.testing.assert_allclose(port_out["losses"], jax_out["losses"],
                               rtol=1e-5)
    want, got = _leaves(jax_out["grads"]), _leaves(port_out["grads"])
    assert sorted(map(str, got)) == sorted(map(str, want))
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for path, w in want.items():
        w, name = np.asarray(w), jax.tree_util.keystr(path)
        if np.abs(w).max() < 1e-6 * top:
            assert np.abs(got[path]).max() < 1e-6 * top, name
            continue
        bar = 1e-4 if ("bi_rnn" in name or "linear" in name) else 3e-2
        err = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
        assert err < bar, (name, err)


def _layer4_var_paths(stats):
    return [p for p in stats if "layer4" in jax.tree_util.keystr(p)
            and jax.tree_util.keystr(p).endswith("['var']")]


def test_train_step_batch_stats_are_jax_biased_update(one_step):
    """Running statistics after one step: flax's update, new = 0.9 old +
    0.1 batch, with the biased batch variance. Both sides agree to 1e-4
    relative (measured 7e-6). At layer4 (n = 2 x 16 x 4 = 128 values per
    channel) torch's unbiased update would add 0.1 var_batch / 127: the
    test shows that exceeds the bar, so it would fail."""
    jax_out, port_out, v = one_step
    want, got = _leaves(jax_out["stats"]), _leaves(port_out["stats"])
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, w in want.items():
        np.testing.assert_allclose(got[path], np.asarray(w), rtol=1e-4,
                                   atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    old = _leaves(v["batch_stats"])
    worst = 0.0
    for path in _layer4_var_paths(want):
        w = np.asarray(want[path])
        batch = (w - 0.9 * old[path]) / 0.1
        worst = max(worst, float((0.1 * batch / 127 / w).max()))
    assert worst > 1e-4


def test_train_step_params_after_adam_match_jax(one_step):
    """After one Adam step at lr 1e-4 every entry has moved by about
    lr * sign(g). An entry whose gradient is within the f32 noise above of
    zero can take another step size, so: every entry within one step
    (2e-4) of JAX, 99 % of them within 1e-6."""
    jax_out, port_out, v = one_step
    want, got = _leaves(jax_out["params"]), _leaves(port_out["params"])
    n_off, n_all = 0, 0
    for path, w in want.items():
        d = np.abs(got[path] - np.asarray(w))
        assert d.max() <= 2.0001e-4, jax.tree_util.keystr(path)
        n_off += int((d > 1e-6).sum())
        n_all += d.size
    assert n_off <= 1e-2 * n_all, (n_off, n_all)
    # the folded LSTM bias moved once, by at most lr (two trainable
    # halves would move it by up to 2 lr)
    for layer in (0, 1):
        b0 = v["params"]["bi_rnn"][f"l{layer}_b"]
        moved = np.abs(port_out["params"]["bi_rnn"][f"l{layer}_b"] - b0)
        assert 0.5e-4 < moved.max() <= 1.0001e-4


def test_eval_losses_run_in_eval_mode(one_step):
    _, port_out, _ = one_step
    state = port_out["state"]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 512, 128, 3)).astype(
        np.float32))
    yb = torch.zeros(2, 2, 128)
    yc = torch.zeros(2, 1, 128)
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    a = eval_losses(state, x, yb, yc)
    b = eval_losses(state, x, yb, yc)
    assert not state.model.training
    assert a["total"].item() == b["total"].item()
    for k, t in state.model.state_dict().items():
        torch.testing.assert_close(t, before[k], rtol=0, atol=0)


def test_lstm_bias_trains_as_one_folded_parameter():
    """bias_ih is the only trainable LSTM bias; a state_dict with a
    nonzero bias_hh (the reference's nn.LSTM) loads folded into it."""
    m = build_model("resnet18", True, device="cpu")
    biases = [n for n, _ in m.named_parameters() if n.startswith("bi_rnn.b")]
    assert len(biases) == 4 and all("bias_ih" in n for n in biases)
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    want = sd["bi_rnn.bias_ih_l1_reverse"] + 0.25
    sd["bi_rnn.bias_hh_l1_reverse"] = torch.full_like(want, 0.25)
    m.load_state_dict(sd)
    torch.testing.assert_close(m.bi_rnn.bias_ih_l1_reverse.detach(), want,
                               rtol=0, atol=0)
    assert not m.bi_rnn.bias_hh_l1_reverse.any()
