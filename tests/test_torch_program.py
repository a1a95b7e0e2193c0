"""The engines' compile-once, asynchronous contract, on the CPU.

horizonnet_tpu_torch/program.py gives the engines an upload ring (pinned
staging and a copy stream on the card, plain slots here) and, on the card,
one captured CUDA graph per engine; train/step.py keeps the optimizer's
count and learning rate on the device so that the graph moves them. Here:
the device-count optimizer against the host-float one it replaced (bit for
bit) and against optax; serve_stream through the ring; the train step from
host arrays and from device tensors; update_variables against a fresh
engine; the capture's check and the launch-count registry; and the
refusals. The captured programs themselves run on the card
(tests/test_torch_cuda.py, marker ``cuda``).
"""

import numpy as np
import optax
import pytest
import torch
import jax.numpy as jnp

from horizonnet_tpu.train.schedule import warmup_poly_schedule as jax_sched
from horizonnet_tpu.train.step import make_optimizer as jax_make_optimizer
from horizonnet_tpu_torch.inference import InferenceEngine, serve_stream
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.program import UploadRing, check_capture
from horizonnet_tpu_torch.train.engine import TrainEngine
from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
from horizonnet_tpu_torch.train.step import (create_train_state,
                                             make_optimizer)

# lr 1e-3 over 10 iterations, 3 of them warmup from 1e-6, power 0.9: five
# updates cross the warmup's end
SCHED = (1e-3, 10, 1e-6, 3, 0.9)
SHAPES = {"a": (3, 4), "b": (5,), "c": (64, 33), "d": (1000,)}


def _host_float_schedule(lr, max_iters, warmup_lr=1e-6, warmup_iters=0,
                         lr_pow=0.9):
    """The schedule as the port computed it before its count moved to the
    device: numpy float32 on the host."""
    f = np.float32

    def schedule(step):
        step = f(step)
        if step < warmup_iters:
            return float(f(warmup_lr) + (f(lr) - f(warmup_lr)) * step
                         / f(max(warmup_iters, 1)))
        frac = (step - f(warmup_iters)) / f(max(max_iters - warmup_iters, 1))
        return float(f(lr) * np.maximum(f(1.0) - frac, f(0.0)) ** f(lr_pow))
    return schedule


def _host_float_step(spec, schedule, ps, gs, moments, count):
    """One update as the port took it before: the learning rate and the
    bias corrections as Python floats from a host count. -> new count."""
    f = np.float32
    if spec.weight_decay:
        gs = torch._foreach_add(gs, ps, alpha=spec.weight_decay)
    lr = schedule(count)
    count += 1
    if spec.optim == "Adam":
        b1, b2 = spec.beta1, 0.999
        mu, nu = moments
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(gs, gs), alpha=1.0 - b2)
        bc1 = float(f(1) - f(b1) ** f(count))
        bc2 = float(f(1) - f(b2) ** f(count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, 1e-8)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    else:
        upd = moments[0]
        torch._foreach_mul_(upd, spec.beta1)
        torch._foreach_add_(upd, gs)
    torch._foreach_add_(ps, upd, alpha=-lr)
    return count


@pytest.mark.parametrize("optim", ["Adam", "SGD"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_device_count_optimizer_equals_host_float_and_optax(optim,
                                                            weight_decay):
    """Five updates on the warmup-poly schedule, warmup included, from the
    same numpy-seeded parameters and gradients: the device-count optimizer
    equals the host-float one bit for bit on the CPU (the same float32
    operations: an add with alpha is one fused rounding, as addcmul is),
    and optax within 1e-5 relative and 1e-4 of one update (lr), the bars
    of the port's one-step test in tests/test_torch_train.py."""
    rng = np.random.default_rng(7)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(5)]

    pt = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    port = make_optimizer(optim, warmup_poly_schedule(*SCHED), 0.0, 0.9,
                          weight_decay).init(pt)
    ph = [torch.from_numpy(v.copy()) for v in p0.values()]
    moments = [[torch.zeros_like(t) for t in ph]
               for _ in range(2 if optim == "Adam" else 1)]
    count = 0
    tx = jax_make_optimizer(optim, jax_sched(*SCHED), 0.0, 0.9, weight_decay)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_j = tx.init(pj)
    for g in grads:
        for k, v in g.items():
            pt[k].grad = torch.from_numpy(v)
        port.step()
        count = _host_float_step(port.spec, _host_float_schedule(*SCHED), ph,
                                 [torch.from_numpy(v) for v in g.values()],
                                 moments, count)
        upd, opt_j = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               opt_j, pj)
        pj = optax.apply_updates(pj, upd)
    assert port.count == count == 5
    assert port.count_t.dtype == torch.int32
    for (k, t), h in zip(pt.items(), ph):
        torch.testing.assert_close(t, h, rtol=0, atol=0, msg=k)
        np.testing.assert_allclose(t.numpy(), np.asarray(pj[k]), rtol=1e-5,
                                   atol=1e-4 * SCHED[0], err_msg=k)


def test_schedule_takes_the_device_count():
    """The schedule of the optimizer's count, a 0-dim float32 tensor,
    equals its float at that step, which the host-float schedule gave, bit
    for bit, through warmup, decay and past the end."""
    for args in (SCHED, (1e-4, 100, 1e-6, 0, 0.9), (3e-4, 1000, 1e-6, 37,
                                                     0.9)):
        s, old = warmup_poly_schedule(*args), _host_float_schedule(*args)
        for n in range(args[1] + 5):
            got = s(torch.tensor(float(n)))
            assert got.dtype == torch.float32 and got.dim() == 0
            assert s(n) == old(n) == got.item(), (args, n)


def test_optimizer_count_reads_and_writes_as_an_int():
    p = {"w": torch.zeros(3)}
    opt = make_optimizer("SGD", None, 0.5).init(p)
    assert opt.count == 0 and isinstance(opt.count, int)
    opt.count = 7                   # train/checkpoint.py::load_checkpoint
    assert opt.count_t.item() == 7 and opt.count_t.dtype == torch.int32
    p["w"].grad = torch.ones(3)
    opt.step()                      # no schedule: the constant lr
    assert opt.count == 8
    torch.testing.assert_close(p["w"], torch.full((3,), -0.5), rtol=0,
                               atol=0)
    assert opt.state_tensors()[0] is opt.count_t


@pytest.fixture(scope="module")
def small():
    """resnet18_rnn at the reference height and a cut width."""
    return build_model("resnet18", True, device="cpu", seed=3)


def test_serve_stream_returns_each_batch_in_order(small):
    """Six distinct batches through the ring of 4 slots at depth 3: each
    result is its own batch's (the engine called on it alone), in input
    order, with and without a finish tail."""
    rng = np.random.default_rng(11)
    eng = InferenceEngine(small, small.state_dict(), W=64,
                          input_format="uint8", device="cpu")
    batches = [rng.integers(0, 256, (1, 512, 64, 3), dtype=np.uint8)
               for _ in range(6)]
    want = [eng(b) for b in batches]
    got = list(serve_stream(eng, iter(batches), depth=3))
    assert len(got) == 6
    for (bw, cw), (bg, cg) in zip(want, got):
        torch.testing.assert_close(bg, bw, rtol=0, atol=0)
        torch.testing.assert_close(cg, cw, rtol=0, atol=0)
    tails = list(serve_stream(eng, iter(batches), depth=3,
                              finish=lambda o: o[0].sum().item(), workers=2))
    assert tails == [b.sum().item() for b, _ in want]
    assert len({round(t, 3) for t in tails}) == 6


def test_upload_ring_refuses_a_stale_upload():
    """An upload runs until its slot is put anew (slots puts later)."""
    ring = UploadRing((2, 3), torch.int8, "cpu", 2)
    a = ring.put(np.full((2, 3), 1, np.int8))
    b = ring.put(np.full((2, 3), 2, np.int8))
    assert ring.take(a).sum().item() == 6
    assert ring.take(a).sum().item() == 6          # again: still its slot
    c = ring.put(np.full((2, 3), 3, np.int8))      # a's slot
    assert ring.take(b).sum().item() == 12
    assert ring.take(c).sum().item() == 18
    with pytest.raises(RuntimeError, match="put again"):
        ring.take(a)


def test_engine_run_takes_a_device_tensor_of_the_wire_shape(small):
    eng = InferenceEngine(small, small.state_dict(), W=64,
                          input_format="uint8", postproc="cuboid",
                          device="cpu")
    x = np.random.default_rng(2).integers(0, 256, (1, 512, 64, 3),
                                          dtype=np.uint8)
    torch.testing.assert_close(eng.run(torch.from_numpy(x)), eng(x), rtol=0,
                               atol=0)
    with pytest.raises(ValueError, match="engine's"):
        eng.run(torch.from_numpy(x).float())
    with pytest.raises(ValueError, match="engine's"):
        eng.run(torch.from_numpy(x[:, :, :32]))


def test_update_variables_then_run_equals_a_fresh_engine():
    """update_variables copies into the parameters in place (a captured
    program reads them there); the next run equals an engine built with
    the new weights."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (1, 512, 64, 3)).astype(np.float32)
    old = build_model("resnet18", True, device="cpu", seed=1)
    new_sd = build_model("resnet18", True, device="cpu", seed=2).state_dict()
    eng = InferenceEngine(old, old.state_dict(), W=64, postproc="cuboid",
                          device="cpu")
    before = eng(x)
    params = {k: t.data_ptr() for k, t in old.state_dict().items()}
    eng.update_variables(new_sd)
    assert {k: t.data_ptr() for k, t in old.state_dict().items()} == params
    fresh_model = build_model("resnet18", True, device="cpu", seed=9)
    fresh = InferenceEngine(fresh_model, new_sd, W=64, postproc="cuboid",
                            device="cpu")
    got = eng(x)
    torch.testing.assert_close(got, fresh(x), rtol=0, atol=0)
    assert not torch.equal(got, before)


def _train_engine(seed=0):
    model = build_model("resnet18", True, device="cpu", seed=seed,
                        lstm_impl="kernel_train", param_dtype=torch.float32)
    state = create_train_state(model, make_optimizer(
        "Adam", warmup_poly_schedule(1e-3, 100, 1e-6, 1)))
    return TrainEngine(model, state, 2, 512, 64, device="cpu")


def test_train_step_takes_host_arrays_and_device_tensors():
    """The same batch as numpy arrays and as tensors on the engine's
    device (the augmentation's output is one) gives the same step: losses,
    parameters, statistics and moments, bit for bit, over two steps."""
    rng = np.random.default_rng(3)
    batches = [(rng.uniform(0, 1, (2, 512, 64, 3)).astype(np.float32),
                rng.normal(0, 0.5, (2, 2, 64)).astype(np.float32),
                rng.uniform(0, 1, (2, 1, 64)).astype(np.float32))
               for _ in range(2)]
    host, dev = _train_engine(), _train_engine()
    for s, b in enumerate(batches):
        mh = host.step(*b, torch.Generator().manual_seed(s))
        md = dev.step(*(torch.from_numpy(a.copy()) for a in b),
                      torch.Generator().manual_seed(s))
        for k in mh:
            assert mh[k].item() == md[k].item(), k
    a, b = host.host_state(), dev.host_state()
    assert a["step"] == b["step"] == 2
    for k, t in a["state_dict"].items():
        torch.testing.assert_close(b["state_dict"][k], t, rtol=0, atol=0)
    for k, m in a["moments"].items():
        for n, t in m.items():
            torch.testing.assert_close(b["moments"][k][n], t, rtol=0,
                                       atol=0)


def test_engines_run_the_eager_program_on_the_cpu(small):
    """The engines capture by default (graph=True) only where a capture
    can run: on the CPU both run the eager program."""
    assert InferenceEngine(small, small.state_dict(), W=64,
                           device="cpu").program is None
    assert _train_engine().program is None


@pytest.mark.parametrize("nodes,kernels,launched,error", [
    (0, 0, 0, "empty"), (0, 0, 2, "empty"), (7, 1, 2, "outside"),
    (7, 2, 2, None), (7, 5, 0, None)])
def test_check_capture_refuses_a_graph_that_missed_the_program(
        nodes, kernels, launched, error):
    """A graph with no node, or with fewer kernel nodes than the wrappers
    launched while it was captured, recorded a program that ran elsewhere
    (on another card's stream): the capture raises."""
    if error is None:
        check_capture(nodes, kernels, launched)
    else:
        with pytest.raises(RuntimeError, match=error):
            check_capture(nodes, kernels, launched)


def test_launch_counts_register_every_kernel_wrapper():
    """K1-K5's wrappers register their counts (ops/launch_counts.py), which
    a replay moves; read and write go through the modules' globals."""
    from horizonnet_tpu_torch.ops import (cuda_lstm, cuda_lstm_train,
                                          fused_block, launch_counts, pad)

    want = {(cuda_lstm.__name__, "launches"),
            (cuda_lstm_train.__name__, "fwd_launches"),
            (cuda_lstm_train.__name__, "bwd_launches"),
            (fused_block.__name__, "launches"),
            (pad.__name__, "fwd_launches"), (pad.__name__, "bwd_launches")}
    assert want <= set(launch_counts.COUNTS)
    before = launch_counts.read()
    try:
        launch_counts.write({(cuda_lstm.__name__, "launches"): 41})
        assert cuda_lstm.launches == 41
        assert launch_counts.read()[(cuda_lstm.__name__, "launches")] == 41
    finally:
        launch_counts.write(before)


def test_inference_pads_a_short_chunk_to_the_batch(small):
    """inference(batch_size=4) on three panos runs the engine of four rows
    (the one a run's full chunks use, so the card captures one) and gives
    the three panos' results, equal to the unpadded call's."""
    from horizonnet_tpu_torch import inference as inf

    x = np.random.default_rng(5).uniform(0, 1, (3, 512, 256, 3)).astype(
        np.float32)
    want = inf.inference(small, small.state_dict(), x, force_cuboid=True)
    got = inf.inference(small, small.state_dict(), x, force_cuboid=True,
                        batch_size=4)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        assert (g[1], g[2]) == (w[1], w[2])
    key = (id(small), 4, 512, 256)
    assert any((k[0], *k[2:5]) == key for k in inf._ENGINE_CACHE)
