"""Entry points of the port: the flagship forward, and the multi-process
dryrun.

Counterpart of __graft_entry__.py:
- ``entry()``: the flagship forward (resnet50_rnn at 1x512x1024) and its
  example arguments.
- ``dryrun_multichip(n)``: ``n`` ranks, each a fresh process spawned by
  torch.multiprocessing and joined through a file store (``run_ranks``),
  run one training step on an (n/2 data, 2 model) mesh (batch on 'data',
  the conv channels on 'model'), then on the pure data-parallel (n, 1)
  mesh, then data-parallel cuboid serving and general serving through
  ``finish_general_batch``. Both layouts run and both must pass: JAX's
  retry in a smaller layout covers an abort of its in-process CPU
  rendezvous, which separate processes do not have.

The port's bi-LSTM input width is fixed by an input height of 512 (as in
the reference), so the dryrun runs 512x32 panos where JAX's runs 64x32.
The spawned ranks import torch and this package only.
"""

import os
import pickle
import queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import init_distributed, make_mesh, shard_batch

DRYRUN_H, DRYRUN_W = 512, 32


def entry(device="cuda"):
    """(fn, example_args): fn(state_dict, x) is the flagship's forward
    (resnet50_rnn, eval mode, random weights from seed 0) on x [1, 3, 512,
    1024] in [0, 1]."""
    from ..models import build_model

    model = build_model("resnet50", True, device=device)
    x = torch.zeros(1, 3, 512, 1024, device=device)

    def fn(state_dict, x):
        with torch.no_grad():
            return torch.func.functional_call(model, state_dict, (x,))

    return fn, (model.state_dict(), x)


def _rank_main(rank, world, init_method, device, fn, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if device == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        init_distributed(device, init_method)
        # pickled here, by value: a tensor put on the queue as it is
        # would go by shared memory, which dies with this process
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, *args, device="cpu", timeout=600.0):
    """Run ``fn(*args)`` on ``world`` ranks, each a fresh spawned process
    that joined the process group (parallel/mesh.py::init_distributed on
    ``device``, a file store in a new temporary directory) before the call.
    ``fn`` must be importable by name. Returns the ranks' results in rank
    order. A rank that raises or dies, or a run longer than ``timeout``
    seconds, stops every rank and raises."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, init, device, fn, args, results)) for r in range(world)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < world:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited "
                                           f"({procs[dead[0]].exitcode}) "
                                           "without a result")
                    if time.monotonic() > deadline:
                        late = sorted(set(range(world)) - set(out))
                        raise TimeoutError(f"ranks {late} gave no result "
                                           f"in {timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
                out[rank] = pickle.loads(val)
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


def _dryrun_rank(layouts, device):
    """One rank of dryrun_multichip: the lines rank 0 prints."""
    from ..inference import InferenceEngine
    from ..models import build_model
    from ..postproc import finish_general_batch, unpack_cuboid_outputs
    from ..train.engine import TrainEngine
    from ..train.schedule import warmup_poly_schedule
    from ..train.step import create_train_state, make_optimizer

    world = dist.get_world_size()
    B, H, W = world, DRYRUN_H, DRYRUN_W
    dev = torch.device(device) if device == "cpu" else \
        torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    batch = (rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             rng.normal(0, 0.3, (B, 2, W)).astype(np.float32),
             rng.uniform(0, 1, (B, 1, W)).astype(np.float32))
    lines = []
    for n_data, n_model in layouts:
        mesh = make_mesh(n_data, n_model)
        model = build_model("resnet50", True, device=dev, seed=0,
                            lstm_impl="kernel_train",
                            param_dtype=torch.float32)
        tx = make_optimizer("Adam", warmup_poly_schedule(1e-4, 100))
        engine = TrainEngine(model, create_train_state(model, tx), B, H, W,
                             device=dev, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(1)
        total = engine.step(*shard_batch(mesh, batch), gen)["total"].item()
        if not np.isfinite(total) or engine.state.step != 1:
            raise RuntimeError(f"mesh {mesh.shape}: loss {total}, step "
                               f"{engine.state.step}")
        lines.append(f"dryrun_multichip({world}): mesh=(data={n_data}, "
                     f"model={n_model}) loss={total:.4f} train step OK")

    mesh = make_mesh(world, 1)
    model = build_model("resnet50", True, device=dev, seed=0)
    weights = model.state_dict()
    eng = InferenceEngine(model, weights, B, H, W, input_format="uint8",
                          postproc="cuboid", device=dev, mesh=mesh)
    cor_id, z1 = unpack_cuboid_outputs(eng(
        rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)))
    if cor_id.shape != (B, 8, 2) or not np.all(np.isfinite(z1)):
        raise RuntimeError(f"cuboid serving: {cor_id.shape}, z1 {z1}")
    lines.append(f"dryrun_multichip({world}): data-parallel InferenceEngine "
                 f"(data={world}) cuboid corners {cor_id.shape} serving OK")
    gen_eng = InferenceEngine(model, weights, B, H, W, input_format="uint8",
                              postproc="general", device=dev, mesh=mesh)
    results = finish_general_batch(gen_eng(
        rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)), coorW=W,
        coorH=H)
    if len(results) != B or not all(
            np.isfinite(z) and len(c) >= 8 and len(c) % 2 == 0
            for c, _, z in results):
        raise RuntimeError("general serving: bad results")
    lines.append(f"dryrun_multichip({world}): data-parallel general-mode "
                 f"serving ({len(results)} panos through "
                 "finish_general_batch) OK")
    return lines


def dryrun_multichip(n_devices, device="cuda", timeout=900.0):
    """The multi-process dryrun on ``n_devices`` ranks (module docstring);
    raises if any rank fails. On "cuda" the ranks share the visible cards
    (gloo where they outnumber them, parallel/mesh.py)."""
    layouts = ([(n_devices // 2, 2)] if n_devices % 2 == 0 else []) + \
        [(n_devices, 1)]
    lines = run_ranks(_dryrun_rank, n_devices, layouts, device,
                      device=device, timeout=timeout)[0]
    for line in lines:
        print(line, flush=True)
