"""Rank functions of tests/test_torch_parallel.py.

horizonnet_tpu_torch/parallel/dryrun.py::run_ranks runs them in spawned
processes, one per rank, after the rank joined the process group. This
module imports torch and the port only, so each rank reports whether
anything of jax got imported.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.ops import dropout as port_dropout
from horizonnet_tpu_torch.parallel import make_mesh, shard_batch
from horizonnet_tpu_torch.train.engine import TrainEngine
from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
from horizonnet_tpu_torch.train.step import create_train_state, make_optimizer


def jax_modules():
    return sorted(k for k in sys.modules if k.split(".")[0] in
                  ("jax", "jaxlib", "flax", "optax", "horizonnet_tpu"))


def port_step(inputs, mesh=None):
    """One Adam step of resnet18_rnn (f32, K2/K3's twins) on the global
    batch ``inputs["batch"]`` with the dropout masks ``inputs["masks"]``
    (the global batch's, in draw order), on this rank's part of ``mesh``
    (or one process). -> {"losses", "grads", "state", "sharded",
    "shards_are_slices", "encoder_local", "encoder_whole"}: the global
    losses, the whole gradients and state after the step, the sharded
    names, whether each shard was its model index's slice of the whole
    tensor before the step, and the encoder's parameter elements on this
    rank and in the whole model."""
    full = inputs["state_dict"]
    model = build_model("resnet18", True, device="cpu",
                        lstm_impl="kernel_train", param_dtype=torch.float32)
    model.load_state_dict(full)
    state = create_train_state(model, make_optimizer(
        "Adam", warmup_poly_schedule(*inputs["sched"])))
    x, y_bon, y_cor = inputs["batch"]
    engine = TrainEngine(model, state, x.shape[0], x.shape[1], x.shape[2],
                         device="cpu", mesh=mesh)
    r = 0 if mesh is None else mesh.model_rank
    local = model.state_dict()
    slices = all(torch.equal(local[k], full[k][r * local[k].shape[0]:
                                                (r + 1) * local[k].shape[0]])
                 and local[k].shape[0] < full[k].shape[0]
                 for k in engine.sharded)
    enc = [k for k, _ in model.named_parameters()
           if k.startswith("feature_extractor.encoder.")]
    masks = list(inputs["masks"])

    def keep_mask(shape, p, generator, device):
        m = masks.pop(0)
        assert tuple(shape) == m.shape, (shape, m.shape)
        return torch.from_numpy(m)

    saved = port_dropout.keep_mask
    port_dropout.keep_mask = keep_mask
    try:
        batch = (x, y_bon, y_cor) if mesh is None else \
            shard_batch(mesh, (x, y_bon, y_cor))
        m = engine.step(*batch, torch.Generator())
    finally:
        port_dropout.keep_mask = saved
    assert not masks
    grads = engine.full({n: p.grad for n, p in model.named_parameters()})
    return {"losses": [m[k].item() for k in ("total", "bon", "cor")],
            "grads": {k: v.clone() for k, v in grads.items()},
            "state": engine.host_state(), "sharded": sorted(engine.sharded),
            "shards_are_slices": slices,
            "encoder_local": sum(local[k].numel() for k in enc),
            "encoder_whole": sum(full[k].numel() for k in enc)}


def train_layouts(inputs_path, layouts, out_dir):
    """port_step at each (n_data, n_model) layout on the ranks of its
    mesh (the others wait); rank 0 saves each layout's result to
    out_dir/<d>x<m>.pt, and the (1, 2) layout's rank 0 also writes its
    training checkpoint there. Returns the jax modules imported."""
    from horizonnet_tpu_torch.train.checkpoint import save_checkpoint

    inputs = torch.load(inputs_path, weights_only=False)
    for n_data, n_model in layouts:
        mesh = make_mesh(n_data, n_model)
        if mesh is None:
            continue
        out = port_step(inputs, mesh)
        if dist.get_rank() == 0:
            if (n_data, n_model) == (1, 2):
                save_checkpoint(out_dir, out["state"], "resnet18", True, 1,
                                0.5, False)
            del out["state"]["spec"]   # holds the schedule, a closure
            torch.save(out, f"{out_dir}/{n_data}x{n_model}.pt")
    return jax_modules()


def cli_runs(runs):
    """horizonnet_tpu_torch.cli.train.main on each argv of ``runs`` in
    turn: (the ValueError message of each refused run, else None; the jax
    modules imported)."""
    from horizonnet_tpu_torch.cli.train import main

    refused = []
    for argv in runs:
        try:
            main(argv)
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    return refused, jax_modules()


def serve_golden(ckpt, png):
    """The golden checkpoint served over a pure data-parallel mesh of the
    world, the pano in every row of a batch of the world's size:
    ((cor_id, z1) cuboid, finish_general_batch's results)."""
    from horizonnet_tpu_torch.inference import InferenceEngine
    from horizonnet_tpu_torch.postproc import (finish_general_batch,
                                               unpack_cuboid_outputs)
    from horizonnet_tpu_torch.train.checkpoint import load_trained_model
    from horizonnet_tpu_torch.utils.image import read_png

    n = dist.get_world_size()
    mesh = make_mesh(n, 1)
    x = np.repeat(read_png(png)[None].astype(np.float32) / 255.0, n, 0)
    model, sd = load_trained_model(ckpt, device="cpu")
    out = []
    for postproc in ("cuboid", "general"):
        eng = InferenceEngine(model, sd, n, postproc=postproc,
                              device="cpu", mesh=mesh)
        out.append(eng(x))
    return unpack_cuboid_outputs(out[0]), finish_general_batch(out[1])
