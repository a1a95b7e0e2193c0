"""Training LGT-Net: the train CLI's data path and captured step, with the
SWG-Transformer in the bi-LSTM's place (``--model lgt``).

Traffic parameters and timing are kinds/train.py's: ``rooms``,
``prefetch_workers``, ``checked_steps``, ``trace_seconds``; the batch,
optimizer and schedule are the configuration's ``train``;
``train_panos_per_s`` is the panos of every step queued in the window
over the seconds from the first step to the last step's losses on the
host.

Each step's batch is built as the CLI builds it with ``--model lgt``: the
program's ``augment_batch`` (uint8 upload, flip, rotate, gamma and
stretch on the card), then on the prefetch thread the horizon-depth and
ratio labels of each pano (data/dataset.py::lgt_labels, the span
``labels.depth``). The program is ``build_model(arch="lgt")`` with
seeded weights (harness/lgt_weights.py) under ``TrainEngine``, which
captures the step as one CUDA graph on the card. The judge is
harness/judge_lgt_train.py.

Set-up refuses a configuration whose architecture keys (``ARCH``) differ
from what the built program and reference/lgt.py build (``check_config``),
so that an edited configuration is never run as another one.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from harness.kinds import train
from harness.lgt_weights import seeded_weights
from reference import lgt as ref_lgt

#: the configuration's keys that name the architecture: a configuration
#: must state each as the program and the reference build it (its dtype
#: and train.param_dtype are harness/cell.py::BUILT's)
ARCH = ("backbone", "step_cols", "out_scale", "patch_num", "dim", "heads",
        "head_dim", "mlp_dim", "win_size", "shift", "depth", "blocks", "rpe",
        "dropout", "camera_height", "loss")


def program_spec(model):
    """The architecture ``model`` (the program's LGTNet) was built with,
    under the configuration's keys."""
    from horizonnet_tpu_torch.data.labels import CAMERA_HEIGHT
    from horizonnet_tpu_torch.models import horizonnet, lgt

    blocks = model.swg.blocks
    attn = {b.attn.kind: b.attn for b in blocks}
    a = blocks[0].attn
    dim = model.depth.weight.shape[1]
    return {"backbone": model.backbone, "step_cols": horizonnet.STEP_COLS,
            "out_scale": horizonnet.OUT_SCALE, "patch_num": model.n,
            "dim": dim, "heads": a.heads, "head_dim": dim // a.heads,
            "mlp_dim": blocks[0].mlp.fc1.weight.shape[0],
            "win_size": a.win, "shift": attn["shifted"].shift,
            "depth": len(blocks), "blocks": [b.kind for b in blocks],
            "rpe": {"global": attn["global"].rpe.shape[1],
                    "window": attn["window"].rpe.shape[1]},
            # the program's blocks hold no dropout layer
            "dropout": 0.0, "camera_height": CAMERA_HEIGHT,
            "loss": lgt.LOSS_WEIGHTS}


def check_config(config, model):
    """Refuse ``config`` where an ARCH key is missing or differs from what
    the program (``model``) or the reference builds."""
    built = {"program": program_spec(model),
             "reference": ref_lgt.spec(config["input_width"])}
    for key in ARCH:
        v = config.get(key)
        for who, spec in built.items():
            if json.dumps(v, sort_keys=True) != json.dumps(spec[key],
                                                           sort_keys=True):
                raise SystemExit(
                    f"configuration {config.get('name')!r} states {key} = "
                    f"{v!r}; the {who} builds {spec[key]!r}")


class Driver(train.Driver):
    #: the program's compute dtype
    dtype = torch.bfloat16

    def build_batch(self, k):
        """Step k's batch, as the train CLI builds it for LGT-Net."""
        from horizonnet_tpu_torch.data.augment import augment_batch
        from horizonnet_tpu_torch.data.dataset import lgt_labels

        idx, aug_seed = self.plan(k)
        with self.spans("batch_build"):
            x, aug_cors, _ = augment_batch(
                self.imgs[idx], [self.cors[i] for i in idx],
                np.random.default_rng(aug_seed), self.H, self.W,
                wire="uint8", device=self.device, flip=True, rotate=True,
                gamma=True, stretch=True)
            return (x, *lgt_labels(aug_cors, self.H, self.W))

    def setup(self):
        from horizonnet_tpu_torch.models import build_model
        from horizonnet_tpu_torch.train.engine import TrainEngine
        from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
        from horizonnet_tpu_torch.train.step import (create_train_state,
                                                     make_optimizer)

        H, W, r = self.H, self.W, self.recipe
        # the model first: a program without LGT-Net fails here, at once
        model = build_model(self.cell.config["backbone"], device=self.device,
                            dtype=self.dtype, param_dtype=torch.float32,
                            arch="lgt", W=W)
        check_config(self.cell.config, model)
        self._plans = []
        self.imgs, self.cors = train.make_rooms(self.seed, self.n_rooms, H,
                                                W)
        self.state_dict = seeded_weights(self.cell.config, self.seed,
                                         self.device)
        model.load_state_dict(self.state_dict)
        tx = make_optimizer(r["optim"], warmup_poly_schedule(
            r["lr"], max_iters=r["warmup_poly_iters"]), lr=r["lr"],
            beta1=r["beta1"], weight_decay=r["weight_decay"])
        self.state = create_train_state(model, tx)
        self.engine = TrainEngine(model, self.state, self.B, H, W,
                                  device=self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self.pool = ThreadPoolExecutor(self.workers)
        self.feed = self.batches(0)
        # the checked steps, through the window's own call and feed
        self.losses = []
        for k in range(self.checked):
            x, y_depth, y_ratio = next(self.feed)
            with self.spans("step"):
                m = self.engine.step(x, y_depth, y_ratio, self.gen)
            self.losses.append(float(m["total"]))
            if k == 0:
                b1 = r["beta1"]
                self.grad1 = {n: (t / (1.0 - b1)).cpu() for n, t in
                              self.state.opt.moments["mu"].items()}
        self.params3 = {n: p.detach().to("cpu", copy=True) for n, p in
                        self.state.opt.params.items()}

    def judge(self):
        from harness import judge_lgt_train

        return judge_lgt_train.compare(
            self, judge_lgt_train.reference_steps(self))
