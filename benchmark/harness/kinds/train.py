"""Training by the published recipe: the train CLI's data path and step.

Traffic parameters: ``rooms`` (synthetic uint8 rooms made from the seed,
reference/rooms.py), ``prefetch_workers`` (the CLI's --num_workers),
``checked_steps`` (the steps the judge follows), ``trace_seconds``. The
batch, optimizer and schedule are the configuration's ``train``.

Each step draws its batch's rooms and an augmentation generator from the
seed, and a prefetch thread builds it the way the CLI's
``make_training_batch`` does: the program's ``augment_batch`` (uint8
upload, the warp on the card), then its host labels (``cor_2_1d``, the
corner heat map without occluded corners). ``TrainEngine.step`` runs the
captured step with a dropout generator seeded from the seed. Set-up runs
the first ``checked_steps`` steps through that same call and feed, and
keeps what the judge reads: their losses, the first gradient as Adam's
first moment holds it after step 1, and the parameters after the last.

``train_panos_per_s``: the panos of every step queued in the window,
over the seconds from the first step to the last step's losses on the
host.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from harness.weights import seeded_weights
from reference import rooms as ref_rooms


def make_rooms(seed, n, H, W, workers=8):
    """``n`` synthetic rooms, each from its own generator spawned from the
    seed (so threads may make them in any order)."""
    seqs = np.random.SeedSequence(seed).spawn(n)
    with ThreadPoolExecutor(workers) as pool:
        rooms = list(pool.map(lambda s: ref_rooms.synth_room(
            np.random.default_rng(s), H, W), seqs))
    return np.stack([r[0] for r in rooms]), [r[1] for r in rooms]


class Driver:
    def __init__(self, cell, seed, device, spans):
        self.cell, self.seed, self.device = cell, seed, device
        self.spans = spans
        c, t = cell.config, cell.traffic
        self.H, self.W = c["input_height"], c["input_width"]
        self.recipe = c["train"]
        self.B = self.recipe["batch_size"]
        self.n_rooms = t["rooms"]
        self.workers = t["prefetch_workers"]
        self.checked = t["checked_steps"]
        self.order = np.random.default_rng(seed)

    # the batches -----------------------------------------------------

    def plan(self, k):
        """(room indices, augmentation seed) of step k."""
        while len(self._plans) <= k:
            self._plans.append(self.order.choice(self.n_rooms, self.B,
                                                 replace=False))
        return self._plans[k], [self.seed, k]

    def build_batch(self, k):
        """Step k's batch, as the train CLI builds it."""
        from horizonnet_tpu_torch.data.augment import augment_batch
        from horizonnet_tpu_torch.data.labels import corner_heatmap
        from horizonnet_tpu_torch.geometry.lines import cor_2_1d

        idx, aug_seed = self.plan(k)
        with self.spans("batch_build"):
            x, aug_cors, _ = augment_batch(
                self.imgs[idx], [self.cors[i] for i in idx],
                np.random.default_rng(aug_seed), self.H, self.W,
                wire="uint8", device=self.device, flip=True, rotate=True,
                gamma=True, stretch=True)
            bons = np.stack([cor_2_1d(c, self.H, self.W)
                             for c in aug_cors]).astype(np.float32)
            y_cors = np.stack([
                corner_heatmap(c[~self.occ[i], 0], self.W)[None]
                for c, i in zip(aug_cors, idx)])
        return x, bons, y_cors

    def batches(self, start):
        """Batches from step ``start`` on, one built ahead on the prefetch
        pool while the current one trains (the CLI's loop)."""
        k = start
        nxt = self.pool.submit(self.build_batch, k)
        while True:
            batch = nxt.result()
            k += 1
            nxt = self.pool.submit(self.build_batch, k)
            yield batch

    # the cell ----------------------------------------------------------

    def setup(self):
        from horizonnet_tpu_torch.data.labels import find_occlusion
        from horizonnet_tpu_torch.models import build_model
        from horizonnet_tpu_torch.train.engine import TrainEngine
        from horizonnet_tpu_torch.train.schedule import warmup_poly_schedule
        from horizonnet_tpu_torch.train.step import (create_train_state,
                                                     make_optimizer)

        H, W, r = self.H, self.W, self.recipe
        self._plans = []
        self.imgs, self.cors = make_rooms(self.seed, self.n_rooms, H, W)
        self.occ = [find_occlusion(c[::2].copy(), W, H).repeat(2)
                    for c in self.cors]
        self.state_dict = seeded_weights(self.cell.config, self.seed,
                                         self.device)
        model = build_model(self.cell.config["backbone"], True,
                            device=self.device, dtype=torch.bfloat16,
                            lstm_impl="kernel_train",
                            param_dtype=torch.float32)
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
            x, y_bon, y_cor = next(self.feed)
            with self.spans("step"):
                m = self.engine.step(x, y_bon, y_cor, self.gen)
            self.losses.append(float(m["total"]))
            if k == 0:
                b1 = r["beta1"]
                self.grad1 = {n: (t / (1.0 - b1)).cpu() for n, t in
                              self.state.opt.moments["mu"].items()}
        self.params3 = {n: p.detach().to("cpu", copy=True) for n, p in
                        self.state.opt.params.items()}

    def window(self, seconds):
        metrics = []
        self.t0 = time.perf_counter_ns()
        close = self.t0 + int(seconds * 1e9)
        while not metrics or time.perf_counter_ns() < close:
            x, y_bon, y_cor = next(self.feed)
            with self.spans("step"):
                metrics.append(self.engine.step(x, y_bon, y_cor, self.gen))
        losses = torch.stack([m["total"] for m in metrics]).cpu()
        self.t1 = time.perf_counter_ns()
        self.steps = len(metrics)
        self.attempted = self.panos = self.steps * self.B
        self.failed = int((~torch.isfinite(losses)).sum()) * self.B
        return {"train_panos_per_s":
                self.attempted / ((self.t1 - self.t0) / 1e9)}

    def release(self):
        """Stop the prefetch pool and free the program's state."""
        self.feed.close()
        self.pool.shutdown(wait=True)
        self.engine = self.state = None
        torch.cuda.empty_cache()

    def judge(self):
        from harness import judge_train

        return judge_train.compare(self, judge_train.reference_steps(self))
