"""Train step: loss, gradients, optimizer, batch-norm statistics.

Counterpart of horizonnet_tpu/train/step.py (reference train.py:44-58 and
216-223): the model's loss (``model.losses``: HorizonNet's L1(bon) +
BCE-with-logits(cor), models/horizonnet.py::loss_terms; LGT-Net's in
models/lgt.py); Adam or SGD with the warmup-poly schedule;
--freeze_earlier_blocks; batch-norm running statistics updated by the
train-mode forward. Mixed precision is the
model's: bf16 compute with f32 parameters (models/horizonnet.py), f32
loss, no loss scaling (bf16 has f32's exponent range).

The optimizer is optax's update rule written out over named tensors, so
that a step here and a step of the JAX package agree and its state maps
onto optax's (train/checkpoint.py writes it in optax's layout):
  add_decayed_weights   g += weight_decay * p        (before the optimizer)
  adam                  mu = b1 mu + (1-b1) g, nu = b2 nu + (1-b2) g^2,
                        u = mu/(1-b1^n) / (sqrt(nu/(1-b2^n)) + eps)
  sgd                   trace = g + beta1 trace, u = trace
  learning rate         p -= schedule(n - 1) u, n = updates taken so far
                        after this one (optax evaluates the schedule before
                        its count increments)
Frozen parameters (a freeze mask) are left out of the optimizer and take
no gradient, where optax zeroes their updates: they never move either way.
As in optax inside JAX's compiled step, the count is a tensor on the
parameters' device, and the learning rate and Adam's bias corrections are
computed from it there in float32, so that a CUDA graph of the step
(train/engine.py) moves them at every replay.
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..utils import profiling

@dataclass(frozen=True)
class OptimizerSpec:
    """What make_optimizer chose; ``init`` binds it to parameters."""

    optim: str
    schedule: Optional[Callable[[int], float]]
    lr: float
    beta1: float
    weight_decay: float
    freeze_mask: Optional[dict]

    def lr_at(self, count):
        """The learning rate after ``count`` updates, a float32 tensor
        like ``count`` (schedules take tensors: train/schedule.py)."""
        if self.schedule is None:
            return torch.full_like(count, self.lr)
        return self.schedule(count)

    def init(self, params):
        """``params``: {name: tensor}. -> Optimizer over the trainable
        ones."""
        return Optimizer(self, params)


def make_optimizer(optim="Adam", schedule=None, lr=1e-4, beta1=0.9,
                   weight_decay=0.0, freeze_mask=None):
    """Adam (b1=beta1, b2=0.999, eps=1e-8) or SGD (momentum=beta1), as
    the reference's optimizer surface (train.py:216-223).

    freeze_mask: optional {name: bool} (True = trainable), the
    --freeze_earlier_blocks mask of encoder_freeze_mask.
    """
    if optim not in ("Adam", "SGD"):
        raise NotImplementedError(optim)
    return OptimizerSpec(optim, schedule, lr, beta1, weight_decay,
                         freeze_mask)


class Optimizer:
    """State of one OptimizerSpec over named parameters: the number of
    updates taken (``count``; an int32 tensor on the parameters' device,
    ``count_t``), Adam's ``mu`` and ``nu`` or SGD's ``trace`` per trainable
    parameter."""

    B2 = 0.999
    EPS = 1e-8

    def __init__(self, spec, params):
        self.spec = spec
        mask = spec.freeze_mask or {}
        self.params = {n: p for n, p in params.items() if mask.get(n, True)}
        device = next(iter(params.values())).device if params else None
        self.count_t = torch.zeros((), dtype=torch.int32, device=device)
        zeros = lambda: {n: torch.zeros_like(p)  # noqa: E731
                         for n, p in self.params.items()}
        if spec.optim == "Adam":
            self.moments = {"mu": zeros(), "nu": zeros()}
        else:
            self.moments = {"trace": zeros()}

    @property
    def count(self):
        """Updates taken, as an int (on the card: waits for the step)."""
        return int(self.count_t)

    @count.setter
    def count(self, n):
        self.count_t.fill_(int(n))

    def state_tensors(self):
        """Every tensor that a step writes: the count and the moments."""
        return [self.count_t] + [t for m in self.moments.values()
                                 for t in m.values()]

    def to(self, device):
        self.count_t = self.count_t.to(device)
        self.moments = {k: {n: t.to(device) for n, t in m.items()}
                        for k, m in self.moments.items()}
        return self

    @torch.no_grad()
    def step(self):
        """One update from each parameter's ``.grad`` (None counts as
        zero). Waits for nothing: the count, the learning rate and the
        bias corrections stay on the device."""
        spec = self.spec
        names = list(self.params)
        ps = [self.params[n] for n in names]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in ps]
        if spec.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=spec.weight_decay)
        c = self.count_t.float()
        neg_lr = -spec.lr_at(c)
        self.count_t.add_(1)
        if spec.optim == "Adam":
            b1 = spec.beta1
            mu = [self.moments["mu"][n] for n in names]
            nu = [self.moments["nu"][n] for n in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, gs, alpha=1.0 - b1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_add_(nu, torch._foreach_mul(gs, gs),
                                alpha=1.0 - self.B2)
            bc1 = 1.0 - torch.pow(b1, c + 1.0)
            bc2 = 1.0 - torch.pow(self.B2, c + 1.0)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, self.EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        else:
            upd = [self.moments["trace"][n] for n in names]
            torch._foreach_mul_(upd, spec.beta1)
            torch._foreach_add_(upd, gs)
        # p + u * (-lr) in one rounding, as an add with alpha=-lr does
        torch._foreach_addcmul_(ps, upd, [neg_lr] * len(ps))


class TrainState:
    """The model (parameters and batch statistics live in it) and its
    optimizer state; ``step`` is the number of updates taken."""

    def __init__(self, model, opt):
        self.model = model
        self.opt = opt

    @property
    def step(self):
        return self.opt.count

    def to(self, device):
        self.model.to(device)
        self.opt.to(device)
        return self

    def host(self, full=dict):
        """The state on the host, for train/checkpoint.py: {"step",
        "state_dict", "moments", "spec"} with CPU tensors. ``full`` maps
        {name: tensor} on the device to the whole tensors (under tensor
        parallelism train/engine.py gathers the channel shards)."""
        sd = full({k: v.detach() for k, v in
                   self.model.state_dict().items()})
        return {"step": self.step,
                "state_dict": {k: v.cpu() for k, v in sd.items()},
                "moments": {k: {n: t.cpu() for n, t in full(m).items()}
                            for k, m in self.opt.moments.items()},
                "spec": self.opt.spec}


def create_train_state(model, tx):
    """Bind the optimizer ``tx`` (make_optimizer) to ``model``'s
    parameters. Frozen parameters stop taking gradients."""
    params = dict(model.named_parameters())
    mask = tx.freeze_mask or {}
    for n, p in params.items():
        p.requires_grad_(mask.get(n, True))
    return TrainState(model, tx.init(params))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def train_step(state, x, *args, net=None, batch_shard=None):
    """One optimization step: ``train_step(state, x, *targets,
    generator)``. x [B, H, W, 3] float in [0, 1]; the targets in the
    model's ``TARGETS`` order (HorizonNet: y_bon [B, 2, W], y_cor
    [B, 1, W]; LGT-Net: y_depth [B, W/4], y_ratio [B, 1]); ``generator``
    draws the dropout masks. Returns {"total", and each loss term} as
    detached tensors (no sync).

    Under a mesh (train/engine.py) ``net`` is the DistributedDataParallel
    wrapper of ``state.model``, the batch is this rank's rows
    ``batch_shard`` of the global batch, and the losses are this rank's
    means. A model with ``TRAIN_STAGES`` (LGT-Net) has the step mark the
    device stages ``encoder_bwd`` after the backward pass and ``optim``
    after the update; the model marks the others."""
    *targets, generator = args
    model = state.model
    model.train()
    for p in model.parameters():
        p.grad = None
    outputs = (model if net is None else net)(_nchw(x), generator,
                                              batch_shard)
    losses = model.losses(outputs, targets)
    losses["total"].backward()
    if model.TRAIN_STAGES:
        profiling.mark("encoder_bwd")
    state.opt.step()
    if model.TRAIN_STAGES:
        profiling.mark("optim")
    return {k: v.detach() for k, v in losses.items()}


@torch.no_grad()
def eval_losses(state, x, *targets):
    """Losses of the eval-mode forward (running statistics, no dropout):
    ``eval_losses(state, x, *targets)`` -> {"total", and each term}."""
    model = state.model
    model.eval()
    return model.losses(model(_nchw(x)), targets)


def encoder_freeze_mask(names, n_frozen_blocks):
    """{name: trainable} over parameter ``names``: freeze the encoder's
    blocks 0..N. Mirrors --freeze_earlier_blocks (train.py:200-208,
    model.py:84-91) with the JAX package's block map
    (horizonnet_tpu/train/step.py:108-125): the stem (conv1, bn1; densenet
    conv0, norm0) is block 0, layerN / denseblockN and transitionN are
    block N, densenet's norm5 is block 4."""
    prefix = "feature_extractor.encoder."

    def block_of(mod):
        if mod in ("conv1", "bn1", "conv0", "norm0"):
            return 0
        for i in range(1, 5):
            if mod.startswith((f"layer{i}", f"denseblock{i}",
                               f"transition{i}")):
                return i
        return 4 if mod == "norm5" else None

    def trainable(name):
        if n_frozen_blocks < 0 or not name.startswith(prefix):
            return True
        parts = name[len(prefix):].split(".")
        block = block_of(parts[1] if parts[0] == "features" else parts[0])
        return block is None or block > n_frozen_blocks

    return {n: trainable(n) for n in names}
