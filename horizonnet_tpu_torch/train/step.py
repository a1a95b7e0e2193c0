"""Train step: loss, gradients, optimizer, batch-norm statistics.

Counterpart of horizonnet_tpu/train/step.py (reference train.py:44-58 and
216-223): loss = L1(bon) + BCE-with-logits(cor); Adam or SGD with the
warmup-poly schedule; --freeze_earlier_blocks; batch-norm running
statistics updated by the train-mode forward. Mixed precision is the
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
"""

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


def loss_terms(bon_pred, cor_pred, y_bon, y_cor):
    """L1 boundary loss + BCE-with-logits corner loss (train.py:53-56),
    the latter as max(x, 0) - x y + log1p(exp(-|x|))."""
    bon_loss = (bon_pred - y_bon).abs().mean()
    x = cor_pred
    cor_loss = (x.clamp(min=0) - x * y_cor
                + torch.log1p(torch.exp(-x.abs()))).mean()
    return bon_loss, cor_loss


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
        return self.schedule(count) if self.schedule is not None else self.lr

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
    """State of one OptimizerSpec over named parameters: ``count`` updates
    taken, Adam's ``mu`` and ``nu`` or SGD's ``trace`` per trainable
    parameter."""

    B2 = 0.999
    EPS = 1e-8

    def __init__(self, spec, params):
        self.spec = spec
        mask = spec.freeze_mask or {}
        self.params = {n: p for n, p in params.items() if mask.get(n, True)}
        self.count = 0
        zeros = lambda: {n: torch.zeros_like(p)  # noqa: E731
                         for n, p in self.params.items()}
        if spec.optim == "Adam":
            self.moments = {"mu": zeros(), "nu": zeros()}
        else:
            self.moments = {"trace": zeros()}

    def to(self, device):
        self.moments = {k: {n: t.to(device) for n, t in m.items()}
                        for k, m in self.moments.items()}
        return self

    @torch.no_grad()
    def step(self):
        """One update from each parameter's ``.grad`` (None counts as
        zero)."""
        spec, f = self.spec, np.float32
        names = list(self.params)
        ps = [self.params[n] for n in names]
        gs = [p.grad if p.grad is not None else torch.zeros_like(p)
              for p in ps]
        if spec.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=spec.weight_decay)
        lr = spec.lr_at(self.count)
        self.count += 1
        if spec.optim == "Adam":
            b1 = spec.beta1
            mu = [self.moments["mu"][n] for n in names]
            nu = [self.moments["nu"][n] for n in names]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, gs, alpha=1.0 - b1)
            torch._foreach_mul_(nu, self.B2)
            torch._foreach_add_(nu, torch._foreach_mul(gs, gs),
                                alpha=1.0 - self.B2)
            bc1 = float(f(1) - f(b1) ** f(self.count))
            bc2 = float(f(1) - f(self.B2) ** f(self.count))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, self.EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        else:
            upd = [self.moments["trace"][n] for n in names]
            torch._foreach_mul_(upd, spec.beta1)
            torch._foreach_add_(upd, gs)
        torch._foreach_add_(ps, upd, alpha=-lr)


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

    def host(self):
        """The state on the host, for train/checkpoint.py: {"step",
        "state_dict", "moments", "spec"} with CPU tensors."""
        return {"step": self.step,
                "state_dict": {k: v.detach().cpu() for k, v in
                               self.model.state_dict().items()},
                "moments": {k: {n: t.cpu() for n, t in m.items()}
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


def train_step(state, x, y_bon, y_cor, generator):
    """One optimization step. x [B, H, W, 3] float in [0, 1]; y_bon
    [B, 2, W]; y_cor [B, 1, W]; ``generator`` draws the dropout masks.
    Returns {"total", "bon", "cor"} as detached tensors (no sync)."""
    model = state.model
    model.train()
    for p in model.parameters():
        p.grad = None
    bon, cor = model(_nchw(x), generator)
    bon_loss, cor_loss = loss_terms(bon, cor, y_bon, y_cor)
    total = bon_loss + cor_loss
    total.backward()
    state.opt.step()
    return {"total": total.detach(), "bon": bon_loss.detach(),
            "cor": cor_loss.detach()}


@torch.no_grad()
def eval_losses(state, x, y_bon, y_cor):
    """Losses of the eval-mode forward (running statistics, no dropout)."""
    model = state.model
    model.eval()
    bon, cor = model(_nchw(x))
    bon_loss, cor_loss = loss_terms(bon, cor, y_bon, y_cor)
    return {"total": bon_loss + cor_loss, "bon": bon_loss, "cor": cor_loss}


def encoder_freeze_mask(names, n_frozen_blocks):
    """{name: trainable} over parameter ``names``: freeze the stem (block
    0: conv1, bn1) and layer1..layerN of the encoder. Mirrors
    --freeze_earlier_blocks (train.py:200-208, model.py:84-91)."""
    prefix = "feature_extractor.encoder."

    def trainable(name):
        if n_frozen_blocks < 0 or not name.startswith(prefix):
            return True
        mod = name[len(prefix):].split(".")[0]
        block = 0 if mod in ("conv1", "bn1") else (
            int(mod[len("layer"):]) if mod.startswith("layer") else None)
        return block is None or block > n_frozen_blocks

    return {n: trainable(n) for n in names}
