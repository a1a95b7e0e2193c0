"""The training step of the recipe, in plain float32: the reference.

HorizonNet's train.py: loss = L1 on the boundaries + binary cross-entropy
with logits on the corner map (both means over the batch), Adam (b1 0.9,
b2 0.999, eps 1e-8) with the warmup-poly learning rate of misc/utils.py
(lr (1 - n / max_iters)^0.9 after the warm-up, evaluated at the updates
already taken), batch norm on the batch's statistics, dropout 0.5 after
each LSTM layer. The forward is reference/model.py in train mode with
its masks drawn from a ``torch.Generator``.

The configuration trains one LSTM bias a gate (``lstm_bias: folded``):
the published nn.LSTM trains b_ih and b_hh apart, which moves their sum
twice as far a step. So ``bias_hh`` is held at zero and left out.
"""

import torch


def loss_terms(bon_pred, cor_pred, y_bon, y_cor):
    """(L1 boundary loss, BCE-with-logits corner loss), means over all."""
    bon_loss = (bon_pred - y_bon).abs().mean()
    x = cor_pred
    cor_loss = (x.clamp(min=0) - x * y_cor
                + torch.log1p(torch.exp(-x.abs()))).mean()
    return bon_loss, cor_loss


def warmup_poly(lr, max_iters, warmup_lr=1e-6, warmup_iters=0, power=0.9):
    """The learning rate after ``n`` updates (misc/utils.py)."""
    def at(n):
        if n < warmup_iters:
            return warmup_lr + n * (lr - warmup_lr) / max(warmup_iters, 1)
        frac = (n - warmup_iters) / max(max_iters - warmup_iters, 1)
        return lr * max(1.0 - frac, 0.0) ** power
    return at


class Adam:
    """Adam over named float32 tensors, as torch.optim.Adam computes it:
    p -= lr(n) * (mu / (1 - b1^(n+1))) / (sqrt(nu / (1 - b2^(n+1))) + eps)
    at the n-th update, n from 0."""

    def __init__(self, params, schedule, b1=0.9, b2=0.999, eps=1e-8):
        self.params = params
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.n = 0

    @torch.no_grad()
    def step(self, grads):
        b1, b2, n = self.b1, self.b2, self.n
        lr = self.schedule(n)
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.mu[k] / (1 - b1 ** (n + 1))
            vhat = self.nu[k] / (1 - b2 ** (n + 1))
            p.sub_(lr * mhat / (vhat.sqrt() + self.eps))
        self.n += 1


def trained_params(net):
    """{name: parameter} that the recipe trains (every parameter but the
    LSTM's ``bias_hh``)."""
    out = {}
    for k, p in net.named_parameters():
        if ".bias_hh_" in k:
            p.requires_grad_(False)
            continue
        out[k] = p
    return out


def step(net, opt, x, y_bon, y_cor, generator):
    """One train step on x [B, 3, H, W] in [0, 1] -> (total loss, the
    gradients {name: tensor} the optimizer took)."""
    net.train()
    for p in opt.params.values():
        p.grad = None
    bon, cor = net(x, generator)
    bon_loss, cor_loss = loss_terms(bon, cor, y_bon, y_cor)
    total = bon_loss + cor_loss
    total.backward()
    grads = {k: p.grad.detach().clone() for k, p in opt.params.items()}
    opt.step(grads)
    return float(total.detach()), grads
