"""Seeded weights for a configuration, made on the device in a few calls.

One ``torch.Generator`` on the device, seeded from ``--seed``, makes
three draws: a normal one for every convolution and linear weight, a
uniform one for the LSTM's weights and input biases, a normal one for the
batch norms. Each slice is then scaled: convolutions and linears
lecun-normal (std sqrt(1 / fan_in)), the LSTM U(-1/sqrt(H), 1/sqrt(H)) as
torch initializes it, batch norm near the identity (gamma 1 + 0.05 z,
beta and mean 0.05 z, variance 1 + 0.1 |z|), other biases zero and the
head's bias the published prior (cor -1, ceiling -0.478, floor 0.425).
Every value is rounded to bfloat16, so the program's bf16 weights hold
exactly what the float32 reference holds: the two differ only in how
they compute. ``bias_hh`` is zero, so that folding it into ``bias_ih``
rounds nothing.

The keys are the published checkpoints' (reference/model.py).

``seeded_weights`` then shapes them as the configuration's ``weights``
says, as a trained network's are shaped (below).
"""

import math

import torch
import torch.nn as nn

from reference.model import RNN_HIDDEN, HorizonNet


def _groups():
    """(normal, uniform, batch norm, zero) lists of (key, shape)."""
    with torch.device("meta"):
        m = HorizonNet()
    bn = {n for n, mod in m.named_modules()
          if isinstance(mod, nn.BatchNorm2d)}
    normal, uniform, norm, zero = [], [], [], []
    for k, v in m.state_dict().items():
        s = tuple(v.shape)
        owner, leaf = k.rsplit(".", 1)
        if owner in bn:
            (zero if leaf == "num_batches_tracked" else norm).append((k, s))
        elif owner == "bi_rnn":
            (zero if leaf.startswith("bias_hh") else uniform).append((k, s))
        elif len(s) >= 2:
            normal.append((k, s))
        else:
            zero.append((k, s))
    return normal, uniform, norm, zero


def _slices(flat, group):
    o = 0
    for k, s in group:
        c = math.prod(s)
        yield k, s, flat[o:o + c].view(s)
        o += c


def make_state_dict(seed, device):
    """{key: float32 tensor on ``device``} of the reference's keys, the
    same for the same ``seed``."""
    normal, uniform, norm, zero = _groups()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    size = lambda g: sum(math.prod(s) for _, s in g)  # noqa: E731
    zn = torch.randn(size(normal), generator=gen, device=device)
    zu = torch.rand(size(uniform), generator=gen, device=device)
    zb = torch.randn(size(norm), generator=gen, device=device)
    sd = {}
    for k, s, z in _slices(zn, normal):
        sd[k] = z * math.sqrt(1.0 / math.prod(s[1:]))
    bound = 1.0 / math.sqrt(RNN_HIDDEN)
    for k, s, z in _slices(zu, uniform):
        sd[k] = (2.0 * z - 1.0) * bound
    for k, s, z in _slices(zb, norm):
        leaf = k.rsplit(".", 1)[1]
        sd[k] = {"weight": 1.0 + 0.05 * z, "bias": 0.05 * z,
                 "running_mean": 0.05 * z,
                 "running_var": 1.0 + 0.1 * z.abs()}[leaf]
    for k, s in zero:
        sd[k] = torch.zeros(s, device=device,
                            dtype=(torch.long if k.endswith("tracked")
                                   else torch.float32))
    bias = torch.zeros(12, device=device)
    bias[0:4], bias[4:8], bias[8:12] = -1.0, -0.478, 0.425
    sd["linear.bias"] = bias
    return {k: (v.to(torch.bfloat16).float() if v.is_floating_point()
                else v) for k, v in sd.items()}


def seeded_weights(config, seed, device):
    """The configuration's seeded state_dict. ``weights.head``: each of
    the head's three groups of 4 rows (corner, ceiling, floor; a row for
    each of a step's 4 columns) becomes ``scale`` times the group's first
    row plus ``spread`` times its own, so that a group's output varies
    smoothly from step to step and a little between a step's columns (at
    lecun scale the corner logits lie within 0.05 of the prior and bf16
    ties or each column's own row decide every peak).
    ``weights.residual_bn_gain`` scales gamma of the last batch norm of
    every bottleneck branch, as training leaves it small (at 1, a
    train-mode forward of seeded weights is chaotic: a bf16 rounding grows
    to half the output through the 16 blocks)."""
    sd = make_state_dict(seed, device)
    shape = config["weights"]
    w = sd["linear.weight"]
    for g, name in enumerate(("cor", "ceiling", "floor")):
        scale, spread = shape["head"][name]
        rows = w[4 * g:4 * g + 4]
        rows.copy_(scale * rows[:1] + spread * rows)
    gain = shape.get("residual_bn_gain", 1.0)
    for k in sd:
        if k.endswith(".bn3.weight"):
            sd[k] = sd[k] * gain
    return {k: (v.to(torch.bfloat16).float() if v.is_floating_point()
                else v) for k, v in sd.items()}
