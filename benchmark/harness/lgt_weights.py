"""Seeded weights for the LGT-Net configuration, made on the device.

As harness/weights.py does for HorizonNet: one ``torch.Generator`` on the
device, seeded from ``--seed``, makes three normal draws, one for every
convolution and linear weight (scaled lecun-normal, std sqrt(1 /
fan_in)), one for the batch and layer norms (gamma 1 + 0.05 z, beta and
a running mean 0.05 z, a running variance 1 + 0.1 |z|), one for the
relative-position tables (``weights.rpe_std`` z: small, but not nought,
so that a program that drops or misreads a table departs from the
reference).
Other biases are nought. Every value is rounded to bfloat16, so the
program's bf16 products see exactly the float32 reference's weights.
Gamma of each bottleneck's last batch norm is then scaled by the
configuration's ``weights.residual_bn_gain``, as for HorizonNet (at 1 a
train-mode forward of seeded weights is chaotic). The depth and ratio
heads are lecun-normal like every other linear: their outputs straddle
the labels, so the L1 terms' gradients depend on every label's side.

The keys are reference/lgt.py's, which are the program's.
"""

import math

import torch
import torch.nn as nn

from reference.lgt import LGTNet


def _groups(W):
    """(normal, norm, table, zero) lists of (key, shape)."""
    with torch.device("meta"):
        m = LGTNet(W)
    norms = {n for n, mod in m.named_modules()
             if isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm))}
    normal, norm, table, zero = [], [], [], []
    for k, v in m.state_dict().items():
        s = tuple(v.shape)
        owner, leaf = k.rsplit(".", 1)
        if owner in norms:
            (zero if leaf == "num_batches_tracked" else norm).append((k, s))
        elif leaf == "rpe":
            table.append((k, s))
        elif len(s) >= 2:
            normal.append((k, s))
        else:
            zero.append((k, s))
    return normal, norm, table, zero


def _slices(flat, group):
    o = 0
    for k, s in group:
        c = math.prod(s)
        yield k, s, flat[o:o + c].view(s)
        o += c


def seeded_weights(config, seed, device):
    """{key: float32 tensor on ``device``} of the configuration's seeded
    LGT-Net, the same for the same ``seed``."""
    W = config["input_width"]
    normal, norm, table, zero = _groups(W)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    size = lambda g: sum(math.prod(s) for _, s in g)  # noqa: E731
    zn = torch.randn(size(normal), generator=gen, device=device)
    zb = torch.randn(size(norm), generator=gen, device=device)
    zt = torch.randn(size(table), generator=gen, device=device)
    sd = {}
    for k, s, z in _slices(zn, normal):
        sd[k] = z * math.sqrt(1.0 / math.prod(s[1:]))
    for k, s, z in _slices(zb, norm):
        leaf = k.rsplit(".", 1)[1]
        sd[k] = {"weight": 1.0 + 0.05 * z, "bias": 0.05 * z,
                 "running_mean": 0.05 * z,
                 "running_var": 1.0 + 0.1 * z.abs()}[leaf]
    shape = config["weights"]
    for k, s, z in _slices(zt, table):
        sd[k] = shape["rpe_std"] * z
    for k, s in zero:
        sd[k] = torch.zeros(s, device=device,
                            dtype=(torch.long if k.endswith("tracked")
                                   else torch.float32))
    gain = shape.get("residual_bn_gain", 1.0)
    for k in sd:
        if k.endswith(".bn3.weight"):
            sd[k] = sd[k] * gain
    return {k: (v.to(torch.bfloat16).float() if v.is_floating_point()
                else v) for k, v in sd.items()}
