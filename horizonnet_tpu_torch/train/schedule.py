"""LR schedule: linear warmup then polynomial decay.

Counterpart of horizonnet_tpu/train/schedule.py (reference
misc/utils.py:35-43): during warmup, lr ramps linearly from warmup_lr to
lr; afterwards lr * (1 - frac)^lr_pow where frac is the progress through
the post-warmup iterations. Computed in float32 as the JAX schedule is.
The optimizer (train/step.py) evaluates it at the number of updates
already taken, as optax does, so the first update uses ``schedule(0)``.

The schedule takes the step as a float32 tensor, as the optimizer holds
its count on the device, and returns a tensor there: a captured train
step (train/engine.py) computes its learning rate on the card, as optax
does inside JAX's compiled step. An int step gives a float.
"""

import numpy as np
import torch


def warmup_poly_schedule(lr, max_iters, warmup_lr=1e-6, warmup_iters=0,
                         lr_pow=0.9):
    f = np.float32
    # the constants in float32, so that every operation below is one
    # float32 operation, in the order of the JAX schedule
    lr32, warm32 = float(f(lr)), float(f(warmup_lr))
    ramp = float(f(lr) - f(warmup_lr))
    n_warm = float(f(max(warmup_iters, 1)))
    start, span = float(f(warmup_iters)), float(f(max(max_iters -
                                                      warmup_iters, 1)))

    def schedule(step):
        if not isinstance(step, torch.Tensor):
            return float(schedule(torch.tensor(float(step),
                                               dtype=torch.float32)))
        warm = step * ramp / n_warm + warm32
        frac = (step - start) / span
        base = (1.0 - frac).clamp(min=0.0)
        # a float32 exponent tensor: pow(float, float), as numpy's float32
        # power (a Python float exponent takes another path on the CPU)
        poly = torch.pow(base, torch.full_like(base, lr_pow)) * lr32
        return torch.where(step < warmup_iters, warm, poly)
    return schedule
