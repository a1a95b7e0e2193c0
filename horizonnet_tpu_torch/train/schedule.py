"""LR schedule: linear warmup then polynomial decay.

Counterpart of horizonnet_tpu/train/schedule.py (reference
misc/utils.py:35-43): during warmup, lr ramps linearly from warmup_lr to
lr; afterwards lr * (1 - frac)^lr_pow where frac is the progress through
the post-warmup iterations. Computed in float32 as the JAX schedule is.
The optimizer (train/step.py) evaluates it at the number of updates
already taken, as optax does, so the first update uses ``schedule(0)``.
"""

import numpy as np


def warmup_poly_schedule(lr, max_iters, warmup_lr=1e-6, warmup_iters=0,
                         lr_pow=0.9):
    f = np.float32

    def schedule(step):
        step = f(step)
        if step < warmup_iters:
            return float(f(warmup_lr) + (f(lr) - f(warmup_lr)) * step
                         / f(max(warmup_iters, 1)))
        frac = (step - f(warmup_iters)) / f(max(max_iters - warmup_iters, 1))
        return float(f(lr) * np.maximum(f(1.0) - frac, f(0.0)) ** f(lr_pow))
    return schedule
