"""Circular windowed max and corner-peak finding.

Counterpart of horizonnet_tpu/ops/filters.py: the device windowed max in
PyTorch, and a copy of the host ``find_peaks_np`` (reference
inference.py:21-29) that needs only numpy.
"""

import numpy as np
import torch


def circular_max_filter_1d(signal, size):
    """Windowed max with circular boundary over the last axis, as scipy
    maximum_filter(size=size, mode='wrap'): window [i - size//2,
    i + (size-1)//2]."""
    left = size // 2
    n = signal.shape[-1]
    offs = torch.arange(-left, size - left, device=signal.device)
    idx = (torch.arange(n, device=signal.device)[:, None] + offs) % n
    return signal[..., idx].amax(dim=-1)


def find_peaks_np(signal, r=29, min_v=0.05, N=None):
    """Host peak finder, the reference's find_N_peaks.

    Returns (peak_locations, peak_values). Ref: inference.py:21-29.
    """
    signal = np.asarray(signal)
    n = len(signal)
    left = r // 2
    right = r - 1 - left
    idx = (np.arange(n)[:, None] + np.arange(-left, right + 1)[None, :]) % n
    max_v = signal[idx].max(1)
    pk_loc = np.where(max_v == signal)[0]
    pk_loc = pk_loc[signal[pk_loc] > min_v]
    if N is not None:
        order = np.argsort(-signal[pk_loc])
        pk_loc = pk_loc[order[:N]]
        pk_loc = pk_loc[np.argsort(pk_loc)]
    return pk_loc, signal[pk_loc]
