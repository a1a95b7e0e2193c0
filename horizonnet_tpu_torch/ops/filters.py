"""Circular windowed max and corner-peak finding.

Counterpart of horizonnet_tpu/ops/filters.py: the device windowed max and
the fixed-size peak list in PyTorch, and a copy of the host
``find_peaks_np`` (reference inference.py:21-29) that needs only numpy.
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


def find_peaks_device(signal, r=29, min_v=0.05, max_peaks=32):
    """Peak finder with a static output shape, batched over ``signal
    [..., W]``. Returns (locs [..., max_peaks] int32, vals, valid bool),
    sorted by location, invalid slots padded with loc -1 and value 0.
    When more than max_peaks peaks exist the highest win, equal values
    by the lower column (lax.top_k's rule, here a stable descending
    sort). Caller: the general-layout serving fit
    (postproc/device.py::postprocess_general_batch)."""
    n = signal.shape[-1]
    max_v = circular_max_filter_1d(signal, r)
    is_peak = (max_v == signal) & (signal > min_v)
    neg = torch.where(is_peak, signal, -torch.inf)
    vals, locs = torch.sort(neg, dim=-1, descending=True, stable=True)
    vals, locs = vals[..., :max_peaks], locs[..., :max_peaks]
    valid = torch.isfinite(vals)
    locs = torch.where(valid, locs, n + 1)       # invalid slots sort last
    order = torch.argsort(locs, dim=-1, stable=True)
    locs, vals, valid = (a.gather(-1, order) for a in (locs, vals, valid))
    locs = torch.where(valid, locs, -1)
    vals = torch.where(valid, vals, 0.0)
    return locs.to(torch.int32), vals, valid
