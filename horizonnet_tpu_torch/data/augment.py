"""Batched augmentation on the device: stretch + flip + roll + gamma.

Counterpart of horizonnet_tpu/data/augment.py. The reference runs scipy
map_coordinates per channel per sample in DataLoader workers
(dataset.py:69-105, panostretch.py:99-102); here the three geometric
augmentations compose into one warp field per sample, so each output
pixel is one 4-tap gather (ops/resample.py) and one pow, batched over the
device batch.

Composition (output -> source): roll by dx, then flip, then stretch:
  c1 = (j - dx) mod W ; c2 = W-1-c1 if flip ; (y, x) = stretch_grid(c2, i).

Labels (bon, y_cor, corners) are made on the host from the analytically
transformed corners (data/labels.py). ``sample_aug_params`` draws from
the host numpy RNG in the JAX package's order, so one seed gives the same
parameters in both packages.

The upload on a CUDA device (``augment_batch``): the pixels (uint8, or
the packed dct / dct4 wire) and the five parameter vectors, as one
float64 array, are staged in pinned host memory (PyTorch's caching
pinned allocator, which reuses a block only once its copy has left it,
so concurrent callers never share one) and copied with
``non_blocking=True`` on a copy stream of the card, where the decode and
the warp follow. The caller's current stream waits for the warp by an
event, and the output is marked as in use on it (``record_stream``), so
the call neither queues behind, nor waits on the host for, the work in
flight on the caller's stream: a train step there runs while the next
batch uploads, warps and has its labels made on the host. Where the card
is the slower side, callers run ahead of it only so far: a call first
waits on the host until the caller's stream has reached the hand-over of
the batch ``RUN_AHEAD`` calls back (the span ``augment.runahead_wait``).
Unbounded, the host would fill the card's launch queue, and every CUDA
call of every thread (this upload's first copy, the train step's graph
launch) would block until the card drained it. The host counter
``augment.stream_uploads`` (ops/launch_counts.py) counts the batches that
took this path. On the CPU the upload and the warp are plain tensor
operations on the caller's thread.
"""

import collections
import itertools
import math
import threading

import numpy as np
import torch

from ..ops import dct as _dct
from ..ops import launch_counts
from ..ops.resample import bilinear_wrap_sample
from ..utils import profiling
from .labels import cor2xybound, stretched_corners

#: numbers augment_batch's batches, the request ids of their spans
_batches = itertools.count()

#: batches uploaded and warped on a card's copy stream, in this process
stream_uploads = 0
launch_counts.register(__name__, "stream_uploads", host=True)

#: batches a card's callers may hand over before a call waits for the
#: oldest to be reached on its caller's stream
RUN_AHEAD = 2

#: each card's state (_Card), made at its first batch; the lock guards it
#: and ``stream_uploads``
_cards = {}
_lock = threading.Lock()

#: the parameter vectors of augment_images, in its order, with their dtypes
_PARAMS = (("kx", torch.float32), ("ky", torch.float32),
           ("flip", torch.bool), ("dx", torch.int64), ("p", torch.float32))


def stretch_grid(H, W, kx, ky):
    """Source sampling grid of pano-stretch (ref panostretch.py:91-96) for
    per-sample factors kx, ky [B]. Returns (refy [B, H, W], refx [B, W])
    source pixel coordinates, in float32 as the JAX grid."""
    dev = kx.device
    us = ((torch.arange(W, device=dev, dtype=torch.float32) + 0.5) / W
          - 0.5) * (2 * math.pi)
    vs = ((torch.arange(H, device=dev, dtype=torch.float32) + 0.5) / H
          - 0.5) * math.pi
    sin_u, cos_u = torch.sin(us), torch.cos(us)
    tan_v = torch.tan(vs)
    u0 = torch.atan2(sin_u * kx[:, None] / ky[:, None],
                     cos_u.expand(len(kx), W))                       # [B, W]
    ratio = torch.sin(u0) / sin_u * ky[:, None]                      # [B, W]
    v0 = torch.atan(tan_v[None, :, None] * ratio[:, None, :])        # [B,H,W]
    refx = (u0 / (2 * math.pi) + 0.5) * W - 0.5
    refy = (v0 / math.pi + 0.5) * H - 0.5
    return refy, refx


def augment_images(imgs, kx, ky, flip, dx, gamma_p):
    """imgs [B, H, W, 3] float in [0, 1] or uint8 (on the device); per
    sample kx, ky, gamma_p float [B], flip bool [B], dx int [B].
    Returns float32 [B, H, W, 3]."""
    if imgs.dtype == torch.uint8:
        # uint8 crosses the host -> device link 4x cheaper
        imgs = imgs.float() / 255.0
    B, H, W, _ = imgs.shape
    refy, refx = stretch_grid(H, W, kx, ky)
    cols = torch.arange(W, device=imgs.device)
    c1 = torch.remainder(cols[None, :] - dx[:, None], W)            # [B, W]
    c2 = torch.where(flip[:, None], W - 1 - c1, c1)
    src_y = torch.gather(refy, 2, c2[:, None, :].expand(B, H, W))
    src_x = torch.gather(refx, 1, c2)[:, None, :].expand(B, H, W)
    out = bilinear_wrap_sample(imgs, src_y, src_x)
    return torch.pow(out.clamp(0.0, 1.0), gamma_p[:, None, None, None])


def sample_aug_params(rng: np.random.Generator, cor, W,
                      flip=True, rotate=True, gamma=True, stretch=True,
                      max_stretch=2.0):
    """One sample's augmentation parameters from the host RNG. Stretch
    factors are clipped by the room extents as the reference does
    (dataset.py:70-82). Returns a dict of python scalars."""
    kx = ky = 1.0
    if stretch:
        xmin, ymin, xmax, ymax = cor2xybound(cor, W)
        kx = rng.uniform(1.0, max_stretch)
        ky = rng.uniform(1.0, max_stretch)
        if rng.integers(2) == 0:
            kx = max(1 / kx, min(0.5 / xmin, 1.0))
        else:
            kx = min(kx, max(10.0 / xmax, 1.0))
        if rng.integers(2) == 0:
            ky = max(1 / ky, min(0.5 / ymin, 1.0))
        else:
            ky = min(ky, max(10.0 / ymax, 1.0))
    do_flip = bool(flip and rng.integers(2) == 0)
    dx = int(rng.integers(W)) if rotate else 0
    p = 1.0
    if gamma:
        p = rng.uniform(1, 2)
        if rng.integers(2) == 0:
            p = 1 / p
    return {"kx": kx, "ky": ky, "flip": do_flip, "dx": dx, "p": p}


def transform_corners(cor, params, W):
    """The same augmentation applied to the corner list (host, analytic);
    the reference's per-augmentation updates (dataset.py:82,91,98)."""
    cor = np.asarray(cor, np.float64).copy()
    if params["kx"] != 1.0 or params["ky"] != 1.0:
        cor = stretched_corners(cor, params["kx"], params["ky"], W)
    if params["flip"]:
        cor[:, 0] = W - 1 - cor[:, 0]
    if params["dx"]:
        cor[:, 0] = (cor[:, 0] + params["dx"]) % W
    return cor


class _Card:
    """A card's copy stream (shared by every thread: it only ever waits for
    its own work) and the hand-over events of its last batches, each
    recorded on its caller's stream."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.handed = collections.deque()


def _card(device):
    """The _Card of CUDA ``device``."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        if device not in _cards:
            _cards[device] = _Card(device)
        return _cards[device]


def _warp_on_copy_stream(imgs, ps, unpack, H, W, device):
    """The CUDA upload and warp of ``augment_batch``: pinned staging, the
    copies and the warp on the card's copy stream, handed to the caller's
    current stream by an event."""
    global stream_uploads
    card = _card(device)
    stream = card.stream
    with _lock:
        oldest = (card.handed.popleft() if len(card.handed) >= RUN_AHEAD
                  else None)
    if oldest is not None and not oldest.query():
        with profiling.span("augment.runahead_wait"):
            oldest.synchronize()
    caller = torch.cuda.current_stream(stream.device)
    params = np.array([[p[k] for p in ps] for k, _ in _PARAMS], np.float64)
    with torch.cuda.stream(stream):
        with profiling.span("augment.upload", next(_batches)):
            vecs = torch.from_numpy(params).pin_memory().to(
                stream.device, non_blocking=True)
            rgb = torch.from_numpy(imgs).pin_memory().to(
                stream.device, non_blocking=True)
        # float64 holds each value exactly: the same float32, bool and
        # int64 vectors as torch.tensor makes from the python scalars
        args = [v.to(dtype) for v, (_, dtype) in zip(vecs, _PARAMS)]
        if unpack is not None:
            rgb = unpack(rgb, H, W)
        out = augment_images(rgb, *args)
        warped = torch.cuda.Event()
        warped.record(stream)
    caller.wait_event(warped)
    out.record_stream(caller)
    handed = torch.cuda.Event(blocking=True)
    handed.record(caller)
    with _lock:
        card.handed.append(handed)
        stream_uploads += 1
    return out


def augment_batch(imgs, cors, rng: np.random.Generator, H, W, wire="uint8",
                  *, device, **flags):
    """Whole-batch augmentation: images on ``device``, labels on the host.

    imgs: [B, H, W, 3] uint8 or float32 numpy; cors: list of (2N, 2)
    corner arrays. ``wire``: "uint8" uploads the pixels; "dct" / "dct4"
    pack them on the host (ops/dct.py) and decode on the device.
    Returns (aug_imgs [B, H, W, 3] float32 on ``device``, aug_cors list,
    params list). The upload of the pixels and of the five parameter
    vectors is traced as the span ``augment.upload`` (utils/profiling.py),
    its request id the batch's number in the process.

    On a CUDA device the call does not wait for the work in flight on the
    caller's current stream, only, where ``RUN_AHEAD`` batches handed over
    earlier are still queued there, for the oldest of them (see the
    module's docstring). The images are ready on the stream that was
    current at the call, in stream order; a caller that reads them on
    another stream makes that stream wait for this one first.
    """
    B = imgs.shape[0]
    ps = [sample_aug_params(rng, cors[b], W, **flags) for b in range(B)]
    imgs = np.asarray(imgs)
    unpack = None
    if wire in ("dct", "dct4"):
        if imgs.dtype != np.uint8:
            imgs = np.clip(np.rint(imgs * 255.0), 0, 255).astype(np.uint8)
        pack, unpack = ((_dct.pack_dct4, _dct.unpack_dct4_to_rgb)
                        if wire == "dct4"
                        else (_dct.pack_dct, _dct.unpack_dct_to_rgb))
        imgs = pack(imgs)
    elif wire != "uint8":
        raise ValueError(f"unknown training wire {wire!r}")
    device = torch.device(device)
    if device.type == "cuda":
        out = _warp_on_copy_stream(imgs, ps, unpack, H, W, device)
    else:
        vec = lambda k, dtype: torch.tensor(  # noqa: E731
            [p[k] for p in ps], dtype=dtype, device=device)
        with profiling.span("augment.upload", next(_batches)):
            args = [vec(k, dtype) for k, dtype in _PARAMS]
            rgb = torch.from_numpy(imgs).to(device)
        if unpack is not None:
            # decoded on the device, then warped
            rgb = unpack(rgb, H, W)
        out = augment_images(rgb, *args)
    aug_cors = [transform_corners(cors[b], ps[b], W) for b in range(B)]
    return out, aug_cors, ps
