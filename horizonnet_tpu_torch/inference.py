"""Serving engine: wire decode + batched TTA forward + fused layout fit.

Counterpart of horizonnet_tpu/inference.py's InferenceEngine and
serve_stream (reference inference.py:21-141). One engine serves one fixed
config (batch, H, W, TTA, wire format, postproc) on one device: ``put``
uploads a host batch, ``run`` queues decode, forward and postprocess on
the device and returns device tensors without waiting, so the host can
prepare the next batch while the device works.
"""

import numpy as np
import torch

from .ops import dct as _dct
from .ops.yuv import unpack_yuv420_to_rgb
from .postproc.device import (pack_cuboid_outputs, pack_general_outputs,
                              postprocess_cuboid_batch,
                              postprocess_general_batch)

INPUT_FORMATS = ("float", "uint8", "yuv420", "dct", "dct4")


def resolve_device(device):
    """torch.device for ``device``; a CUDA device that is missing raises
    (there is no silent CPU run)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def tta_forward(model, x, flip=False, rotate=()):
    """Batched test-time augmentation. x [B, 3, H, W] -> (bon [B, 2, W],
    cor_prob [B, 1, W]). Augmented copies run as one batch, are undone
    and averaged; cor goes through sigmoid before the mean
    (ref inference.py:80)."""
    B, W = x.shape[0], x.shape[-1]
    shifts = [int(round(p * W)) for p in rotate]
    xs = [x] + ([x.flip(-1)] if flip else [])
    xs += [torch.roll(x, s, dims=-1) for s in shifts]
    bon, cor = model(torch.cat(xs, 0) if len(xs) > 1 else x)
    cor = torch.sigmoid(cor)
    outs_bon, outs_cor = [bon[:B]], [cor[:B]]
    k = 1
    if flip:
        outs_bon.append(bon[B:2 * B].flip(-1))
        outs_cor.append(cor[B:2 * B].flip(-1))
        k = 2
    for s in shifts:
        outs_bon.append(torch.roll(bon[k * B:(k + 1) * B], -s, dims=-1))
        outs_cor.append(torch.roll(cor[k * B:(k + 1) * B], -s, dims=-1))
        k += 1
    return torch.stack(outs_bon).mean(0), torch.stack(outs_cor).mean(0)


class InferenceEngine:
    """Serving engine for one config on one device.

    ``model`` is a port HorizonNet; ``state_dict`` its weights (loaded
    in place, casting to each parameter's dtype). ``input_format``:
    float [B, H, W, 3] in [0, 1], uint8 [B, H, W, 3], the uint8 yuv420
    planes [B, 6, H/2, W/2] (ops/yuv.py), or the int8 dct / dct4 wire
    (ops/dct.py). ``postproc``: None -> (bon [B, 2, W], cor_prob
    [B, 1, W]); "cuboid" -> one packed [B, 17] tensor for
    postproc.unpack_cuboid_outputs; "general" -> one packed [B, 9K+17]
    candidate tensor for postproc.finish_general_batch.
    """

    def __init__(self, model, state_dict, batch_size=1, H=512, W=1024,
                 flip=False, rotate=(), postproc=None, input_format="float",
                 dct_luma_m=None, dct_chroma_m=None, dct_quality=None, *,
                 device):
        if postproc not in (None, "cuboid", "general"):
            raise ValueError(f"unknown postproc mode {postproc!r}")
        if input_format not in INPUT_FORMATS:
            raise ValueError(f"unknown input_format {input_format!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.H, self.W = H, W
        self.flip, self.rotate = bool(flip), tuple(rotate)
        self.postproc = postproc
        self.input_format = input_format
        self.dct_luma_m = (_dct.DEFAULT_LUMA_M if dct_luma_m is None
                           else dct_luma_m)
        self.dct_chroma_m = (_dct.DEFAULT_CHROMA_M if dct_chroma_m is None
                             else dct_chroma_m)
        self.dct_quality = (_dct.DEFAULT_QUALITY if dct_quality is None
                            else dct_quality)
        wire = (self.dct_luma_m, self.dct_chroma_m)
        if input_format == "float":
            self._in = (np.float32, (batch_size, H, W, 3))
        elif input_format == "uint8":
            self._in = (np.uint8, (batch_size, H, W, 3))
        elif input_format == "yuv420":
            self._in = (np.uint8, (batch_size, 6, H // 2, W // 2))
        elif input_format == "dct":
            self._in = (np.int8, _dct.dct_wire_shape(batch_size, H, W, *wire))
        else:
            self._in = (np.int8, _dct.dct4_wire_shape(batch_size, H, W,
                                                      *wire))
        self.update_variables(state_dict)

    def update_variables(self, state_dict):
        """Swap in new weights without rebuilding the engine."""
        self.model.load_state_dict(state_dict)

    def put(self, x):
        """Upload a host batch in the engine's wire format."""
        dtype, shape = self._in
        x = np.asarray(x, dtype)
        if x.shape != shape:
            raise ValueError(f"batch shape {x.shape} != engine's {shape}")
        return torch.from_numpy(x).to(self.device)

    def _decode(self, x):
        """Wire tensor -> float RGB [B, 3, H, W] (a channels-last view)."""
        fmt = self.input_format
        if fmt == "uint8":
            x = x.float() / 255.0
        elif fmt == "yuv420":
            x = unpack_yuv420_to_rgb(x)
        elif fmt in ("dct", "dct4"):
            unpack = (_dct.unpack_dct_to_rgb if fmt == "dct"
                      else _dct.unpack_dct4_to_rgb)
            x = unpack(x, self.H, self.W, self.dct_luma_m, self.dct_chroma_m,
                       self.dct_quality)
        return x.permute(0, 3, 1, 2)

    @torch.no_grad()
    def run(self, x_dev):
        """Queue the whole program on an uploaded batch; returns device
        tensors without waiting for them."""
        bon, cor = tta_forward(self.model, self._decode(x_dev), self.flip,
                               self.rotate)
        if self.postproc == "cuboid":
            return pack_cuboid_outputs(
                postprocess_cuboid_batch(bon, cor[:, 0], self.H, self.W))
        if self.postproc == "general":
            return pack_general_outputs(
                postprocess_general_batch(bon, cor[:, 0], self.H, self.W))
        return bon, cor

    def __call__(self, x):
        return self.run(self.put(x))


def serve_stream(engine, batches, depth=3, finish=None, workers=1):
    """Pipelined serving loop: yield engine outputs in input order while
    keeping up to ``depth`` batches in flight.

    ``batches`` is consumed lazily, so the caller's ingest of later
    batches overlaps the device work of earlier ones. Without ``finish``
    the yielded outputs are the engine's device tensors. With
    ``finish(outs) -> result`` each output goes to a pool of ``workers``
    threads, whose device-to-host fetch and numpy tail overlap the main
    thread's uploads; results still come in input order, and an
    exception in the tail re-raises at the yield.
    """
    from collections import deque

    q = deque()
    if finish is None:
        for x in batches:
            q.append(engine.run(engine.put(x)))
            if len(q) > depth:
                yield q.popleft()
        while q:
            yield q.popleft()
        return

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        for x in batches:
            q.append(pool.submit(finish, engine.run(engine.put(x))))
            if len(q) > depth:
                yield q.popleft().result()
        while q:
            yield q.popleft().result()
