"""Inference: wire decode + batched TTA forward + layout fit.

Counterpart of horizonnet_tpu/inference.py (reference inference.py:
21-141). One ``InferenceEngine`` serves one fixed config (batch, H, W,
TTA, wire format, postproc) on one device, as the JAX engine's one
compiled program does: on a CUDA device it captures decode, forward and
the fused fit once as a CUDA graph (program.py). ``put`` starts the
upload of a host batch (pinned staging, a copy stream) and returns
without waiting for the device; ``run`` queues the program on an upload
and returns device tensors without waiting, so the host prepares the
next batch while the device works; ``serve_stream`` pipelines the two.

The reference-compatible path is ``inference``: the forward on the
device through a cached engine (``net_forward``), then the host
``postprocess`` per pano in float64 numpy, the JAX host path function
for function (the general-layout fit always finishes on the host).
"""

import sys
import threading
from collections import OrderedDict

import numpy as np
import torch
import torch.distributed as dist

from .geometry.equirect_host import infer_coory, refine_by_fix_z
from .geometry.polygon import polygon_is_valid
from .ops import dct as _dct
from .ops.filters import find_peaks_np
from .ops.yuv import unpack_yuv420_to_rgb
from .parallel.mesh import shard_batch
from .postproc.device import (pack_cuboid_outputs, pack_general_outputs,
                              postprocess_cuboid_batch,
                              postprocess_general_batch)
from .postproc.manhattan import gen_ww
from .program import CapturedProgram, Upload, UploadRing, engine_device
from .utils import profiling

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


def wire_spec(input_format, B, H, W, luma_m, chroma_m):
    """(numpy dtype, shape) of a batch of B in the wire ``input_format``."""
    if input_format == "float":
        return np.float32, (B, H, W, 3)
    if input_format == "uint8":
        return np.uint8, (B, H, W, 3)
    if input_format == "yuv420":
        return np.uint8, (B, 6, H // 2, W // 2)
    if input_format == "dct":
        return np.int8, _dct.dct_wire_shape(B, H, W, luma_m, chroma_m)
    return np.int8, _dct.dct4_wire_shape(B, H, W, luma_m, chroma_m)


def decode_wire(x, input_format, H, W, luma_m, chroma_m, quality):
    """Wire tensor -> float RGB [B, 3, H, W] (a channels-last view)."""
    if input_format == "uint8":
        x = x.float() / 255.0
    elif input_format == "yuv420":
        x = unpack_yuv420_to_rgb(x)
    elif input_format in ("dct", "dct4"):
        unpack = (_dct.unpack_dct_to_rgb if input_format == "dct"
                  else _dct.unpack_dct4_to_rgb)
        x = unpack(x, H, W, luma_m, chroma_m, quality)
    return x.permute(0, 3, 1, 2)


def serving_outputs(model, rgb, H, W, flip=False, rotate=(), postproc=None):
    """TTA forward and fit of a decoded batch -> a tuple of device
    tensors: (packed cuboid,), (packed general,) or (bon, cor_prob)."""
    bon, cor = tta_forward(model, rgb, flip, rotate)
    profiling.mark("head")
    if postproc == "cuboid":
        outs = (pack_cuboid_outputs(
            postprocess_cuboid_batch(bon, cor[:, 0], H, W)),)
    elif postproc == "general":
        outs = (pack_general_outputs(
            postprocess_general_batch(bon, cor[:, 0], H, W)),)
    else:
        return bon, cor
    profiling.mark("fit")
    return outs


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

    Data-parallel serving (JAX's ``mesh=``): under a ``mesh``
    (parallel/mesh.py) every rank of the data axis calls the engine on the
    same global batch of ``batch_size``; each rank uploads, decodes, runs
    and fits its own rows (batch_size / n_data of them), and the outputs
    are gathered over the data group, so every rank returns the global
    batch's result. The weights are whole on every rank.

    ``graph``: on a CUDA device without a mesh (the default, True) the
    program is captured once here, after a warm-up, and every ``run``
    replays it (program.py::CapturedProgram); a capture that fails raises.
    ``graph=False`` runs the same program eagerly, as the CPU and a mesh
    always do. The capture holds the parameters' addresses: weights change
    only by ``update_variables``, which copies into them.
    """

    #: upload slots: serve_stream's default depth of 3 in flight, plus one
    UPLOAD_SLOTS = 4

    def __init__(self, model, state_dict, batch_size=1, H=512, W=1024,
                 flip=False, rotate=(), postproc=None, input_format="float",
                 dct_luma_m=None, dct_chroma_m=None, dct_quality=None, *,
                 device, mesh=None, graph=True):
        if postproc not in (None, "cuboid", "general"):
            raise ValueError(f"unknown postproc mode {postproc!r}")
        if input_format not in INPUT_FORMATS:
            raise ValueError(f"unknown input_format {input_format!r}")
        if mesh is not None and batch_size % mesh.n_data:
            raise ValueError(f"batch of {batch_size} does not split over "
                             f"{mesh.n_data} data ranks")
        self.mesh = mesh
        self.device = engine_device(resolve_device(device))
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
        self._in = wire_spec(input_format, batch_size, H, W,
                             self.dct_luma_m, self.dct_chroma_m)
        self.update_variables(state_dict)
        dtype, shape = self._in
        rows = (batch_size if mesh is None else batch_size // mesh.n_data,)
        tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        self._ring = UploadRing(rows + shape[1:], tdtype, self.device,
                                self.UPLOAD_SLOTS)
        self.program = None
        if graph and self.device.type == "cuda" and mesh is None:
            self._static = torch.zeros(self._ring.shape, dtype=tdtype,
                                       device=self.device)
            self.program = CapturedProgram(
                lambda: self._program(self._static), self.device)

    def update_variables(self, state_dict):
        """Swap in new weights without rebuilding the engine: copied into
        the parameters in place, so a captured program reads them."""
        self.model.load_state_dict(state_dict)

    def put(self, x):
        """Start the upload of a host batch in the engine's wire format
        (under a mesh, this rank's rows of it) -> an Upload for ``run``.
        Returns without waiting for the device."""
        dtype, shape = self._in
        x = np.asarray(x, dtype)
        if x.shape != shape:
            raise ValueError(f"batch shape {x.shape} != engine's {shape}")
        if self.mesh is not None:
            x, = shard_batch(self.mesh, (x,))
        return self._ring.put(x)

    def run(self, x):
        """Queue the whole program on a batch: an Upload from ``put``, or a
        tensor of the wire's shape already on the device. Returns device
        tensors without waiting for them; a captured program's outputs are
        copies, which the next run leaves alone."""
        up = x if isinstance(x, Upload) else None
        if up is not None:
            x = self._ring.take(up)
        elif tuple(x.shape) != self._ring.shape \
                or x.dtype != self._ring.dtype:
            raise ValueError(f"batch {tuple(x.shape)} {x.dtype} != engine's "
                             f"{self._ring.shape} {self._ring.dtype}")
        try:
            if self.program is None:
                outs = self._program(x)
            else:
                self._static.copy_(x)
        finally:
            if up is not None:
                self._ring.release(up)
        if self.program is not None:
            outs = tuple(o.clone() for o in self.program.replay())
        return outs[0] if self.postproc else outs

    @torch.no_grad()
    def _program(self, x_dev):
        """Decode, TTA forward and fit of one uploaded batch -> a tuple of
        device tensors. The model runs in eval mode, also when a trainer
        that shares it (the train CLI's validation) left it in train
        mode. Its device stages, marked for a capture
        (utils/profiling.py::mark): decode, encoder (models/horizonnet.py),
        head (height stage, bi-LSTM, linear, the TTA mean) and fit."""
        self.model.eval()
        profiling.mark(None)
        rgb = decode_wire(x_dev, self.input_format, self.H, self.W,
                          self.dct_luma_m, self.dct_chroma_m,
                          self.dct_quality)
        profiling.mark("decode")
        outs = serving_outputs(self.model, rgb, self.H, self.W, self.flip,
                               self.rotate, self.postproc)
        if self.mesh is not None:
            outs = tuple(self._gather_rows(o) for o in outs)
        return outs

    def _gather_rows(self, t):
        """Every data rank's rows of ``t``, in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.mesh.n_data)]
        dist.all_gather(parts, t, group=self.mesh.data_group)
        return torch.cat(parts, 0)

    def __call__(self, x):
        return self.run(self.put(x))


def serve_stream(engine, batches, depth=3, finish=None, workers=1):
    """Pipelined serving loop: yield engine outputs in input order while
    keeping up to ``depth`` batches in flight.

    ``batches`` is consumed lazily, so the caller's ingest of later
    batches overlaps the device work of earlier ones: neither ``put`` nor
    ``run`` waits for the device, so up to ``depth`` batches are queued
    on it while the next one uploads. Without ``finish`` the yielded
    outputs are the engine's device tensors. With ``finish(outs) ->
    result`` each output goes to a pool of ``workers`` threads, whose
    device-to-host fetch and numpy tail overlap the main thread's uploads.
    A worker starts on an output once the device has written it (an event
    recorded after ``run``), and fetches it on a stream of its own: on the
    default stream the fetch would wait for the batches queued after it.
    Results still come in input order, and an exception in the tail
    re-raises at the yield.

    Batches are numbered from 0: while tracing is on (utils/profiling.py)
    a batch's spans on the main thread (``put``, ``run`` and the replay
    inside) and on its worker share that number as their request id. The
    main thread's wait for the oldest result is ``serve.wait_result``, a
    worker's wait for the device to write its batch ``serve.wait_written``.
    """
    from collections import deque

    q = deque()
    if finish is None:
        for k, x in enumerate(batches):
            with profiling.request(k):
                q.append(engine.run(engine.put(x)))
            if len(q) > depth:
                yield q.popleft()
        while q:
            yield q.popleft()
        return

    def wait():
        k, fut = q.popleft()
        with profiling.span("serve.wait_result", k):
            return fut.result()

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        for k, x in enumerate(batches):
            with profiling.request(k):
                outs = engine.run(engine.put(x))
            q.append((k, pool.submit(_finish_when_written, finish, outs,
                                     _written_event(outs), k)))
            if len(q) > depth:
                yield wait()
        while q:
            yield wait()


def _written_event(outs):
    """(device, an event recorded on its current stream) after ``outs`` (a
    device tensor or a tuple of them) were queued; None off the card."""
    t = outs[0] if isinstance(outs, tuple) else outs
    if not (isinstance(t, torch.Tensor) and t.is_cuda):
        return None
    # a blocking event: a worker waiting on it sleeps instead of spinning
    # on a core that another worker's numpy tail could use
    ev = torch.cuda.Event(blocking=True)
    ev.record(torch.cuda.current_stream(t.device))
    return t.device, ev


_fetch = threading.local()


def _finish_when_written(finish, outs, written, req=None):
    """``finish(outs)`` once ``written`` has fired, on this thread's fetch
    stream for the device (made on first use); its spans take request id
    ``req``. Once the batch is written, the device stages of the replays
    that have finished are read (utils/profiling.py::resolve)."""
    with profiling.request(req):
        if written is None:
            return finish(outs)
        device, ev = written
        with profiling.span("serve.wait_written"):
            ev.synchronize()
        if profiling.pending():
            profiling.resolve()
        streams = _fetch.__dict__.setdefault("streams", {})
        if device not in streams:
            streams[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(streams[device]):
            return finish(outs)


# Engine cache of net_forward / inference. Entries hold strong references
# to their (model, state_dict) key objects: the key uses id(), and CPython
# reuses a freed object's id, so without the pinned references new weights
# at a recycled address would hit a stale engine. A bounded LRU, so that
# swapped-out configs release their engines.
_ENGINE_CACHE = OrderedDict()
_ENGINE_CACHE_MAX = 4


def _get_engine(model, state_dict, B, H, W, flip, rotate):
    key = (id(model), id(state_dict), B, H, W, bool(flip), tuple(rotate))
    hit = _ENGINE_CACHE.get(key)
    if hit is not None:
        _ENGINE_CACHE.move_to_end(key)
        return hit[0]
    device = next(model.parameters()).device
    eng = InferenceEngine(model, state_dict, B, H, W, flip, rotate,
                          device=device)
    _ENGINE_CACHE[key] = (eng, model, state_dict)
    while len(_ENGINE_CACHE) > _ENGINE_CACHE_MAX:
        _ENGINE_CACHE.popitem(last=False)
    return eng


def net_forward(model, state_dict, x, flip=False, rotate=()):
    """TTA forward on the model's device; x numpy [B, H, W, 3] in [0, 1].
    Returns (bon [B, 2, W], cor_prob [B, 1, W]) as device tensors."""
    x = np.asarray(x)
    B, H, W, _ = x.shape
    return _get_engine(model, state_dict, B, H, W, flip, rotate)(x)


def postprocess(y_bon_, y_cor_, H=512, W=1024, force_cuboid=False,
                force_raw=False, min_v=None, r=0.05):
    """Host post-processing of one pano's raw outputs -> corner list.

    y_bon_: [2, W] boundary angles (radians); y_cor_: [W] corner
    probability. Returns (cor_id [(2N, 2) normalized uv], z0, z1).
    float64 numpy, as the JAX host path. Ref: inference.py:90-141.
    """
    y_bon_ = np.asarray(y_bon_, np.float64)
    y_cor_ = np.asarray(y_cor_, np.float64)

    y_bon_ = (y_bon_ / np.pi + 0.5) * H - 0.5
    y_bon_[0] = np.clip(y_bon_[0], 1, H / 2 - 1)
    y_bon_[1] = np.clip(y_bon_[1], H / 2 + 1, H - 2)

    z0 = 50.0
    _, z1 = refine_by_fix_z(y_bon_[0], y_bon_[1], z0, coorH=H)

    if force_raw:
        # the raw per-column ceiling polygon (train-time validation)
        cor = np.stack([np.arange(W), y_bon_[0]], 1)
    else:
        if min_v is None:
            min_v = 0 if force_cuboid else 0.05
        r_px = int(round(W * r / 2))
        N = 4 if force_cuboid else None
        xs_ = find_peaks_np(y_cor_, r=r_px, min_v=min_v, N=N)[0]

        cor, walls = gen_ww(xs_, y_bon_[0], z0, coorW=W, coorH=H,
                            tol=abs(0.16 * z1 / 1.6),
                            force_cuboid=force_cuboid)
        if not force_cuboid:
            # a self-intersecting general layout falls back to a cuboid
            xy2d = np.zeros((len(walls), 2), np.float32)
            for i in range(len(walls)):
                xy2d[i, walls[i].axis] = walls[i].value
                xy2d[i, walls[i - 1].axis] = walls[i - 1].value
            if not polygon_is_valid(xy2d):
                print("Fail to generate valid general layout!! "
                      "Generate cuboid as fallback.", file=sys.stderr)
                xs_ = find_peaks_np(y_cor_, r=r_px, min_v=0, N=4)[0]
                cor, walls = gen_ww(xs_, y_bon_[0], z0, coorW=W, coorH=H,
                                    tol=abs(0.16 * z1 / 1.6),
                                    force_cuboid=True)

    # the floor row of every corner from its ceiling row
    cor = np.hstack([cor, infer_coory(cor[:, 1], z1 - z0, z0,
                                      coorH=H)[:, None]])

    cor_id = np.zeros((len(cor) * 2, 2), np.float32)
    for j in range(len(cor)):
        cor_id[j * 2] = cor[j, 0], cor[j, 1]
        cor_id[j * 2 + 1] = cor[j, 0], cor[j, 2]
    cor_id[:, 0] /= W
    cor_id[:, 1] /= H
    return cor_id, z0, float(z1)


def inference(model, state_dict, x, flip=False, rotate=(), visualize=False,
              force_cuboid=False, force_raw=False, min_v=None, r=0.05,
              batch_size=None):
    """Reference-compatible batched inference. x: [B, H, W, 3] in [0, 1].
    Returns a list of (cor_id, z0, z1, vis_out) per pano (the reference
    takes one pano at a time). With ``batch_size`` the forward runs on x
    padded to that many rows with repeats of its last pano, so that a
    run's chunks, its short tail too, share one engine (on the card, one
    capture); the results are x's rows' only."""
    x = np.asarray(x, np.float32)
    B, H, W, _ = x.shape
    xin = x
    if batch_size is not None and B < batch_size:
        xin = np.concatenate([x, np.repeat(x[-1:], batch_size - B, 0)])
    bon, cor = net_forward(model, state_dict, xin, flip, rotate)
    bon = bon[:B].cpu().numpy()
    cor = cor[:B].cpu().numpy()

    results = []
    for b in range(B):
        vis_out = None
        if visualize:
            from .viewer.visualize import visualize_a_data
            vis_out = visualize_a_data(x[b], bon[b], cor[b, 0])
        cor_id, z0, z1 = postprocess(bon[b], cor[b, 0], H, W, force_cuboid,
                                     force_raw, min_v, r)
        results.append((cor_id, z0, z1, vis_out))
    return results
