"""Inference: wire decode + batched TTA forward + layout fit.

Counterpart of horizonnet_tpu/inference.py (reference inference.py:
21-141). One ``InferenceEngine`` serves one fixed config (batch, H, W,
TTA, wire format, postproc) on one device: ``put`` uploads a host batch,
``run`` queues decode, forward and the fused fit on the device and
returns device tensors without waiting, so the host can prepare the next
batch while the device works; ``serve_stream`` pipelines it.

The reference-compatible path is ``inference``: the forward on the
device through a cached engine (``net_forward``), then the host
``postprocess`` per pano in float64 numpy, the JAX host path function
for function (the general-layout fit always finishes on the host).
"""

import sys
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

    Data-parallel serving (JAX's ``mesh=``): under a ``mesh``
    (parallel/mesh.py) every rank of the data axis calls the engine on the
    same global batch of ``batch_size``; each rank uploads, decodes, runs
    and fits its own rows (batch_size / n_data of them), and the outputs
    are gathered over the data group, so every rank returns the global
    batch's result. The weights are whole on every rank.
    """

    def __init__(self, model, state_dict, batch_size=1, H=512, W=1024,
                 flip=False, rotate=(), postproc=None, input_format="float",
                 dct_luma_m=None, dct_chroma_m=None, dct_quality=None, *,
                 device, mesh=None):
        if postproc not in (None, "cuboid", "general"):
            raise ValueError(f"unknown postproc mode {postproc!r}")
        if input_format not in INPUT_FORMATS:
            raise ValueError(f"unknown input_format {input_format!r}")
        if mesh is not None and batch_size % mesh.n_data:
            raise ValueError(f"batch of {batch_size} does not split over "
                             f"{mesh.n_data} data ranks")
        self.mesh = mesh
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
        """Upload a host batch in the engine's wire format (under a mesh,
        this rank's rows of it)."""
        dtype, shape = self._in
        x = np.asarray(x, dtype)
        if x.shape != shape:
            raise ValueError(f"batch shape {x.shape} != engine's {shape}")
        if self.mesh is not None:
            x, = shard_batch(self.mesh, (x,))
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
        tensors without waiting for them. The model runs in eval mode,
        also when a trainer that shares it (the train CLI's validation)
        left it in train mode."""
        self.model.eval()
        bon, cor = tta_forward(self.model, self._decode(x_dev), self.flip,
                               self.rotate)
        if self.postproc == "cuboid":
            outs = (pack_cuboid_outputs(
                postprocess_cuboid_batch(bon, cor[:, 0], self.H, self.W)),)
        elif self.postproc == "general":
            outs = (pack_general_outputs(
                postprocess_general_batch(bon, cor[:, 0], self.H, self.W)),)
        else:
            outs = (bon, cor)
        if self.mesh is not None:
            outs = tuple(self._gather_rows(o) for o in outs)
        return outs[0] if self.postproc else outs

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
              force_cuboid=False, force_raw=False, min_v=None, r=0.05):
    """Reference-compatible batched inference. x: [B, H, W, 3] in [0, 1].
    Returns a list of (cor_id, z0, z1, vis_out) per pano (the reference
    takes one pano at a time)."""
    x = np.asarray(x, np.float32)
    B, H, W, _ = x.shape
    bon, cor = net_forward(model, state_dict, x, flip, rotate)
    bon = bon.cpu().numpy()
    cor = cor.cpu().numpy()

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
