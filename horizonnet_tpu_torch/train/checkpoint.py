"""The JAX package's ``.ckpt`` files, read and written without jax, flax
or msgpack.

Format (horizonnet_tpu/train/checkpoint.py:28-52): an 8-byte magic, a
little-endian u64 header length, a JSON header ({"kind", "kwargs":
{backbone, use_rnn}, ...}), then flax's msgpack payload {"params",
"batch_stats"[, ...]} whose arrays are msgpack ext type 1 holding
msgpack (shape, dtype name, C-order bytes). The decoder and the encoder
below cover the msgpack types flax writes. float16 storage (the committed
golden) is upcast to float32, as load_trained_model does there (:79-83).

``save_model`` writes the inference checkpoint and ``save_checkpoint``
the training one, whose ``opt_state`` is optax's ``to_state_dict`` of the
optimizer that train/step.py::make_optimizer mirrors, so the JAX
package's ``load_trained_model`` and ``load_checkpoint`` read both; the
port's ``load_checkpoint`` restores a training state from either package's
file.

LGT-Net (models/lgt.py), which the JAX package lacks, is written in the
same container with ``kwargs`` {"arch": "lgt", "backbone", "W"} and a
payload of its own: the port's state_dict as a flat map of arrays
(``state_dict``) and the optimizer's moments the same way
(``opt_state``: {"count", "mu", "nu"} or {"count", "trace"}).
"""

import json
import os
import shutil
import struct

import numpy as np
import torch

_MAGIC = b"HZTPU1\x00\x00"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Minimal msgpack decoder: nil, bool, int, float, str, bin, array,
    map and flax's ndarray / numpy-scalar ext types."""

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack payload")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        lengths = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        ext = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), self.take(n))
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            code = self.unpack(">b")
            return self.ext(code, self.take(fixext[b]))
        nums = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
                0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in nums:
            return self.unpack(nums[b])
        strs = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xdc, 0xdd):
            return self.array(self.unpack(">H" if b == 0xdc else ">I"))
        if b in (0xde, 0xdf):
            return self.map(self.unpack(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} not supported")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code, data):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} not supported")
        shape, dtype, raw = _Reader(data).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(dtype))
        arr = arr.reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def msgpack_restore(blob):
    """Decode flax's msgpack bytes into dicts, lists and numpy arrays."""
    r = _Reader(blob)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack payload")
    return out


class _Writer:
    """Minimal msgpack encoder for flax's payload trees: dict (str keys),
    list, str, bytes, bool, None, int, float and numpy arrays / scalars
    as flax's ext types."""

    def __init__(self):
        self.out = bytearray()

    def head(self, n, fix, fix_max, codes):
        if n <= fix_max and fix is not None:
            self.out.append(fix | n)
            return
        for code, fmt in codes:
            if n < 1 << (8 * struct.calcsize(fmt)):
                self.out += bytes([code]) + struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack length {n} too large")

    def value(self, v):
        if v is None or isinstance(v, bool):
            self.out.append({None: 0xc0, False: 0xc2, True: 0xc3}[v])
        elif isinstance(v, (np.ndarray, np.generic)):
            code = _EXT_NDARRAY if isinstance(v, np.ndarray) else _EXT_NPSCALAR
            v = np.asarray(v)
            inner = _Writer()
            inner.value([list(v.shape), v.dtype.name, v.tobytes("C")])
            self.ext(code, bytes(inner.out))
        elif isinstance(v, int):
            self.int(v)
        elif isinstance(v, float):
            self.out += b"\xcb" + struct.pack(">d", v)
        elif isinstance(v, str):
            b = v.encode()
            self.head(len(b), 0xa0, 31, [(0xd9, ">B"), (0xda, ">H"),
                                         (0xdb, ">I")])
            self.out += b
        elif isinstance(v, bytes):
            self.head(len(v), None, 0, [(0xc4, ">B"), (0xc5, ">H"),
                                        (0xc6, ">I")])
            self.out += v
        elif isinstance(v, (list, tuple)):
            self.head(len(v), 0x90, 15, [(0xdc, ">H"), (0xdd, ">I")])
            for x in v:
                self.value(x)
        elif isinstance(v, dict):
            self.head(len(v), 0x80, 15, [(0xde, ">H"), (0xdf, ">I")])
            if not all(isinstance(k, str) for k in v):
                raise TypeError(f"msgpack map keys {list(v)} are not all str")
            for k in sorted(v):   # flax flattens the tree: sorted keys
                self.value(k)
                self.value(v[k])
        else:
            raise TypeError(f"cannot msgpack {type(v).__name__}")

    def int(self, v):
        if 0 <= v <= 0x7f or -32 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
            return
        fmts = ([(0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")]
                if v >= 0 else
                [(0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q")])
        for code, fmt in fmts:
            try:
                self.out += bytes([code]) + struct.pack(fmt, v)
                return
            except struct.error:
                continue
        raise ValueError(f"integer {v} out of msgpack's range")

    def ext(self, code, data):
        fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if len(data) in fixext:
            self.out.append(fixext[len(data)])
        else:
            self.head(len(data), None, 0, [(0xc7, ">B"), (0xc8, ">H"),
                                           (0xc9, ">I")])
        self.out += struct.pack(">b", code) + data


def msgpack_serialize(tree):
    """Encode a tree of dicts, lists and numpy arrays to the bytes flax's
    msgpack_serialize gives (for arrays under 2 GiB, which flax would
    chunk)."""
    w = _Writer()
    w.value(tree)
    return bytes(w.out)


def write_checkpoint(path, header, payload):
    """Magic, header, msgpack payload; written to ``path`` + ".tmp" and
    renamed, as the JAX package does."""
    head = json.dumps(header).encode()
    blob = msgpack_serialize(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        f.write(blob)
    os.replace(tmp, path)


def read_checkpoint(path):
    """-> (header dict, payload tree of numpy arrays)."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{path}: not a horizonnet_tpu checkpoint")
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode())
        payload = msgpack_restore(f.read())
    return header, payload


def _upcast(tree):
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    return tree.astype(np.float32) if tree.dtype == np.float16 else tree


def load_trained_model(path, *, device, dtype=None, lstm_impl="kernel",
                       **build_kw):
    """Returns (model, state_dict): the model built on ``device`` with the
    checkpoint's weights loaded, and the state_dict (CPU tensors).
    ``path`` is a ``.ckpt`` of either package or, told apart by the
    magic bytes as horizonnet_tpu/train/checkpoint.py:65-74 does, a
    reference ``.pth`` (models/torch_convert.py::load_torch_checkpoint;
    resnet50 with the RNN unless it says otherwise; its nonzero bias_hh
    folds into bias_ih at load, models/horizonnet.py::BiLSTM).
    ``build_kw`` go to models.build_model (a training model's
    ``param_dtype``, ``bn_momentum``)."""

    from ..models.registry import build_model
    from ..models import torch_convert

    with open(path, "rb") as f:
        is_ckpt = f.read(8) == _MAGIC
    if is_ckpt:
        header, payload = read_checkpoint(path)
        kw = header["kwargs"]
        if kw.get("arch") == "lgt":
            model = build_model(kw["backbone"], device=device, arch="lgt",
                                W=kw["W"], dtype=dtype or torch.float32,
                                **build_kw)
            sd = _flat_state_dict(payload["state_dict"])
            model.load_state_dict(sd)
            return model, sd
        sd = torch_convert.variables_to_state_dict(
            {"params": _upcast(payload["params"]),
             "batch_stats": _upcast(payload.get("batch_stats", {}))})
    else:
        sd, kw = torch_convert.load_torch_checkpoint(path)
    model = build_model(kw.get("backbone", "resnet50"),
                        kw.get("use_rnn", True), device=device,
                        dtype=dtype or torch.float32, lstm_impl=lstm_impl,
                        **build_kw)
    if not is_ckpt:
        sd = torch_convert.match_reference_keys(sd, model.state_dict().keys())
    model.load_state_dict(sd)
    return model, sd


def _flat(tensors):
    """{name: tensor} -> {name: numpy array} (floats in float32)."""
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            .cpu().numpy() for k, v in tensors.items()}


def _flat_state_dict(payload):
    """A flat payload map -> {name: CPU tensor}, float16 upcast."""
    return {k: torch.from_numpy(np.array(v)) for k, v in
            _upcast(payload).items()}


def _lgt_width(state_dict):
    """LGT-Net's input width (4 x its ratio head's columns), None for a
    HorizonNet state_dict."""
    w = state_dict.get("ratio_out.weight")
    return None if w is None else 4 * int(w.shape[1])


def _model_kwargs(state_dict, backbone, use_rnn):
    width = _lgt_width(state_dict)
    if width is None:
        return {"backbone": backbone, "use_rnn": use_rnn}
    return {"arch": "lgt", "backbone": backbone, "W": width}


def save_model(path, state_dict, backbone, use_rnn, args=None):
    """Inference checkpoint of a state_dict (horizonnet_tpu/train/
    checkpoint.py:55-62); LGT-Net's in its own payload."""
    from ..models.torch_convert import state_dict_to_variables

    payload = ({"state_dict": _flat(state_dict)} if _lgt_width(state_dict)
               else state_dict_to_variables(state_dict))
    write_checkpoint(path, {"kind": "model", "kwargs": _model_kwargs(
        state_dict, backbone, use_rnn), "args": args or {}}, payload)


def _moments_tree(moments, state_dict):
    """{parameter name: tensor} -> the flax params tree; parameters
    without an entry (frozen ones) get zeros."""
    from ..models.torch_convert import state_dict_to_variables

    sd = {k: moments.get(k, torch.zeros_like(v, device="cpu"))
          for k, v in state_dict.items()}
    return state_dict_to_variables(sd)["params"]


def _opt_state_tree(host, state_dict):
    """optax's to_state_dict layout of make_optimizer's chain:
    [chain(add_decayed_weights, ] adam|sgd [), masked(set_to_zero)]."""
    spec = host["spec"]
    count = np.asarray(host["step"], np.int32)
    trees = {k: _moments_tree(m, state_dict)
             for k, m in host["moments"].items()}
    core = ({"count": count, "mu": trees["mu"], "nu": trees["nu"]}
            if spec.optim == "Adam" else {"trace": trees["trace"]})
    tx = {"0": core, "1": {"count": count} if spec.schedule else {}}
    if spec.weight_decay:
        tx = {"0": {}, "1": tx}
    if spec.freeze_mask is not None:
        tx = {"0": tx, "1": {"inner_state": {}}}
    return tx


def save_checkpoint(ckpt_dir, host, backbone, use_rnn, epoch,
                    best_valid_score, is_best, args=None):
    """Training checkpoint ``ckpt_dir/checkpoint.ckpt`` and, if
    ``is_best``, its copy ``best_model_{epoch}.ckpt``
    (horizonnet_tpu/train/checkpoint.py:90-105). ``host`` is
    TrainEngine.host_state() or TrainState.host(); LGT-Net's state goes
    in its own payload."""
    from ..models.torch_convert import state_dict_to_variables

    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "checkpoint.ckpt")
    sd = host["state_dict"]
    count = np.asarray(host["step"], np.int32)
    if _lgt_width(sd):
        payload = {"state_dict": _flat(sd), "opt_state": {
            "count": count, **{k: _flat(m) for k, m in
                               host["moments"].items()}}}
    else:
        payload = state_dict_to_variables(sd)
        payload["opt_state"] = _opt_state_tree(host, sd)
    payload["step"] = count
    write_checkpoint(path, {"kind": "train", "kwargs": _model_kwargs(
        sd, backbone, use_rnn), "epoch": epoch,
        "best_valid_score": float(best_valid_score), "args": args or {}},
        payload)
    if is_best:
        shutil.copyfile(path, os.path.join(ckpt_dir,
                                           f"best_model_{epoch}.ckpt"))
    return path


def load_checkpoint(path, state):
    """Restore a TrainState (train/step.py) in place from a training
    checkpoint of either package: weights, batch statistics, the
    optimizer's moments and its count. Returns (state, header)."""
    from ..models.torch_convert import variables_to_state_dict

    header, payload = read_checkpoint(path)
    if header["kwargs"].get("arch") == "lgt":
        state.model.load_state_dict(_flat_state_dict(payload["state_dict"]))
        with torch.no_grad():
            for k, moments in state.opt.moments.items():
                saved = _flat_state_dict(payload["opt_state"][k])
                for n, t in moments.items():
                    t.copy_(saved[n])
        state.opt.count = int(payload["step"])
        return state, header
    stats = _upcast(payload["batch_stats"])
    state.model.load_state_dict(variables_to_state_dict(
        {"params": _upcast(payload["params"]), "batch_stats": stats}))
    opt = state.opt
    tx = payload["opt_state"]
    if opt.spec.freeze_mask is not None:
        tx = tx["0"]
    if opt.spec.weight_decay:
        tx = tx["1"]
    core = tx["0"]
    with torch.no_grad():
        for k, moments in opt.moments.items():
            sd = variables_to_state_dict({"params": core[k],
                                          "batch_stats": stats})
            for n, t in moments.items():
                t.copy_(sd[n])
    opt.count = int(payload["step"])
    return state, header
