"""Read the JAX package's ``.ckpt`` files without jax, flax or msgpack.

Format (horizonnet_tpu/train/checkpoint.py:28-52): an 8-byte magic, a
little-endian u64 header length, a JSON header ({"kind", "kwargs":
{backbone, use_rnn}, ...}), then flax's msgpack payload {"params",
"batch_stats"[, ...]} whose arrays are msgpack ext type 1 holding
msgpack (shape, dtype name, C-order bytes). The decoder below covers the
msgpack types flax writes. float16 storage (the committed golden) is
upcast to float32, as load_trained_model does there (:79-83).
"""

import json
import struct

import numpy as np

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


def load_trained_model(path, *, device, dtype=None, lstm_impl="kernel"):
    """Returns (model, state_dict): the model built on ``device`` with the
    checkpoint's weights loaded, and the state_dict (CPU tensors)."""
    import torch

    from ..models.registry import build_model
    from ..models.torch_convert import variables_to_state_dict

    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise NotImplementedError(
                f"{path}: reference .pth checkpoints load through "
                "load_state_dict once ROADMAP Queue 1 item 6 lands")
    header, payload = read_checkpoint(path)
    kw = header["kwargs"]
    sd = variables_to_state_dict(
        {"params": _upcast(payload["params"]),
         "batch_stats": _upcast(payload.get("batch_stats", {}))})
    model = build_model(kw["backbone"], kw["use_rnn"], device=device,
                        dtype=dtype or torch.float32, lstm_impl=lstm_impl)
    model.load_state_dict(sd)
    return model, sd
