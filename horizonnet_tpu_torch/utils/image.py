"""Pano IO: a numpy PNG decoder and encoder, Pillow for the rest.

PNG files (or their bytes, ``decode_png``) decode here with zlib and
numpy alone, so the CLIs run on hosts without Pillow; other formats, and
panos that need resizing to the 1024x512 input contract, go through
Pillow (imported on that path only), as the JAX CLI does
(horizonnet_tpu/cli/inference.py:124-130). ``write_png`` writes the 8-bit
RGB PNGs of synthetic datasets and of the preprocess, viewer, dataset and
prepare CLIs.
"""

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # color type -> samples per pixel


def _unfilter_sequential(ftype, line, prior, bpp):
    """Average (3) and Paeth (4) rows: each byte depends on its left
    neighbour's reconstruction, so they run byte by byte."""
    out = bytearray(line.tobytes())
    prior = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path):
    """8-bit, non-interlaced gray/RGB/RGBA PNG -> uint8 [H, W, C]."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data, path):
    """read_png on the bytes of a PNG file; ``path`` names the file in the
    errors."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB/RGBA "
                         f"PNGs decode without Pillow (got {hdr})")
    bpp = _CHANNELS[ctype]
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, stride + 1)
    img = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, line = raw[y, 0], raw[y, 1:]
        if ftype == 0:
            row = line
        elif ftype == 1:
            row = (np.cumsum(line.reshape(W, bpp), axis=0, dtype=np.uint64)
                   % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            row = line + prior
        elif ftype in (3, 4):
            row = _unfilter_sequential(ftype, line, prior, bpp)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        img[y] = row
        prior = img[y]
    return img.reshape(H, W, bpp)


def write_png(path, img, level=6):
    """uint8 [H, W, 3] -> an 8-bit RGB PNG (filter 0 on every row), zlib
    at ``level`` (1 is fastest)."""
    img = np.ascontiguousarray(img, np.uint8)
    H, W, C = img.shape
    if C != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {img.shape}")
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1)],
                         axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2,
                                                      0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, level))
                + chunk(b"IEND", b""))


def load_pano(path, size=(1024, 512)):
    """uint8 RGB [H, W, 3] at ``size`` (W, H)."""
    if path.lower().endswith(".png"):
        img = read_png(path)
        if img.shape[1::-1] == size:
            return img[..., :3]
    from PIL import Image

    img = Image.open(path)
    if img.size != size:
        img = img.resize(size, Image.BICUBIC)
    return np.asarray(img, np.uint8)[..., :3]
