"""Compressed DCT wire formats: numpy packers and the on-device decode.

Counterpart of horizonnet_tpu/ops/dct.py. The host half (JPEG tables,
zig-zag order, quantization, ``pack_dct`` / ``pack_dct4``) is a copy of
the JAX module's numpy code, because importing that module imports jax.
The device half decodes in PyTorch: dequantization and the partial IDCT
are one [m, 64] matmul per plane, then tile reassembly, nearest chroma
upsampling and the inverse fixed-point BT.601 transform.

Wire layouts (see the JAX module's docstring for the design):
``dct``  int8 [B, NY*luma_m + 2*NC*chroma_m], zig-zag coefficients;
``dct4`` int8 [B, NY*(1+ceil(luma_m/2)) + 2*NC*(1+ceil(chroma_m/2))],
         per tile an int8 DC, a 4-bit shift and int4 AC mantissas.
"""

import functools

import numpy as np
import torch

# JPEG Annex K quantization tables (quality 50), full 8x8
_JPEG_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float64)
_JPEG_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.float64)

DEFAULT_LUMA_M = 15   # complete u+v<=4 anti-diagonal triangle
DEFAULT_CHROMA_M = 6  # u+v<=2 triangle
DEFAULT_QUALITY = 87


@functools.lru_cache(maxsize=None)
def zigzag_uv(m):
    """First ``m`` (u, v) positions of the JPEG zig-zag scan of an 8x8."""
    assert 1 <= m <= 64
    order = []
    for d in range(15):
        diag = [(d - v, v) for v in range(d + 1) if d - v < 8 and v < 8]
        # canonical JPEG scan: odd anti-diagonals run top-right->bottom-left
        # ((0,1) then (1,0)), even ones bottom-left->top-right
        order.extend(diag[::-1] if d % 2 else diag)
    uv = np.array(order[:m])
    return uv[:, 0], uv[:, 1]


@functools.lru_cache(maxsize=None)
def _dct_basis_full():
    """Orthonormal DCT-II basis C[u, x], shape [8, 8]."""
    x = np.arange(8)
    u = np.arange(8)[:, None]
    c = np.cos((2 * x[None, :] + 1) * u * np.pi / 16)
    c *= np.where(u == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return c


@functools.lru_cache(maxsize=None)
def _quant_steps(m, quality, chroma):
    """[m] quantization steps along the zig-zag at a JPEG quality factor.

    Standard IJG scaling; the DC step is floored at 8 so the orthonormal
    DC range (+-1024 around the -128-centered block) always fits int8 —
    a saturated DC would clamp whole blocks.
    """
    assert 1 <= quality <= 100
    s = 5000 / quality if quality < 50 else 200 - 2 * quality
    table = _JPEG_CHROMA if chroma else _JPEG_LUMA
    u, v = zigzag_uv(m)
    steps = np.floor((table[u, v] * s + 50) / 100)
    steps = np.maximum(steps, 1.0)
    steps[0] = max(steps[0], 8.0)
    return steps


@functools.lru_cache(maxsize=None)
def _codec_matrices(m, quality, chroma):
    """(analysis [64, m], synthesis [m, 64]) with quantization folded in.

    Coefficient j is the projection of the (-128-centered) 8x8 tile onto
    ``outer(C[u_j], C[v_j])`` divided by its quantization step; synthesis
    is the transpose basis scaled back by the step. f32 is plenty: the
    step (>= 1, DC >= 8) dwarfs the ~1e-3 f32 rounding of an 8x8 DCT.
    """
    C = _dct_basis_full()
    u, v = zigzag_uv(m)
    basis = (C[u][:, :, None] * C[v][:, None, :]).reshape(m, 64)
    steps = _quant_steps(m, quality, chroma)
    ana = (basis / steps[:, None]).T.astype(np.float32)
    syn = (basis * steps[:, None]).astype(np.float32)
    return ana, syn


def dct_wire_shape(B, H, W, luma_m=DEFAULT_LUMA_M, chroma_m=DEFAULT_CHROMA_M):
    """Shape of the packed int8 wire array for a [B, H, W, 3] batch."""
    assert H % 16 == 0 and W % 16 == 0
    n_y = (H // 8) * (W // 8)
    n_c = (H // 16) * (W // 16)
    return (B, n_y * luma_m + 2 * n_c * chroma_m)


def _blockify(plane):
    """[B, H, W] -> [B, H/8*W/8, 64] row-major tiles (numpy)."""
    B, H, W = plane.shape
    t = plane.reshape(B, H // 8, 8, W // 8, 8)
    return t.transpose(0, 1, 3, 2, 4).reshape(B, -1, 64)


def _rgb_to_ycc420(rgb):
    """Host: RGB uint8 [B, H, W, 3] -> (y, cb, cr) planes, chroma 2x2
    box-subsampled.

    The single source of the wire color contract: the exact fixed-point
    BT.601 full-range pair of ops/yuv.py pack_yuv420, shared by pack_dct
    and pack_dct4 so the two wires cannot diverge.
    """
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    cb = 128 + (((b - y) * 144 + 128) >> 8)
    cr = 128 + (((r - y) * 183 + 128) >> 8)
    cb = np.clip((cb[:, 0::2, 0::2] + cb[:, 0::2, 1::2]
                  + cb[:, 1::2, 0::2] + cb[:, 1::2, 1::2] + 2) >> 2, 0, 255)
    cr = np.clip((cr[:, 0::2, 0::2] + cr[:, 0::2, 1::2]
                  + cr[:, 1::2, 0::2] + cr[:, 1::2, 1::2] + 2) >> 2, 0, 255)
    return y, cb, cr


def pack_dct(rgb, luma_m=DEFAULT_LUMA_M, chroma_m=DEFAULT_CHROMA_M,
             quality=DEFAULT_QUALITY):
    """Host/client: RGB uint8 [B, H, W, 3] -> flat int8 wire array.

    Forward color transform is the exact fixed-point pair of
    ops/yuv.py pack_yuv420; each 8x8 tile (centered at -128) keeps its
    first ``m`` zig-zag DCT coefficients quantized by the JPEG tables.
    """
    rgb = np.asarray(rgb)
    assert rgb.dtype == np.uint8 and rgb.ndim == 4 and rgb.shape[-1] == 3
    B, H, W, _ = rgb.shape
    assert H % 16 == 0 and W % 16 == 0
    y, cb, cr = _rgb_to_ycc420(rgb)

    out = []
    for plane, m, chroma in ((y, luma_m, False), (cb, chroma_m, True),
                             (cr, chroma_m, True)):
        ana, _ = _codec_matrices(m, quality, chroma)
        blocks = _blockify(plane.astype(np.float32) - 128.0)
        q = np.rint(blocks.reshape(-1, 64) @ ana)
        out.append(np.clip(q, -128, 127).reshape(B, -1))
    return np.concatenate(out, axis=1).astype(np.int8)


def dct4_wire_shape(B, H, W, luma_m=DEFAULT_LUMA_M,
                    chroma_m=DEFAULT_CHROMA_M):
    """Shape of the packed int8 dct4 wire array for a [B, H, W, 3] batch."""
    assert H % 16 == 0 and W % 16 == 0
    n_y = (H // 8) * (W // 8)
    n_c = (H // 16) * (W // 16)
    return (B, n_y * (1 + (luma_m + 1) // 2)
            + 2 * n_c * (1 + (chroma_m + 1) // 2))


def _bfp_pack_plane(q, m):
    """[Ntiles, m] unclipped quantized-domain coefs -> int8 tile bytes.

    Layout per tile: [DC int8][nibble pairs], nibble stream =
    (shift, mant_1 .. mant_{m-1}, 0-pad), low nibble first.
    """
    n = q.shape[0]
    dc = np.clip(np.rint(q[:, 0]), -128, 127)
    qac = q[:, 1:]
    ma = np.abs(qac).max(1) if m > 1 else np.zeros(n)
    with np.errstate(divide="ignore"):
        s = np.ceil(np.log2(np.maximum(ma, 1e-12) / 7.5)).astype(np.int64)
    s = np.clip(s, 0, 7)
    # rounding can still land a mantissa on 8; bump the exponent once
    bump = np.rint(ma / np.exp2(s)) > 7
    s[bump] = np.minimum(s[bump] + 1, 7)
    mant = np.clip(np.rint(qac / np.exp2(s)[:, None]), -7, 7)
    nib = np.concatenate([s[:, None], mant], 1)
    if nib.shape[1] % 2:
        nib = np.pad(nib, ((0, 0), (0, 1)))
    nibu = (nib.astype(np.int16) & 0xF).astype(np.uint8)
    packed = (nibu[:, 0::2] | (nibu[:, 1::2] << 4)).view(np.int8)
    dc8 = dc.astype(np.int8)[:, None]
    return np.concatenate([dc8, packed], 1).reshape(n, -1)


def pack_dct4(rgb, luma_m=DEFAULT_LUMA_M, chroma_m=DEFAULT_CHROMA_M,
              quality=DEFAULT_QUALITY):
    """Host/client: RGB uint8 [B, H, W, 3] -> flat int8 dct4 wire array.

    Same color transform / zig-zag / quantization as pack_dct; the AC
    coefficients of each tile are block-floating-point encoded (see
    the dct4 comment in horizonnet_tpu/ops/dct.py).
    """
    rgb = np.asarray(rgb)
    assert rgb.dtype == np.uint8 and rgb.ndim == 4 and rgb.shape[-1] == 3
    B, H, W, _ = rgb.shape
    assert H % 16 == 0 and W % 16 == 0
    y, cb, cr = _rgb_to_ycc420(rgb)

    out = []
    for plane, m, chroma in ((y, luma_m, False), (cb, chroma_m, True),
                             (cr, chroma_m, True)):
        ana, _ = _codec_matrices(m, quality, chroma)
        blocks = _blockify(plane.astype(np.float32) - 128.0)
        q = blocks.reshape(-1, 64) @ ana
        out.append(_bfp_pack_plane(q, m).reshape(B, -1))
    return np.concatenate(out, axis=1).astype(np.int8)


@functools.lru_cache(maxsize=None)
def _synthesis(m, quality, chroma, device):
    """The [m, 64] synthesis matrix as a float32 tensor on ``device``
    (cached, so a decode issues no host-to-device copy)."""
    return torch.from_numpy(_codec_matrices(m, quality, chroma)[1]).to(
        device)


def _synthesize(coefs, m, quality, chroma, h, w):
    """[B, n, m] float32 quantized-domain coefs -> [B, h, w] plane."""
    B = coefs.shape[0]
    syn = _synthesis(m, quality, chroma, coefs.device)
    tiles = torch.matmul(coefs, syn) + 128.0
    t = tiles.reshape(B, h // 8, w // 8, 8, 8)
    return t.permute(0, 1, 3, 2, 4).reshape(B, h, w)


def _ycc_to_rgb(y, cb, cr):
    """Inverse of the fixed-point BT.601 pair used by the packers (chroma
    already upsampled and centered) -> RGB float32 [B, H, W, 3] in [0, 1]."""
    r = y + cr * (256.0 / 183.0)
    b = y + cb * (256.0 / 144.0)
    g = (y - (77.0 / 256.0) * r - (29.0 / 256.0) * b) * (256.0 / 150.0)
    return torch.clamp(torch.stack([r, g, b], -1) / 255.0, 0.0, 1.0)


def _upsample_chroma(c):
    return c.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0


def _check_wire(packed, want):
    if tuple(packed.shape) != want:
        raise ValueError(f"wire shape {tuple(packed.shape)} != {want}")


def unpack_dct_to_rgb(packed, H=512, W=1024, luma_m=DEFAULT_LUMA_M,
                      chroma_m=DEFAULT_CHROMA_M, quality=DEFAULT_QUALITY):
    """Device: int8 dct wire tensor -> RGB float32 [B, H, W, 3] in [0, 1]."""
    B = packed.shape[0]
    _check_wire(packed, dct_wire_shape(B, H, W, luma_m, chroma_m))
    n_y = (H // 8) * (W // 8)
    n_c = (H // 16) * (W // 16)
    coefs = packed.float()

    def decode(part, n, m, chroma, h, w):
        return _synthesize(part.reshape(B, n, m), m, quality, chroma, h, w)

    y_end = n_y * luma_m
    c_len = n_c * chroma_m
    y = decode(coefs[:, :y_end], n_y, luma_m, False, H, W)
    cb = decode(coefs[:, y_end:y_end + c_len], n_c, chroma_m, True,
                H // 2, W // 2)
    cr = decode(coefs[:, y_end + c_len:], n_c, chroma_m, True, H // 2, W // 2)
    return _ycc_to_rgb(y, _upsample_chroma(cb), _upsample_chroma(cr))


def unpack_dct4_to_rgb(packed, H=512, W=1024, luma_m=DEFAULT_LUMA_M,
                       chroma_m=DEFAULT_CHROMA_M, quality=DEFAULT_QUALITY):
    """Device: int8 dct4 wire tensor -> RGB float32 [B, H, W, 3].

    The nibbles are unpacked in int32 arithmetic: the low nibble
    sign-extends as ((v & 15) ^ 8) - 8 and the high one as v >> 4 of the
    sign-extended byte, the same values as the JAX int8 shifts
    (dct.py:330-331) without relying on int8 shift wrap-around.
    """
    B = packed.shape[0]
    _check_wire(packed, dct4_wire_shape(B, H, W, luma_m, chroma_m))
    n_y = (H // 8) * (W // 8)
    n_c = (H // 16) * (W // 16)

    def decode(tiles_i8, n, m, chroma, h, w):
        tb = 1 + (m + 1) // 2
        t = tiles_i8.reshape(B, n, tb)
        dc = t[..., 0].float()
        nb = t[..., 1:].to(torch.int32)
        lo = ((nb & 15) ^ 8) - 8
        hi = nb >> 4
        nibs = torch.stack([lo, hi], -1).reshape(B, n, 2 * (tb - 1))
        shift = nibs[..., 0]                                # 0..7
        mant = nibs[..., 1:m].float()                       # [B, n, m-1]
        scale = torch.bitwise_left_shift(torch.ones_like(shift), shift)
        coefs = torch.cat([dc[..., None], mant * scale[..., None].float()],
                          -1)
        return _synthesize(coefs, m, quality, chroma, h, w)

    y_tb = 1 + (luma_m + 1) // 2
    c_tb = 1 + (chroma_m + 1) // 2
    y_end = n_y * y_tb
    c_len = n_c * c_tb
    y = decode(packed[:, :y_end], n_y, luma_m, False, H, W)
    cb = decode(packed[:, y_end:y_end + c_len], n_c, chroma_m, True,
                H // 2, W // 2)
    cr = decode(packed[:, y_end + c_len:], n_c, chroma_m, True, H // 2, W // 2)
    return _ycc_to_rgb(y, _upsample_chroma(cb), _upsample_chroma(cr))
