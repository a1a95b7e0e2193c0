"""Batched on-device cuboid post-processing (static shapes).

Counterpart of the cuboid half of horizonnet_tpu/postproc/device.py, the
device replica of the reference's force_cuboid host postprocess
(inference.py:90-141 + the cuboid half of misc/post_proc.py): boundary
denormalization, robust z1, corner peaks, floor-plane projection, the
per-segment consensus vote, the cuboid alternation fix and the corner
back-projection, batched over panos in float32, so only one packed
[B, 17] array leaves the device.

Tie rules kept from JAX: the top-4 peak pick orders equal values by
column (lax.top_k's lower-index-first, here a stable descending sort),
and argmax/argmin return the first index.
"""

import torch

from ..geometry.equirect import (PI, coor2xy, coory2v_up, infer_coory,
                                 mean_percentile, xy2coor)
from ..ops.filters import circular_max_filter_1d


def vote_sorted(svals, m, tol):
    """Consensus vote over pre-sorted, +inf-padded sample rows.

    ``svals [..., W]`` ascending with ``m [...]`` valid entries followed by
    +inf padding; ``tol [...]`` per-row tolerance. Returns
    ``(best_fit, p_score, l1_score)``, the host ``vote`` semantics (ref
    misc/post_proc.py:75-98): the longest sorted span whose extremes lie
    within tol (+1e-9 for distinct pairs) covering >= 40% of the samples
    wins, earliest start breaking ties; the median with score 0 when no
    span qualifies or m < tol.
    """
    W = svals.shape[-1]
    idx = torch.arange(W, device=svals.device)
    valid_entry = idx < m[..., None]
    sz = torch.where(valid_entry, svals, 0.0)
    cs0 = torch.cat([torch.zeros_like(sz[..., :1]), sz.cumsum(-1)], -1)

    # End of the longest admissible span from each start i: the last j
    # with svals[j] <= svals[i] + tol - 1e-9; (i, i) is always valid
    q = svals + (tol[..., None] - 1e-9)
    ss = torch.searchsorted(svals.contiguous(), q.contiguous(), right=True)
    ss = torch.maximum(ss, idx + 1)
    span = ss - idx

    ok = valid_entry & (span >= 0.4 * m[..., None])
    bi = torch.argmax(torch.where(ok, span, -1), -1, keepdim=True)
    span_b = span.gather(-1, bi)[..., 0]
    sum_b = (cs0.gather(-1, ss.gather(-1, bi)) - cs0.gather(-1, bi))[..., 0]
    span_fit = sum_b / span_b

    # Median fallback (np.median over the m valid entries); 0 for m == 0
    lo_i = ((m - 1) // 2).clamp(min=0)[..., None]
    hi_i = (m // 2).clamp(min=0)[..., None]
    med = 0.5 * (svals.gather(-1, lo_i) + svals.gather(-1, hi_i))[..., 0]
    med = torch.where(m > 0, med, 0.0)

    has = ok.any(-1) & (m >= tol)
    best_fit = torch.where(has, span_fit, med)
    p_score = torch.where(has, span_b / m.clamp(min=1), 0.0)
    l1 = torch.where(valid_entry, (svals - best_fit[..., None]).abs(),
                     0.0).sum(-1) / m.clamp(min=1)
    return best_fit, p_score, l1


def find_4_peaks(signal, r_px):
    """Top-4 corner columns [B, 4], sorted (ref inference.py:21-29 with
    min_v=0, N=4). Signals with < 4 local maxima fall back to evenly
    spaced columns, seeded with tiny distinct values that real peaks
    always outrank, so the 4 columns never collide."""
    W = signal.shape[-1]
    mx = circular_max_filter_1d(signal, r_px)
    cand = torch.where((mx == signal) & (signal > 0.0), signal, -torch.inf)
    bump = torch.full((W,), -torch.inf, dtype=signal.dtype,
                      device=signal.device)
    bump[torch.arange(4, device=signal.device) * (W // 4)] = torch.arange(
        4, 0, -1, dtype=signal.dtype, device=signal.device) * 1e-12
    # stable descending sort: equal values keep column order, as top_k
    order = torch.sort(torch.maximum(cand, bump), dim=-1, descending=True,
                       stable=True).indices
    return torch.sort(order[..., :4], dim=-1).values


def _plan_projection(y_bon, H, W, z0):
    """Denormalized boundaries, robust second-plane height z1, vote
    tolerance, and the ceiling boundary projected onto the floor plane
    (ref inference.py:90-97)."""
    B = y_bon.shape[0]
    bon = (y_bon / PI + 0.5) * H - 0.5
    ceil = bon[:, 0].clamp(1, H / 2 - 1)
    floor = bon[:, 1].clamp(H / 2 + 1, H - 2)

    # refine_by_fix_z: robust second-plane height (ref post_proc.py:109-123)
    c0 = z0 / torch.tan(coory2v_up(ceil, H))
    z1 = mean_percentile(c0 * torch.tan(coory2v_up(floor, H)), dim=-1)
    tol = (0.16 * z1 / 1.6).abs()

    cols = torch.arange(W, dtype=ceil.dtype, device=ceil.device)
    xy = coor2xy(torch.stack([cols.expand(B, W), ceil], -1), z0, W, H)
    return z1, tol, xy


def _segment_votes_padded(xy, gpid, tol, n_seg):
    """vote_sorted over [B, n_seg, 2, W] masked per-segment rows.
    Returns (fit, score, l1), each [B, n_seg, 2] (the JAX twin's fourth
    output, the segment mean, serves only general mode)."""
    B, W, _ = xy.shape
    seg_mask = gpid[:, None, :] == torch.arange(
        n_seg, device=gpid.device)[None, :, None]                  # [B,n,W]
    vals_ax = xy.permute(0, 2, 1)                                   # [B,2,W]
    rows = seg_mask[:, :, None, :]
    svals = torch.where(rows, vals_ax[:, None], torch.inf).sort(-1).values
    m = seg_mask.sum(-1)[..., None].expand(B, n_seg, 2)
    return vote_sorted(svals, m, tol[:, None, None].expand(B, n_seg, 2))


def postprocess_cuboid_batch(y_bon, y_cor, H=512, W=1024, z0=50.0, r=0.05):
    """Full cuboid postprocess for a batch of raw model outputs.

    y_bon [B, 2, W] boundary angles (radians); y_cor [B, W] corner
    probability (post-sigmoid). Returns (cor_id [B, 8, 2] normalized uv,
    ceiling/floor interleaved, z1 [B]); z0 is the reference's fixed 50.
    """
    B = y_bon.shape[0]
    z1, tol, xy = _plan_projection(y_bon, H, W, z0)

    # Corner columns and the wall-segment id of every column
    r_px = int(round(W * r / 2))
    locs = find_4_peaks(y_cor, r_px)                                # [B, 4]
    cols = torch.arange(W, device=y_cor.device)
    gpid = (cols[None, :, None] >= locs[:, None, :]).sum(-1) % 4    # [B, W]

    fit, sc, l1 = _segment_votes_padded(xy, gpid, tol, 4)

    # Candidate wall per segment: better-scoring axis wins, L1 breaks ties
    # (x on strict win, y on full tie: host tuple compare semantics)
    pick_x = (sc[..., 0] > sc[..., 1]) | (
        (sc[..., 0] == sc[..., 1]) & (l1[..., 0] < l1[..., 1]))
    val = torch.where(pick_x, fit[..., 0], fit[..., 1])             # [B, 4]
    score = torch.where(pick_x, sc[..., 0], sc[..., 1])

    # Cuboid alternation fix (ref post_proc.py:224-237): the parity whose
    # member walls carry the higher signed score total
    signed = torch.where(pick_x, score, -score)
    first = (~(signed[:, 0] + signed[:, 2]
               > signed[:, 1] + signed[:, 3])).long()
    types = (first[:, None] + torch.arange(4, device=val.device)) % 2

    # Wall-line intersections -> plan corners -> pano pixel coords
    val_n = torch.roll(val, -1, dims=1)
    corx = torch.where(types == 1, val_n, val)
    cory = torch.where(types == 1, val, val_n)
    cor = xy2coor(torch.stack([corx, cory], -1), z0, W, H)          # [B,4,2]
    shift = 2 * torch.argmin(cor[:, ::2, 0], dim=1)
    order = (torch.arange(4, device=cor.device)[None, :]
             + shift[:, None]) % 4
    cor = cor.gather(1, order[..., None].expand(B, 4, 2))

    # Floor row of every corner from its ceiling row (ref inference.py:129)
    fy = infer_coory(cor[..., 1], z1[:, None] - z0, z0, H)
    cor_id = torch.stack(
        [torch.stack([cor[..., 0], cor[..., 1]], -1),
         torch.stack([cor[..., 0], fy], -1)], dim=2).reshape(B, 8, 2)
    cor_id = torch.stack([cor_id[..., 0] / W, cor_id[..., 1] / H], -1)
    return cor_id, z1


def pack_cuboid_outputs(outs):
    """(cor_id [B, 8, 2], z1 [B]) -> ONE [B, 17] float32 tensor, so the
    host fetches one array. Host twin: serving.unpack_cuboid_outputs."""
    cor_id, z1 = outs
    B = cor_id.shape[0]
    return torch.cat([cor_id.reshape(B, 16).float(),
                      z1.reshape(B, 1).float()], dim=-1)
