"""Whether what the serving program served is correct.

The reference (reference/: the dct4 decoder, the float32 HorizonNet with
TF32 off, the general fit and its host tail) runs once over every
distinct input the window served, in blocks of rows, after the program's
state is freed; a row served many times with one output is judged once.
Each of the head's three outputs is read by numbers of its own:

``mean_gap``  ceiling boundary: the widest gap, over every wall segment
              of every pano served, between the program's mean of the
              projected ceiling boundary over the segment and the
              reference's over the same columns (the program's own peak
              columns, so a peak chosen the other way on a tie moves
              nothing), taken as the angle the gap spans under the
              ceiling plane at the segment's distance (radians).
``mean_rms``  the same gaps' root mean square over every segment served:
              the widest gap catches one wrong answer, this the error
              spread over all of them, which a lower precision raises
              everywhere.
``floor_gap`` floor boundary: the widest gap, as an angle at the pano's
              median wall distance (radians), between the floor planes of
              the program's height z1 (the robust mean over the pano of
              the floor boundary against the ceiling's) and the
              reference's. An angle, since z1 nears nought where a floor
              boundary nears the horizon, and a gap relative to it swings.
``peak_gap``  corner probability: the widest shortfall of the program's
              peak picking, read on the reference's corner probability.
              A peak column the program chose falls short by how far the
              reference's best value in the column's peak window lies
              above its value there (plus how far that value lies under
              the fit's least peak value). A peak of the reference with no
              peak of the program within NEAR peak windows of it (on a
              flat stretch a chain of near ties carries a suppression
              from window to window) falls short by its height over the
              best of the reference's values at the program's peaks
              there, over the least peak value, and, where the program
              kept as many peaks as the fit keeps, over the lowest of
              those (a peak dropped for higher ones). Near ties read their
              small difference, not a column's distance, so the number is
              continuous where the picking is not.
``tail_gap``  the widest gap between the corners the program's host tail
              served and those the reference's tail makes from the
              program's own device output: an exact comparison.

The corners against the reference's own fit are not compared: the peak
picking and the votes are discontinuous in the network's output, and a
rounding moves a corner by up to half the pano (readings in PERF.md).
"""

import numpy as np
import torch

from reference import dct4 as ref_dct
from reference import fit as ref_fit
from reference import model as ref_model
from reference import tail as ref_tail

BLOCK = 16
#: the ceiling plane's height and the plan's centre (the fits' z0 and
#: floor-plane image centre)
Z0 = 50.0
PLAN_CENTER = (511.5, 255.5)
#: the general fit's peak window (a share of the width) and least value
PEAK_R = 0.05
PEAK_MIN_V = 0.05
#: how many peak windows away a program's peak may stand for a reference's
NEAR = 4


@torch.no_grad()
def reference_outputs(wires, state_dict, H, W, dct, device, lowp=None):
    """The reference over int8 dct4 wire rows ``wires`` [N, L] -> (bon
    [N, 2, W], cor probability [N, W]) float32 on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    net = ref_model.build(state_dict, device)
    ref_model.set_lowp(net, lowp)
    bons, cors = [], []
    for i in range(0, len(wires), BLOCK):
        x = torch.from_numpy(np.ascontiguousarray(wires[i:i + BLOCK]))
        rgb = ref_dct.unpack_dct4_to_rgb(x.to(device), H, W, *dct)
        bon, cor = net(rgb.permute(0, 3, 1, 2))
        bons.append(bon)
        cors.append(torch.sigmoid(cor)[:, 0])
    del net
    return torch.cat(bons), torch.cat(cors)


def served_by_reference(bon, cor, H, W):
    """What the reference serves for (bon, cor): per row, the general
    layout's (packed candidates, (cor_id, z0, z1))."""
    packed = ref_fit.pack_general_outputs(
        ref_fit.postprocess_general_batch(bon, cor, H, W)).cpu().numpy()
    return list(zip(packed, ref_tail.finish_general_batch(packed, W, H)))


def distinct(results, same):
    """[(input row, output)] of ``results`` ((input row, output) of every
    served pano) with each row's repeats that ``same`` finds equal to one
    already kept left out: the program is deterministic, so a row served
    many times is judged once for each different output it got."""
    kept = {}
    for row, out in results:
        outs = kept.setdefault(row, [])
        if not any(same(out, o) for o in outs):
            outs.append(out)
    return [(row, o) for row, outs in sorted(kept.items()) for o in outs]


def same_output(a, b):
    """Two served outputs (packed, (cor_id, z0, z1)) equal to the bit."""
    return (np.array_equal(a[0], b[0]) and a[1][2] == b[1][2]
            and np.array_equal(a[1][0], b[1][0]))


def peak_shortfall(locs, cor, W):
    """``peak_gap`` of each pano: the program's peak columns ``locs``
    [N, K] (-1 padding) read on the reference's corner probability
    ``cor`` [N, W]."""
    size = int(round(W * PEAK_R / 2))
    best = ref_fit.circular_max_filter_1d(cor, size)
    valid = locs >= 0
    at = cor.gather(-1, locs.clamp(min=0))
    short = (best.gather(-1, locs.clamp(min=0)) - at
             + (PEAK_MIN_V - at).clamp(min=0))
    chosen = torch.where(valid, short, 0.0).amax(-1)
    # the reference's peaks against the program's within NEAR windows
    mine = torch.zeros_like(cor).scatter_reduce(
        -1, locs.clamp(min=0), torch.where(valid, at, 0.0), "amax")
    near = ref_fit.circular_max_filter_1d(mine, 2 * NEAR * size + 1)
    full = valid.all(-1, keepdim=True)
    lowest = torch.where(valid, at, torch.inf).amin(-1, keepdim=True)
    rlocs, rvals, rvalid = ref_fit.find_peaks_device(
        cor, r=size, min_v=PEAK_MIN_V, max_peaks=locs.shape[-1])
    floor = near.gather(-1, rlocs.long().clamp(min=0)).clamp(min=PEAK_MIN_V)
    floor = torch.where(full, torch.maximum(floor, lowest), floor)
    missed = torch.where(rvalid, (rvals - floor).clamp(min=0), 0.0).amax(-1)
    return torch.maximum(chosen, missed)


def floor_angle_gap(z1_mine, bon, H, W):
    """``floor_gap`` of each pano: program heights ``z1_mine`` [N] against
    the reference's boundaries ``bon`` [N, 2, W]."""
    z1 = ref_fit.plane_height(bon, H, W, Z0)
    ceil = ((bon[:, 0] / np.pi + 0.5) * H - 0.5).clamp(1, H / 2 - 1)
    dist = (Z0 / torch.tan(ref_fit.coory2v_up(ceil, H))).median(-1).values
    return (torch.atan2(z1_mine, dist) - torch.atan2(z1, dist)).abs()


def compare(served, bon, cor, H, W):
    """{number: gap} of ``served`` ([(input row, output)], each output in
    the program's form: (packed candidates, (cor_id, z0, z1))) against the
    reference's (bon, cor) of every input row."""
    rows = [r for r, _ in served]
    outs = [o for _, o in served]
    sel = torch.tensor(rows, device=bon.device)
    bon, cor = bon[sel], cor[sel]
    packed = np.stack([o[0] for o in outs])
    K = (packed.shape[1] - 17) // 9
    locs = packed[:, :K].astype(np.int64)
    locs_t = torch.from_numpy(locs).to(bon.device)
    mean_r = ref_fit.segment_means(bon, locs_t, H, W).cpu().numpy()
    mean_p = packed[:, 7 * K:9 * K].reshape(-1, K, 2)
    dist = np.linalg.norm(mean_r - np.array(PLAN_CENTER), axis=-1)
    gap = (np.linalg.norm(mean_p - mean_r, axis=-1) * Z0
           / (dist ** 2 + Z0 ** 2))
    gap = gap[locs >= 0]
    out = {"mean_gap": float(gap.max(initial=0.0)),
           "mean_rms": float(np.sqrt(np.mean(gap ** 2))) if gap.size
           else 0.0}
    z1_p = torch.from_numpy(packed[:, 9 * K].copy()).to(bon.device)
    out["floor_gap"] = float(floor_angle_gap(z1_p, bon, H, W).max())
    out["peak_gap"] = float(peak_shortfall(locs_t, cor, W).max())
    mine = ref_tail.finish_general_batch(packed, W, H)
    tail = 0.0
    for m, o in zip(mine, outs):
        got = o[1]
        if m[0].shape != got[0].shape:
            tail = float("inf")
            break
        tail = max(tail, float(np.max(np.abs(m[0] - got[0]))),
                   abs(m[2] - got[2]))
    out["tail_gap"] = tail
    return out
