"""Full VP-alignment pipeline: views -> LSD -> merge -> Hough -> refit.

Counterpart of horizonnet_tpu/preprocess/pipeline.py, with the same stages,
the same ``stage_timer`` names and the same result dict. Reference
behavior: panoEdgeDetection (misc/pano_lsd_align.py:804-868). The view
cutting + grayscale runs on the host or, with the device backend, as one
torch program on the card; the rest is host work: LSD (C++),
lifting/merging/Hough/refit (vectorized numpy).
"""

import numpy as np

from ..utils.profiling import stage_timer
from .views import cut_views, cut_views_gray, rgb_to_gray, VIEW_DIRECTIONS
from .lsd import lsd_batch
from .lines import (lift_segments_to_sphere, combine_edges,
                    assign_vanishing_type, refit_line_segments,
                    paint_parameter_lines)
from .vanishing import find_main_direction


def draw_segments(shape, segments):
    """Raster segments (with width) into a mask — cv2.line replacement.

    Walks each segment at sub-pixel steps stamping a square brush of the
    segment's half-width (the reference uses cv2.line thickness
    ceil(width/2), pano_lsd_align.py:268).
    """
    canvas = np.zeros(shape, np.uint8)
    H, W = shape
    for seg in segments:
        x1, y1, x2, y2, width = seg[:5]
        r = max(int(np.ceil(width / 2)) // 2, 0)
        n = int(max(abs(x2 - x1), abs(y2 - y1), 1)) * 2
        ts = np.linspace(0, 1, n + 1)
        xs = np.round(x1 + ts * (x2 - x1)).astype(int)
        ys = np.round(y1 + ts * (y2 - y1)).astype(int)
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                xx = np.clip(xs + dx, 0, W - 1)
                yy = np.clip(ys + dy, 0, H - 1)
                canvas[yy, xx] = 255
    return canvas


def pano_edge_detection(img, view_size=320, q_error=0.7, refine_iter=3,
                        want_edge_maps=False, want_views=False,
                        want_pano_edge=True, lsd_workers=None, backend=None,
                        device=None):
    """img: [H, W, 3] float 0..1 or uint8. Returns a dict with:

    lines, vp (6x3: 3 directions + mirrors), views, edges, pano_edge
    ([H, W, 3] line raster per VP class), score, angle.

    ``views`` (the 26 RGB perspective cuts) and per-view edge rasters are
    debug artifacts — the pipeline itself only consumes the grayscale
    views, which come back from the device as one fused cut+luma program
    (4x less host<-device traffic). Pass want_views/want_edge_maps to
    materialize the debug versions. ``backend`` and ``device`` choose where
    the view cut runs (``views.preprocess_backend``; the device backend
    runs on ``device``, default CUDA, and hands back f16 grays).
    """
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img_f = img.astype(np.float64)
    else:
        img_f = img.astype(np.float64) * (255.0 if img.max() <= 1.001 else 1.0)
    H, W = img.shape[:2]

    with stage_timer("preprocess/cut_views"):
        if want_views:
            views = cut_views(img_f, size=view_size, backend=backend,
                              device=device)
            grays = rgb_to_gray(views)
        elif img.dtype == np.uint8:
            views = None
            # uint8 straight to the warp: same values as the float64
            # detour (integral 0..255 are exact in f32), a quarter of the
            # upload bytes on the device backend
            grays = cut_views_gray(img, size=view_size, backend=backend,
                                   device=device)
        else:
            views = None
            grays = cut_views_gray(img_f, size=view_size, backend=backend,
                                   device=device)

    xs, ys = VIEW_DIRECTIONS
    fov = np.pi / 3
    edges = []
    lifted = []
    # LSD across the 26 views on the native std::thread pool (one ctypes
    # call, lsd.cpp lsd_detect_batch). Callers that already parallelize
    # at the pano level (cli/preprocess) pass lsd_workers to cap the
    # inner fan-out — a full hardware pool per pano would oversubscribe
    # the host by the outer pool size.
    with stage_timer("preprocess/lsd"):
        segs = lsd_batch(grays, quant=q_error, num_workers=lsd_workers)
    with stage_timer("preprocess/lift"):
        for i in range(len(xs)):
            seg = segs[i]
            if len(seg):
                seg_list = np.hstack([seg[:, :5], np.ones((len(seg), 2))])
            else:
                seg_list = np.zeros((0, 7))
            pano_lst = lift_segments_to_sphere(
                seg_list, xs[i], ys[i], fov, grays[i].shape)
            # Edge maps are debug artifacts (the pipeline only needs
            # shapes); raster them only on request
            edge_map = (draw_segments(grays[i].shape, seg)
                        if (want_edge_maps and len(seg))
                        else np.zeros(grays[i].shape, np.uint8))
            edges.append({"img": edge_map, "edgeLst": seg_list,
                          "vx": xs[i], "vy": ys[i], "fov": fov,
                          "panoLst": pano_lst})
            lifted.append(pano_lst)

    with stage_timer("preprocess/merge"):
        lines, olines = combine_edges(lifted)

    clines = lines.copy()
    main_direct = None
    score = angle = 0
    groups = [np.zeros((0, 8))] * 3
    for _ in range(refine_iter):
        with stage_timer("preprocess/hough"):
            main_direct, score, angle = find_main_direction(clines)
        if main_direct is None:
            break
        with stage_timer("preprocess/refit"):
            tp, _ = assign_vanishing_type(lines, main_direct[:3], 0.1, 10)
            groups = [lines[tp == k] for k in range(3)]
            groups = [refit_line_segments(gk, main_direct[k], 0)
                      for k, gk in enumerate(groups)]
            clines = np.vstack(groups)

    with stage_timer("preprocess/paint"):
        pano_edge = (np.stack([
            paint_parameter_lines(gk, W, H) for gk in groups], -1)
            if want_pano_edge else None)

    return {
        "lines": clines,
        "vp": main_direct,
        "views": views,
        "edges": edges,
        "pano_edge": pano_edge,
        "score": score,
        "angle": angle,
    }
