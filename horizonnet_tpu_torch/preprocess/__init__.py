"""VP-alignment preprocessing: view cutting, LSD, sphere Hough, rotation.

Counterpart of horizonnet_tpu/preprocess, with the same exports. Reference
behavior: misc/pano_lsd_align.py + preprocess.py (the Matlab-derived
LayoutNet pipeline). The host stages are the JAX package's numpy and C++
(LSD, segment merge, triple search and the host warp, built with g++ on
first use into build/preprocess/); the two warps, the 26 perspective view
cuts and the alignment rotation, run on the host (default) or as torch
programs on the card (``HORIZONNET_PREPROCESS_BACKEND=device``, or
``backend="device"``).
"""

from .sphere import (
    xyz2uvN, uv2xyzN, computeUVN, icosahedron2sphere, fit_plane_normal,
)
from .views import cut_views, VIEW_DIRECTIONS
from .rotate import rotate_panorama, rotate_panorama_uint8
from .pipeline import pano_edge_detection

__all__ = [
    "xyz2uvN", "uv2xyzN", "computeUVN", "icosahedron2sphere",
    "fit_plane_normal", "cut_views", "VIEW_DIRECTIONS", "rotate_panorama",
    "rotate_panorama_uint8", "pano_edge_detection",
]
