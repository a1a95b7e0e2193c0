"""Headless preview renderer for layout meshes.

Copy of horizonnet_tpu/viewer/render.py (host numpy). The reference's
interactive 3D check (layout_viewer.py:138-169) needs an open3d GUI; this
module renders the same textured geometry to a PNG with numpy alone:
project the mesh vertices through a pinhole camera placed at the pano
origin, then paint them far-to-near (painter's algorithm over splatted
points: exact occlusion for point primitives, hole-free at the mesh's
~0.5M vertex density with a 2x2 splat).
"""

import numpy as np


def render_points(xyz, rgb, out_h=480, out_w=640, yaw=0.0, pitch=0.0,
                  fov=np.pi / 2, splat=2):
    """Project colored points into a perspective view.

    xyz [N, 3] (z up, camera at origin — the layout mesh convention of
    viewer/mesh.py); rgb [N, 3] uint8/float colors; yaw/pitch aim the
    camera (radians), fov is the horizontal field of view. Returns
    [out_h, out_w, 3] uint8 (background black).
    """
    xyz = np.asarray(xyz, np.float64)
    rgb = np.asarray(rgb)

    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # World (z up, camera at origin) -> camera (x right, y down, z fwd):
    # right = fwd x up normalized; down = fwd x right (right-handed,
    # right x down == fwd; at pitch 0, down == -z)
    fwd = np.array([cy * cp, sy * cp, sp])
    right = np.array([sy, -cy, 0.0])
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])                       # [3, 3]
    cam = xyz @ R.T

    z = cam[:, 2]
    keep = z > 1e-6
    cam, colors = cam[keep], rgb[keep]
    f = (out_w / 2) / np.tan(fov / 2)
    px = np.round(cam[:, 0] / cam[:, 2] * f + out_w / 2).astype(np.int64)
    py = np.round(cam[:, 1] / cam[:, 2] * f + out_h / 2).astype(np.int64)
    keep = (px >= 0) & (px < out_w - (splat - 1)) \
        & (py >= 0) & (py < out_h - (splat - 1))
    px, py, colors = px[keep], py[keep], colors[keep]
    depth = cam[keep][:, 2]

    # Painter's algorithm: draw far-to-near so near points win
    order = np.argsort(-depth)
    px, py, colors = px[order], py[order], colors[order]
    canvas = np.zeros((out_h, out_w, 3), np.uint8)
    c8 = np.clip(colors, 0, 255).astype(np.uint8)
    for dy in range(splat):
        for dx in range(splat):
            canvas[py + dy, px + dx] = c8
    return canvas


def render_layout_views(xyz, rgb, out_h=480, out_w=640, n_views=4,
                        pitch=-0.35):
    """A horizontal ring of ``n_views`` preview renders (tiled [H, n*W])."""
    tiles = [render_points(xyz, rgb, out_h, out_w,
                           yaw=2 * np.pi * k / n_views, pitch=pitch)
             for k in range(n_views)]
    return np.concatenate(tiles, axis=1)
