"""Layout -> textured 3D mesh -> PLY export / interactive view.

Copy of horizonnet_tpu/viewer/mesh.py (host numpy). Reference behavior:
layout_viewer.py:12-169. The layout depth is rendered
analytically (geometry.depth), lifted to a per-pixel 3D point grid, and
triangulated by connecting each pixel to its right/down neighbors (two
triangles per quad), skipping masked-out regions.
"""

import numpy as np

from ..geometry.depth import layout_2_depth


def layout_to_points(cor_id, img, ignore_floor=False, ignore_ceiling=False,
                     ignore_wall=False):
    """Per-pixel 3D points + colors + a keep mask.

    Returns (xyz [H,W,3], rgb [H,W,3], mask [H,W]).
    """
    H, W = img.shape[:2]
    depth, floor_mask, ceil_mask, wall_mask = layout_2_depth(
        cor_id, H, W, return_mask=True)

    vs = ((np.arange(H) + 0.5) / H - 0.5) * np.pi
    us = ((np.arange(W) + 0.5) / W - 0.5) * 2 * np.pi
    vs = np.repeat(vs[:, None], W, 1)
    us = np.repeat(us[None, :], H, 0)

    zs = depth * np.sin(vs)
    cs = depth * np.cos(vs)
    xs = cs * np.sin(us)
    ys = -cs * np.cos(us)
    xyz = np.stack([xs, ys, zs], -1)

    mask = np.ones((H, W), bool)
    if ignore_floor:
        mask &= ~floor_mask
    if ignore_ceiling:
        mask &= ~ceil_mask
    if ignore_wall:
        mask &= ~wall_mask
    return xyz, np.asarray(img), mask


def grid_triangulate(mask):
    """Triangulate the masked pixel grid: 2 triangles per fully-kept quad.

    The pano wraps horizontally: column W-1 connects to column 0.
    Returns (F, 3) int32 indices into the flattened H*W grid.
    """
    H, W = mask.shape
    idx = np.arange(H * W).reshape(H, W)
    right = np.roll(idx, -1, axis=1)

    q00 = idx[:-1, :]
    q01 = right[:-1, :]
    q10 = idx[1:, :]
    q11 = right[1:, :]
    keep = (mask[:-1, :] & np.roll(mask, -1, 1)[:-1, :] &
            mask[1:, :] & np.roll(mask, -1, 1)[1:, :])

    t1 = np.stack([q00[keep], q01[keep], q10[keep]], -1)
    t2 = np.stack([q01[keep], q11[keep], q10[keep]], -1)
    return np.concatenate([t1, t2], 0).astype(np.int32)


def write_ply(path, xyz, rgb, faces=None):
    """ASCII PLY with vertex colors (layout_viewer.py:114-136 format)."""
    xyz = xyz.reshape(-1, 3)
    rgb = rgb.reshape(-1, 3)
    assert len(xyz) == len(rgb)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for (x, y, z), (r, g, b) in zip(xyz, rgb):
            f.write(f"{x:.6f} {y:.6f} {z:.6f} {int(r)} {int(g)} {int(b)}\n")
        if faces is not None:
            for a, b_, c in faces:
                f.write(f"3 {a} {b_} {c}\n")


def corner_wireframe(cor_id, H=512, W=1024, floor_z=-1.6):
    """Corner-edge wireframe geometry (ref layout_viewer.py:138-169).

    cor_id: (2N, 2) pixel corner coords, interleaved ceiling/floor rows.
    Corners project onto the floor plane at z=floor_z; the ceiling height
    is the mean height implied by the ceiling rows over those plan points.
    Returns (points [2N, 3], lines [3N, 2] int32, colors [3N, 3]): the
    floor ring, the ceiling ring, and the vertical edges, all red — the
    arrays an open3d LineSet consumes, constructed GUI-free so they are
    testable without open3d.
    """
    from ..geometry.equirect_host import coor2xy, coory2v_up

    cor_id = np.asarray(cor_id, np.float64)
    N = len(cor_id) // 2
    floor_xy = coor2xy(cor_id[1::2], floor_z, W, H, floorW=1, floorH=1)
    c = np.sqrt((floor_xy ** 2).sum(1))
    v = coory2v_up(cor_id[0::2, 1], H)
    ceil_z = float((c * np.tan(v)).mean())

    points = np.concatenate([
        np.hstack([floor_xy, np.full((N, 1), floor_z)]),
        np.hstack([floor_xy, np.full((N, 1), ceil_z)])], 0)
    ring = np.stack([np.arange(N), (np.arange(N) + 1) % N], -1)
    vertical = np.stack([np.arange(N), np.arange(N) + N], -1)
    lines = np.concatenate([ring, ring + N, vertical], 0).astype(np.int32)
    colors = np.tile([1.0, 0.0, 0.0], (len(lines), 1))
    return points, lines, colors


def layout_to_mesh(cor_id, img, ignore_floor=False, ignore_ceiling=False,
                   ignore_wall=False):
    """Full pipeline: corners + texture -> (vertices, colors, faces)."""
    xyz, rgb, mask = layout_to_points(cor_id, img, ignore_floor,
                                      ignore_ceiling, ignore_wall)
    faces = grid_triangulate(mask)
    H, W = mask.shape
    rgb_u8 = np.clip(rgb * 255 if rgb.max() <= 1.001 else rgb, 0, 255)
    return xyz.reshape(-1, 3), rgb_u8.reshape(-1, 3).astype(np.uint8), faces
