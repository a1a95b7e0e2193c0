"""3D layout viewer / mesh export CLI (reference layout_viewer.py surface).

Copy of horizonnet_tpu/cli/layout_viewer.py, flag for flag. Writes an
ASCII PLY (--out). Interactive open3d viewing (--vis) runs when open3d is
importable; otherwise --vis degrades to the self-contained HTML viewer
(viewer/html.py) and the headless 4-view preview PNG (viewer/render.py),
also reachable directly via --html and --vis_out:

    python -m horizonnet_tpu_torch.cli.layout_viewer --img pano.png \
        --layout out/pano.json --out pano.ply --html pano.html \
        --vis_out pano.preview.png

The texture is read by utils/image.py::load_pano (a PNG at 1024x512 with
numpy alone; other formats and the BICUBIC resize through Pillow) and the
preview is written by write_png.
"""

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--img", required=True, help="texture pano")
    parser.add_argument("--layout", required=True,
                        help="inference json ({z0,z1,uv}) or GT corner txt")
    parser.add_argument("--out", help="output .ply path")
    parser.add_argument("--vis", action="store_true",
                        help="open3d interactive view (requires open3d; "
                             "falls back to --vis_out rendering when "
                             "open3d is absent)")
    parser.add_argument("--vis_out", default=None,
                        help="write a headless 4-view preview PNG of the "
                             "textured layout (viewer/render.py; no GUI "
                             "or open3d needed)")
    parser.add_argument("--html", default=None,
                        help="write a self-contained interactive WebGL "
                             "viewer (viewer/html.py; opens from disk in "
                             "any browser, no GUI stack or open3d needed)")
    parser.add_argument("--ignore_floor", action="store_true")
    parser.add_argument("--ignore_ceiling", action="store_true")
    parser.add_argument("--ignore_wall", action="store_true")
    parser.add_argument("--ignore_wireframe", action="store_true",
                        help="skip the red corner-edge wireframe in --vis")
    args = parser.parse_args(argv)

    from ..utils.image import load_pano, write_png
    from ..viewer.mesh import layout_to_mesh, write_ply, corner_wireframe

    img = load_pano(args.img).astype(np.float32) / 255.0
    H, W = img.shape[:2]

    if args.layout.endswith("json"):
        with open(args.layout) as f:
            dt = json.load(f)
        cor_id = np.array(dt["uv"], np.float32) * [W, H]
    else:
        with open(args.layout) as f:
            cor_id = np.array([l.split() for l in f], np.float32)

    xyz, rgb, faces = layout_to_mesh(
        cor_id, img, args.ignore_floor, args.ignore_ceiling, args.ignore_wall)

    if args.out:
        write_ply(args.out, xyz, rgb, faces)
        print(f"wrote {args.out}: {len(xyz)} vertices, {len(faces)} faces")
    vis_out = args.vis_out
    html_out = args.html
    has_open3d = False
    if args.vis:
        try:
            import open3d  # noqa: F401
            has_open3d = True
        except ImportError:
            if html_out is None:
                # No GUI stack in this environment: degrade to the
                # self-contained HTML viewer, which is still INTERACTIVE
                # (orbit/zoom in any browser), plus the headless preview
                html_out = args.img + ".viewer.html"
                print("open3d not available; writing interactive HTML "
                      f"viewer to {html_out} instead (see also --html / "
                      "--vis_out)", file=sys.stderr)
            if vis_out is None:
                vis_out = args.img + ".preview.png"
    if html_out:
        from ..viewer.html import write_html_viewer
        from ..viewer.mesh import grid_triangulate, layout_to_points
        wf = None
        if not args.ignore_wireframe:
            pts, lines, _ = corner_wireframe(cor_id, H, W)
            wf = (pts, lines)
        # Decimate the pixel grid 2x before triangulating (holes-free,
        # unlike dropping faces) to bound the embedded payload
        xyz_g, rgb_g, mask = layout_to_points(
            cor_id, img, args.ignore_floor, args.ignore_ceiling,
            args.ignore_wall)
        s = 2
        faces_d = grid_triangulate(mask[::s, ::s])
        nv, nf = write_html_viewer(
            html_out, xyz_g[::s, ::s].reshape(-1, 3),
            rgb_g[::s, ::s].reshape(-1, 3), faces_d, wireframe=wf)
        print(f"wrote {html_out}: interactive viewer, {nv} vertices, "
              f"{nf} faces")
    if vis_out:
        from ..viewer.render import render_layout_views
        strip = render_layout_views(xyz, rgb)
        write_png(vis_out, strip)
        print(f"wrote {vis_out}: 4-view preview {strip.shape[1]}x"
              f"{strip.shape[0]}")
    if args.vis and has_open3d:
        import open3d as o3d
        mesh = o3d.geometry.TriangleMesh(
            o3d.utility.Vector3dVector(xyz),
            o3d.utility.Vector3iVector(faces))
        mesh.vertex_colors = o3d.utility.Vector3dVector(rgb / 255.0)
        geoms = [mesh]
        if not args.ignore_wireframe:
            pts, lines, colors = corner_wireframe(cor_id, H, W)
            wf = o3d.geometry.LineSet()
            wf.points = o3d.utility.Vector3dVector(pts)
            wf.lines = o3d.utility.Vector2iVector(lines)
            wf.colors = o3d.utility.Vector3dVector(colors)
            geoms.append(wf)
        o3d.visualization.draw_geometries(geoms, mesh_show_back_face=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
