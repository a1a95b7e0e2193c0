"""Zillow Indoor (ZInD) dataset preparation.

Copy of horizonnet_tpu/cli/prepare_zind.py. ZInD's panos are JPEGs: the
decode, the LANCZOS resize and the JPEG save go through Pillow, imported
in the worker that converts a scene, as every non-PNG path of the port.

Reference surface: misc/zind_prepare_dataset.py. Converts each pano's
``merger`` layout tree into the corner-txt format consumed by
PanoCorBonDataset, filtered by the layout_visible / is_primary /
is_inside / is_ceiling_flat flags. The output files (jpg re-encode
settings, txt number formatting, filename scheme) are bit-identical to
the reference's so prepared datasets interchange; this implementation
also fixes the reference's swapped-argument bug on the non-parallel
path (zind_prepare_dataset.py:105).
"""

import argparse
import functools
import json
import multiprocessing
import os
import sys

import numpy as np


def iter_pano_entries(zind_json):
    """Walk the 4-level merger tree, yielding one record per pano."""
    for floor_id, rooms in zind_json["merger"].items():
        for complete_room in rooms.values():
            for partial_room_id, panos in complete_room.items():
                for pano_id, pano in panos.items():
                    yield floor_id, partial_room_id, pano_id, pano


def _flag_ok(value, wanted):
    """Tri-state filter: wanted is -1 (any) / 0 (false only) / 1 (true)."""
    return wanted == -1 or bool(value) == bool(wanted)


def corner_rows(pano, geometry, width):
    """Project a pano's layout vertices to interleaved pixel corner rows.

    Returns the list of "x y" text lines (ceiling above floor per vertex)
    in the exact numeric format of the reference output files.
    """
    z_floor = -pano["camera_height"]
    z_ceil = pano["ceiling_height"] - pano["camera_height"]
    verts = np.asarray(pano[geometry]["vertices"], np.float64)

    azimuth = np.arctan2(-verts[:, 0], verts[:, 1])
    plan_dist = np.hypot(verts[:, 0], verts[:, 1])
    col = (azimuth + np.pi) / (2.0 * np.pi) * (width - 1)

    half_h = width / 2 - 1
    def to_row(z):
        elevation = np.arctan2(z, plan_dist)
        return (1 - (elevation + np.pi / 2.0) / np.pi) * half_h

    row_ceil, row_floor = to_row(z_ceil), to_row(z_floor)
    lines = []
    for c, rc, rf in zip(col, row_ceil, row_floor):
        lines.append(f"{c:.1f} {rc:.1f}")
        lines.append(f"{c:.1f} {rf:.1f}")
    return lines


def convert_scene(scene_id, split, args):
    from PIL import Image

    with open(os.path.join(args.indir, scene_id, "zind_data.json")) as f:
        zind_json = json.load(f)
    for floor_id, partial_room_id, pano_id, pano in \
            iter_pano_entries(zind_json):
        if args.geometry not in pano:
            continue
        if not (_flag_ok(pano["is_primary"], args.is_primary)
                and _flag_ok(pano["is_inside"], args.is_inside)
                and _flag_ok(pano.get("is_ceiling_flat", False),
                             args.is_ceiling_flat)):
            continue
        key = f"{floor_id}_{partial_room_id}_{pano_id}"
        src = os.path.join(args.indir, scene_id, "panos", f"{key}.jpg")
        assert os.path.isfile(src), f"Image not found {src}"

        img = Image.open(src).resize((args.width, args.width // 2),
                                     Image.LANCZOS)
        img.save(os.path.join(args.outdir, split, "img",
                              f"{scene_id}_{key}.jpg"),
                 quality=95, optimize=True)
        with open(os.path.join(args.outdir, split, "label_cor",
                               f"{scene_id}_{key}.txt"), "w") as f:
            f.write("\n".join(corner_rows(pano, args.geometry, args.width)))
            f.write("\n")


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--partition", default="zind_partition.json")
    parser.add_argument("--indir", default="data/")
    parser.add_argument("--outdir", default="zind_horizonnet/")
    parser.add_argument("--width", default=1024, type=int)
    parser.add_argument("--geometry", default="layout_visible")
    parser.add_argument("--is_primary", default=1, choices=[-1, 0, 1], type=int)
    parser.add_argument("--is_inside", default=1, choices=[-1, 0, 1], type=int)
    parser.add_argument("--is_ceiling_flat", default=1, choices=[-1, 0, 1],
                        type=int)
    parser.add_argument("--num_workers", default=10, type=int)
    args = parser.parse_args(argv)

    assert os.path.isfile(args.partition), \
        f"Partition not found: {args.partition}"
    assert os.path.exists(args.indir), f"Dir not found: {args.indir}"
    with open(args.partition) as f:
        partition = json.load(f)

    for split, scene_ids in partition.items():
        os.makedirs(os.path.join(args.outdir, split, "img"), exist_ok=True)
        os.makedirs(os.path.join(args.outdir, split, "label_cor"),
                    exist_ok=True)
        print(f"Processing split: {split}", flush=True)
        if args.num_workers > 1:
            fn = functools.partial(convert_scene, split=split, args=args)
            with multiprocessing.Pool(args.num_workers) as pool:
                for _ in pool.imap(fn, scene_ids):
                    pass
        else:
            for scene_id in scene_ids:
                convert_scene(scene_id, split, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
