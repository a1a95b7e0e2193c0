"""Structured3D dataset preparation: zip extraction, reorganization, listing.

Copy of horizonnet_tpu/cli/prepare_structured3d.py, flag for flag. The
JAX CLI decodes and re-encodes the panos with imageio; here the PNG bytes
decode with utils/image.py::decode_png and are written with write_png
(numpy and zlib; the pixels are the same, the file bytes are not). A PNG
variant that reader refuses, or one without 3 or 4 channels, raises an
error that names the zip member.

Reference surface: misc/structured3d_extract_zip.py,
misc/structured3d_prepare_dataset.py, misc/gen_txt_structured3d.py.
Subcommands:
  extract  — pull rgb_rawlight panos + layout txts out of a Structured3D zip
  prepare  — symlink-reorganize into {img, label_cor} train/valid/test roots
             using the standard 3000/250/250 scene split
  gen_txt  — write (img, layout) pair listings per split
"""

import argparse
import os
import sys
from zipfile import ZipFile

TRAIN_SCENE = ["scene_%05d" % i for i in range(0, 3000)]
VALID_SCENE = ["scene_%05d" % i for i in range(3000, 3250)]
TEST_SCENE = ["scene_%05d" % i for i in range(3250, 3500)]


def cmd_extract(args):
    from ..utils.image import decode_png, write_png

    fmt = "Structured3D/%s/2D_rendering/%s/panorama/%s"
    with ZipFile(args.zippath) as zipf:
        ids = set()
        for path in zipf.namelist():
            assert path.startswith("Structured3D")
            if path.endswith("camera_xyz.txt"):
                parts = path.split("/")
                ids.add((parts[1], parts[3]))
        for scene_id, image_id in sorted(ids):
            os.makedirs(os.path.join(args.outdir, scene_id, "rgb"),
                        exist_ok=True)
            os.makedirs(os.path.join(args.outdir, scene_id, "layout"),
                        exist_ok=True)
            member = fmt % (scene_id, image_id,
                            f"{args.style}/rgb_rawlight.png")
            with zipf.open(member) as f:
                rgb = decode_png(f.read(), f"{args.zippath}:{member}")
            if rgb.shape[2] not in (3, 4):
                raise ValueError(f"{args.zippath}:{member}: an RGB or RGBA "
                                 f"pano expected, got {rgb.shape[2]} "
                                 "channel(s)")
            write_png(os.path.join(args.outdir, scene_id, "rgb",
                                   image_id + "_rgb_rawlight.png"),
                      rgb[..., :3])
            with zipf.open(fmt % (scene_id, image_id, "layout.txt")) as f:
                with open(os.path.join(args.outdir, scene_id, "layout",
                                       image_id + "_layout.txt"), "w") as fo:
                    fo.write(f.read().decode())
            print(scene_id, image_id, flush=True)


def _link_split(in_root, scene_ids, out_dir):
    root_img = os.path.join(out_dir, "img")
    root_cor = os.path.join(out_dir, "label_cor")
    os.makedirs(root_img, exist_ok=True)
    os.makedirs(root_cor, exist_ok=True)
    for scene_id in scene_ids:
        cor_root = os.path.join(in_root, scene_id, "layout")
        if not os.path.isdir(cor_root):
            continue
        for fname in os.listdir(cor_root):
            room_id = fname.split("_")[0]
            src_img = os.path.join(in_root, scene_id, "rgb",
                                   room_id + "_rgb_rawlight.png")
            src_cor = os.path.join(cor_root, room_id + "_layout.txt")
            assert os.path.isfile(src_img), src_img
            assert os.path.isfile(src_cor), src_cor
            os.symlink(os.path.abspath(src_img),
                       os.path.join(root_img, f"{scene_id}_{room_id}.png"))
            os.symlink(os.path.abspath(src_cor),
                       os.path.join(root_cor, f"{scene_id}_{room_id}.txt"))


def cmd_prepare(args):
    _link_split(args.in_root, TRAIN_SCENE, args.out_train_root)
    _link_split(args.in_root, VALID_SCENE, args.out_valid_root)
    _link_split(args.in_root, TEST_SCENE, args.out_test_root)


def cmd_gen_txt(args):
    def gen_pairs(scene_ids):
        pairs = []
        for scene_id in scene_ids:
            rgb_dir = os.path.join(args.root, scene_id, "rgb")
            if not os.path.isdir(rgb_dir):
                continue  # scene absent from this extraction
            for fname in os.listdir(rgb_dir):
                room_id = fname.split("_")[0]
                img_k = os.path.join(scene_id, "rgb", fname)
                layout_k = os.path.join(scene_id, "layout",
                                        room_id + "_layout.txt")
                assert os.path.isfile(os.path.join(args.root, img_k))
                assert os.path.isfile(os.path.join(args.root, layout_k))
                pairs.append((img_k, layout_k))
        return pairs

    for out, scenes in [(args.train_txt, TRAIN_SCENE),
                        (args.valid_txt, VALID_SCENE),
                        (args.test_txt, TEST_SCENE)]:
        with open(out, "w") as f:
            f.write("\n".join(" ".join(p) for p in gen_pairs(scenes)))


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("extract")
    p.add_argument("--zippath", required=True)
    p.add_argument("--style", default="full")
    p.add_argument("--outdir", default="structured3d")
    p.set_defaults(fn=cmd_extract)

    p = sub.add_parser("prepare")
    p.add_argument("--in_root", required=True)
    p.add_argument("--out_train_root", default="data/st3d_train_full_raw_light")
    p.add_argument("--out_valid_root", default="data/st3d_valid_full_raw_light")
    p.add_argument("--out_test_root", default="data/st3d_test_full_raw_light")
    p.set_defaults(fn=cmd_prepare)

    p = sub.add_parser("gen_txt")
    p.add_argument("--root", required=True)
    p.add_argument("--train_txt", required=True)
    p.add_argument("--valid_txt", required=True)
    p.add_argument("--test_txt", required=True)
    p.set_defaults(fn=cmd_gen_txt)

    args = parser.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
