"""Dataset sanity-check CLI: render GT targets over panos.

Copy of horizonnet_tpu/cli/dataset_vis.py (reference surface:
dataset.py:232-279 __main__, the documented "check your dataset" step,
README_PREPARE_DATASET.md:35), plus ``--device`` (default cuda; a missing
CUDA device is an error). With any of --flip/--rotate/--gamma/--stretch
the sample goes through data/dataset.py::make_training_batch, whose
augmentation warp runs on ``--device``:

    python -m horizonnet_tpu_torch.cli.dataset_vis --root_dir data/valid \\
        --ith -1 --flip --rotate --gamma --stretch --out_dir vis

The strips of PNG panos are written by utils/image.py::write_png, those of
JPEG panos by Pillow, imported on that path only.
"""

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--root_dir", default="data/valid/")
    parser.add_argument("--ith", default=0, type=int,
                        help="sample index to visualize; -1 for all")
    parser.add_argument("--flip", action="store_true")
    parser.add_argument("--rotate", action="store_true")
    parser.add_argument("--gamma", action="store_true")
    parser.add_argument("--stretch", action="store_true")
    parser.add_argument("--out_dir", default="sample_dataset_visualization")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the augmentation warp; a "
                             "missing CUDA device is an error")
    args = parser.parse_args(argv)

    import numpy as np
    from ..data.dataset import PanoCorBonDataset, make_training_batch
    from ..inference import resolve_device
    from ..utils.image import write_png
    from ..viewer.visualize import visualize_a_data

    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    print("args:")
    for key, val in vars(args).items():
        print(f"    {key:16} {val}")

    dataset = PanoCorBonDataset(
        root_dir=args.root_dir, flip=args.flip, rotate=args.rotate,
        gamma=args.gamma, stretch=args.stretch, return_path=True)
    print(f"len(dataset): {len(dataset)}")

    indices = [args.ith] if args.ith >= 0 else range(len(dataset))
    rng = np.random.default_rng()
    use_aug = args.flip or args.rotate or args.gamma or args.stretch
    for i in indices:
        if use_aug:
            x, bon, y_cor = make_training_batch(dataset, [i], rng,
                                                device=device)
            x = x[0].cpu().numpy()
            bon, y_cor = bon[0], y_cor[0]
            path = dataset.img_fnames[i]
        else:
            x, bon, y_cor, path = dataset[i]
            path = os.path.split(path)[-1]
        out = visualize_a_data(x, bon, y_cor[0])
        fname = os.path.split(path)[-1]
        if fname.endswith(".png"):
            write_png(os.path.join(args.out_dir, fname), out)
        else:   # a JPEG dataset: its strips keep the JAX CLI's format
            from PIL import Image
            Image.fromarray(out).save(os.path.join(args.out_dir, fname))
        print(fname, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
