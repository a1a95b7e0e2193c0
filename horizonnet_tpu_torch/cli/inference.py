"""Inference CLI: glob of aligned panos -> {z0, z1, uv} JSON per pano.

Counterpart of horizonnet_tpu/cli/inference.py (reference inference.py:
144-223), flag for flag, on the fused device path:

    python -m horizonnet_tpu_torch.cli.inference --pth model.ckpt \\
        --img_glob 'panos/*.png' --output_dir out \\
        --device_postproc [--force_cuboid] [--device cuda]

With --force_cuboid the device fits a cuboid and only [B, 17] corners
and z1 come back; without it the device computes the general-layout
candidates and a worker thread runs the greedy wall commitment on them
(postproc.finish_general_batch), as the JAX CLI does.

``--lstm_impl``: ``pallas`` runs the CUDA kernel (csrc/bilstm_fwd.cu),
``scan`` the plain PyTorch loop, ``auto`` the kernel on a CUDA device.
``--s2d_stem`` is accepted and runs the standard stem: the space-to-depth
stem is the same math rearranged for the TPU's matrix unit. Paths still
to port raise NotImplementedError naming their ROADMAP item: the host
postprocess (no --device_postproc, and --force_raw / --visualize /
--min_v / --r overrides), --quant_int8 and --profile_dir.
"""

import argparse
import glob
import json
import os
import sys

import numpy as np

LSTM_IMPLS = {"pallas": "kernel", "scan": "plain"}


def main(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--pth", required=True,
                        help="checkpoint (.ckpt of horizonnet_tpu)")
    parser.add_argument("--img_glob", required=True,
                        help="quoted glob of VP-aligned input panos")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--flip", action="store_true",
                        help="left-right flip test-time augmentation")
    parser.add_argument("--rotate", nargs="*", default=[], type=float,
                        help="horizontal rotation TTA (fractions of width)")
    parser.add_argument("--r", default=0.05, type=float)
    parser.add_argument("--min_v", default=None, type=float)
    parser.add_argument("--force_cuboid", action="store_true")
    parser.add_argument("--force_raw", action="store_true")
    parser.add_argument("--device_postproc", action="store_true",
                        help="fuse the Manhattan post-processing into the "
                             "device program (cuboid or general per "
                             "--force_cuboid); only the packed fit or "
                             "candidates cross back per batch")
    parser.add_argument("--batch_size", default=4, type=int,
                        help="panos per device step")
    parser.add_argument("--wire", default="uint8",
                        choices=["float", "uint8", "dct"],
                        help="host->device upload format: uint8 panos, "
                             "the compressed zig-zag DCT wire (ops/dct.py) "
                             "or float")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute for the forward pass")
    parser.add_argument("--s2d_stem", action="store_true",
                        help="accepted; the port runs the standard stem "
                             "(same math)")
    parser.add_argument("--quant_int8", action="store_true")
    parser.add_argument("--lstm_impl", default="auto",
                        choices=["auto", "scan", "pallas"],
                        help="LSTM recurrence: pallas = the CUDA kernel, "
                             "scan = the plain PyTorch loop, auto = the "
                             "kernel on a CUDA device")
    parser.add_argument("--profile_dir", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on; a missing CUDA "
                             "device is an error")
    args = parser.parse_args(argv)

    if not args.device_postproc or args.force_raw or args.visualize \
            or args.min_v is not None or args.r != 0.05:
        raise NotImplementedError(
            "the host postprocess path (no --device_postproc, or "
            "--force_raw/--visualize/--min_v/--r) is ROADMAP Queue 1 item 6")
    if args.quant_int8:
        raise NotImplementedError("--quant_int8 is ROADMAP Queue 1 item 7")
    if args.profile_dir:
        raise NotImplementedError("--profile_dir (torch.profiler) is ROADMAP "
                                  "Queue 1 item 11")

    import torch

    from ..inference import InferenceEngine, resolve_device, serve_stream
    from ..postproc import finish_general_batch, unpack_cuboid_outputs
    from ..train.checkpoint import load_trained_model
    from ..utils.image import load_pano

    device = resolve_device(args.device)
    paths = sorted(glob.glob(args.img_glob))
    if len(paths) == 0:
        print("no images found", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)

    lstm_impl = LSTM_IMPLS.get(args.lstm_impl, "kernel")
    model, state_dict = load_trained_model(
        args.pth, device=device,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        lstm_impl=lstm_impl)
    engine = InferenceEngine(model, state_dict, batch_size=args.batch_size,
                             flip=args.flip, rotate=args.rotate,
                             postproc="cuboid" if args.force_cuboid
                             else "general", input_format=args.wire,
                             device=device)

    chunks = [paths[i:i + args.batch_size]
              for i in range(0, len(paths), args.batch_size)]

    def packed_batches():
        """Lazy ingest, consumed by serve_stream: reading and packing the
        next chunks overlaps the device work of the current one."""
        for chunk in chunks:
            x = np.stack([load_pano(p) for p in chunk])
            # fixed-batch engine: pad the tail chunk with repeats
            if len(chunk) < args.batch_size:
                x = np.concatenate(
                    [x, np.repeat(x[-1:], args.batch_size - len(chunk), 0)])
            if args.wire == "dct":
                from ..ops.dct import pack_dct
                x = pack_dct(x)
            elif args.wire == "float":
                x = x.astype(np.float32) / 255.0
            yield x

    def finish(outs):
        if not args.force_cuboid:
            return finish_general_batch(outs)
        cid, z1 = unpack_cuboid_outputs(outs)
        return [(cid[b], 50.0, float(z1[b])) for b in range(len(cid))]

    for chunk, results in zip(chunks, serve_stream(
            engine, packed_batches(), depth=3, finish=finish)):
        for path, (cor_id, z0, z1) in zip(chunk, results):
            k = os.path.split(path)[-1][:-4]
            with open(os.path.join(args.output_dir, k + ".json"), "w") as f:
                json.dump({"z0": float(z0), "z1": float(z1),
                           "uv": [[float(u), float(v)] for u, v in cor_id]},
                          f)
            print(k, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
