"""Inference CLI: glob of aligned panos -> {z0, z1, uv} JSON per pano.

Counterpart of horizonnet_tpu/cli/inference.py (reference inference.py:
144-223), flag for flag, plus ``--device`` (default cuda; a missing CUDA
device is an error):

    python -m horizonnet_tpu_torch.cli.inference --pth model.ckpt \\
        --img_glob 'panos/*.png' --output_dir out [--force_cuboid] \\
        [--device_postproc] [--visualize] [--device cuda]

``--pth`` takes a ``.ckpt`` of either package or a reference ``.pth``.
By default each chunk of --batch_size panos runs the forward on the
device and the host postprocess per pano (inference.py::inference, the
JAX host path in float64); --visualize also writes ``<name>.raw.png``,
the raw-output strip at half size. With --device_postproc the layout
fit runs on the device: with --force_cuboid only [B, 17] corners and z1
come back; without it the device computes the general-layout candidates
and a worker thread runs the greedy wall commitment on them
(postproc.finish_general_batch). --force_raw, --visualize, --min_v and
--r overrides take the host path, with a warning, as the JAX CLI does.

``--lstm_impl``: ``pallas`` runs the CUDA kernel (csrc/bilstm_fwd.cu),
``scan`` the plain PyTorch loop, ``auto`` the kernel on a CUDA device.
``--s2d_stem`` is accepted and runs the standard stem: the space-to-depth
stem is the same math rearranged for the TPU's matrix unit.
``--quant_int8`` serves the int8 resnet encoder (models/quant.py folds the
loaded weights; the height stage and the head stay float), on the host
path and with --device_postproc; with --s2d_stem it is refused, as in
JAX. ``--profile_dir`` runs the serving under torch.profiler (the CUDA
activity on a CUDA device only) and writes one Chrome trace,
``*.pt.trace.json``, into the directory, with the JAX CLI's spans:
serve/ingest, serve/forward+postproc (host path) and serve/general_finish
(the general tail on serve_stream's worker threads), beside the
program's own (utils/profiling.py: an open profiler session turns them
on). On a CUDA device every engine, the host path's included, captures
its program once as a CUDA graph and replays it a batch
(inference.py::InferenceEngine).
"""

import argparse
import contextlib
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
                        help="checkpoint (.ckpt ours or reference .pth)")
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
                             "candidates cross back per batch. "
                             "Incompatible with --force_raw/--visualize/"
                             "--min_v/--r overrides (those take the host "
                             "path)")
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
    parser.add_argument("--quant_int8", action="store_true",
                        help="post-training int8 quantization of the "
                             "resnet encoder (BN folded, int8 x int8 -> "
                             "int32 products); the head stays float")
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

    import torch

    from ..inference import resolve_device
    from ..models import build_model
    from ..models.quant import quantize_state_dict
    from ..train.checkpoint import load_trained_model

    device = resolve_device(args.device)
    paths = sorted(glob.glob(args.img_glob))
    if len(paths) == 0:
        print("no images found", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)

    lstm_impl = LSTM_IMPLS.get(args.lstm_impl, "kernel")
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, state_dict = load_trained_model(
        args.pth, device=device, dtype=dtype, lstm_impl=lstm_impl)
    if args.quant_int8:
        # the JAX CLI's serving-time rebuild: the int8 encoder takes the
        # folded weights (build_model refuses it beside --s2d_stem)
        model = build_model(model.backbone, model.use_rnn, device=device,
                            dtype=dtype, lstm_impl=lstm_impl,
                            seam_pool=model.seam_pool, quant_int8=True,
                            s2d_stem=args.s2d_stem)
        state_dict = quantize_state_dict(state_dict)
        model.load_state_dict(state_dict)
    if args.profile_dir:
        from ..utils.profiling import trace_profile
        profile_cm = trace_profile(device, args.profile_dir)
    else:
        profile_cm = contextlib.nullcontext()
    with profile_cm:
        _serve(paths, args, model, state_dict, device)
    return 0


def _serve(paths, args, model, state_dict, device):
    from ..inference import InferenceEngine, inference, serve_stream
    from ..postproc import finish_general_batch, unpack_cuboid_outputs
    from ..utils.image import load_pano
    from ..utils import profiling

    use_device_pp = (args.device_postproc and not args.force_raw
                     and not args.visualize and args.min_v is None
                     and args.r == 0.05)
    if args.device_postproc and not use_device_pp:
        print("[WARN] --device_postproc ignored: "
              "--force_raw/--visualize/--min_v/--r take the host path",
              file=sys.stderr)

    chunks = [paths[i:i + args.batch_size]
              for i in range(0, len(paths), args.batch_size)]

    def write_results(chunk, results):
        for path, (cor_id, z0, z1, vis) in zip(chunk, results):
            k = os.path.split(path)[-1][:-4]
            with open(os.path.join(args.output_dir, k + ".json"), "w") as f:
                json.dump({"z0": float(z0), "z1": float(z1),
                           "uv": [[float(u), float(v)] for u, v in cor_id]},
                          f)
            if vis is not None:
                from PIL import Image
                vh, vw = vis.shape[:2]
                Image.fromarray(vis).resize((vw // 2, vh // 2),
                                            Image.LANCZOS).save(
                    os.path.join(args.output_dir, k + ".raw.png"))
            print(k, flush=True)

    if not use_device_pp:
        # on the card each batch shape costs an engine's warm-up and
        # capture: after full chunks, the tail pads to --batch_size and
        # reuses their engine
        pad_to = (args.batch_size if device.type == "cuda" and len(chunks) > 1
                  else None)
        for chunk in chunks:
            with profiling.span("serve/ingest"):
                x = np.stack([load_pano(p) for p in chunk])
            x = x.astype(np.float32) / 255.0
            with profiling.span("serve/forward+postproc"):
                results = inference(
                    model, state_dict, x, flip=args.flip, rotate=args.rotate,
                    visualize=args.visualize, force_cuboid=args.force_cuboid,
                    force_raw=args.force_raw, min_v=args.min_v, r=args.r,
                    batch_size=pad_to)
            write_results(chunk, results)
        return

    engine = InferenceEngine(model, state_dict, batch_size=args.batch_size,
                             flip=args.flip, rotate=args.rotate,
                             postproc="cuboid" if args.force_cuboid
                             else "general", input_format=args.wire,
                             device=device)

    def packed_batches():
        """Lazy ingest, consumed by serve_stream: reading and packing the
        next chunks overlaps the device work of the current one."""
        for chunk in chunks:
            with profiling.span("serve/ingest"):
                x = np.stack([load_pano(p) for p in chunk])
                # fixed-batch engine: pad the tail chunk with repeats
                if len(chunk) < args.batch_size:
                    x = np.concatenate(
                        [x, np.repeat(x[-1:], args.batch_size - len(chunk),
                                      0)])
                if args.wire == "dct":
                    from ..ops.dct import pack_dct
                    x = pack_dct(x)
                elif args.wire == "float":
                    x = x.astype(np.float32) / 255.0
            yield x

    def finish(outs):
        if not args.force_cuboid:
            with profiling.span("serve/general_finish"):
                return [(c, z0, z1, None)
                        for c, z0, z1 in finish_general_batch(outs)]
        cid, z1 = unpack_cuboid_outputs(outs)
        return [(cid[b], 50.0, float(z1[b]), None) for b in range(len(cid))]

    for chunk, results in zip(chunks, serve_stream(
            engine, packed_batches(), depth=3, finish=finish)):
        write_results(chunk, results[:len(chunk)])


if __name__ == "__main__":
    sys.exit(main())
