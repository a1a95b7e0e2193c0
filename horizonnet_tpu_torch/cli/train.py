"""Training CLI (reference train.py:61-352 surface).

Counterpart of horizonnet_tpu/cli/train.py, flag for flag, plus
``--device`` (default cuda; a missing CUDA device is an error):

    python -m horizonnet_tpu_torch.cli.train --id run1 \\
        --train_root_dir data/train --valid_root_dir data/valid \\
        --lstm_impl pallas_train --bf16 [--device cuda]

Same loop: per-update warmup-poly learning rate, an optional second "aug"
dataset filling half of each batch, per-epoch data order, augmentation
draws and dropout generator from (seed, epoch), so a --resume'd run sees
the batches of an unbroken one, a prefetch thread that builds the next
batch while the current step trains, per-epoch validation (``validate``:
losses and the true 2D/3D IoU, rmse and delta_1 of the raw-polygon
postprocess), ``checkpoint.ckpt`` with the best 3DIoU (and
``best_model_<epoch>.ckpt`` when it improves), which --resume reads, and
model checkpoints every --save_every epochs. ``--valid_root_dir ''``
trains without validation, and then writes no checkpoint.ckpt. On one
card the train step and the validation forward each run as a CUDA graph
captured once (train/engine.py, inference.py); the epoch's new dropout
generator carries into the captured step.

``--model lgt`` trains LGT-Net (models/lgt.py: the same encoders, the
SWG-Transformer and the horizon-depth head) on the same datasets, with
horizon-depth and ratio labels made from the corners
(data/labels.py::horizon_depth) and its loss (models/lgt.py::
loss_terms); ``--backbone`` picks its encoder and ``--no_rnn``,
``--lstm_impl`` do not apply. Its validation is the eval-mode loss
(``validate_lgt``; serving LGT-Net is not ported, so there are no IoUs),
and the best checkpoint is the one of the least validation loss.

``--lstm_impl``: ``pallas_train`` runs the CUDA pair K2/K3
(csrc/bilstm_train.cu) in training and K1 in the validation forward (the
JAX model's eval mode takes the serving kernel), ``scan`` autograd
through the plain loop. ``--backbone`` takes the resnet and densenet
encoders; ``--seam_pool`` wrap-pads the stem's max pool. ``--s2d_stem``
is accepted and runs the standard stem (the same math rearranged for the
TPU's matrix unit).

Several ranks: under ``torchrun`` (which sets WORLD_SIZE) every rank
joins the process group (parallel/mesh.py::init_distributed: NCCL when
each rank has a card of its own, gloo when ranks share one or run on the
CPU) and trains on a (world / n_model, n_model) mesh: DDP with global
batch statistics over 'data', the encoder's and height stage's
conv + batch-norm units split by output channel over 'model'
(``--n_model``, parallel/sharding.py):

    torchrun --nproc_per_node 2 -m horizonnet_tpu_torch.cli.train \
        --id run1 --n_model 2 [--device cpu] ...

Every rank draws the same epoch order and dropout masks and takes its
rows of each global batch, the validation set is split over the ranks,
and rank 0 prints and writes the checkpoints (whole: the shards are
gathered first). ``--n_model`` must divide the world and n_data the
global batch, else the CLI raises: JAX quietly trains on fewer devices
(the largest count that divides the batch), but a torchrun rank cannot
sit idle.
"""

import argparse
import os
import sys

import numpy as np

LSTM_IMPLS = {"scan": "plain", "pallas_train": "kernel_train"}
VALID_METRICS = ("bon", "cor", "total", "2DIoU", "3DIoU", "rmse", "delta_1")


def build_argparser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--id", required=True,
                        help="experiment id for checkpoints and logs")
    parser.add_argument("--ckpt", default="./ckpt")
    parser.add_argument("--logs", default="./logs")
    parser.add_argument("--pth", default=None,
                        help="checkpoint to finetune from (weights only, "
                             "fresh optimizer — reference --pth semantics)")
    parser.add_argument("--resume", default=None,
                        help="training checkpoint (or its ckpt dir) to "
                             "resume from: restores params, BN stats, "
                             "optimizer state, epoch and best score")
    parser.add_argument("--model", default="horizonnet",
                        choices=["horizonnet", "lgt"],
                        help="HorizonNet, or LGT-Net (SWG-Transformer "
                             "head) on the same encoder")
    parser.add_argument("--backbone", default="resnet50")
    parser.add_argument("--no_rnn", action="store_true")
    parser.add_argument("--train_root_dir",
                        default="data/layoutnet_dataset/train")
    parser.add_argument("--train_aug_root_dir", default=None)
    parser.add_argument("--valid_root_dir",
                        default="data/layoutnet_dataset/valid",
                        help="'' disables validation")
    parser.add_argument("--no_flip", action="store_true")
    parser.add_argument("--no_rotate", action="store_true")
    parser.add_argument("--no_gamma", action="store_true")
    parser.add_argument("--no_pano_stretch", action="store_true")
    parser.add_argument("--freeze_earlier_blocks", default=-1, type=int)
    parser.add_argument("--batch_size_train", default=8, type=int)
    parser.add_argument("--batch_size_valid", default=2, type=int)
    parser.add_argument("--epochs", default=300, type=int)
    parser.add_argument("--optim", default="Adam")
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--lr_pow", default=0.9, type=float)
    parser.add_argument("--warmup_lr", default=1e-6, type=float)
    parser.add_argument("--warmup_epochs", default=0, type=int)
    parser.add_argument("--beta1", default=0.9, type=float)
    parser.add_argument("--weight_decay", default=0, type=float)
    parser.add_argument("--bn_momentum", default=None, type=float,
                        help="override BatchNorm running-stat momentum")
    parser.add_argument("--num_workers", default=2, type=int,
                        help="batch-prefetch worker threads (0 = sync)")
    parser.add_argument("--wire", default="uint8",
                        choices=["uint8", "dct", "dct4"],
                        help="training-batch upload format: raw uint8 "
                             "pixels, or the compressed dct / dct4 wire "
                             "(ops/dct.py), decoded on the device before "
                             "the augmentation warp")
    parser.add_argument("--n_model", default=1, type=int,
                        help="tensor-parallel axis size under torchrun "
                             "(conv channels split per "
                             "parallel/sharding.py)")
    parser.add_argument("--lstm_impl", default="scan",
                        choices=["scan", "pallas_train"],
                        help="LSTM recurrence in the train step: autograd "
                             "through the plain loop, or the CUDA kernel "
                             "pair K2/K3")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (f32 params)")
    parser.add_argument("--s2d_stem", action="store_true",
                        help="accepted; the port runs the standard stem "
                             "(same math)")
    parser.add_argument("--seed", default=594277, type=int)
    parser.add_argument("--save_every", default=25, type=int)
    parser.add_argument("--seam_pool", action="store_true",
                        help="wrap-padded maxpool: exact seam equivariance "
                             "(train from scratch; the reference pools "
                             "with edge padding)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on; a missing CUDA "
                             "device is an error")
    return parser


def epoch_seed(seed, epoch):
    """64-bit seed of an epoch's dropout generator, from (seed, epoch) as
    the epoch's numpy RNG."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(
        1, np.uint64)[0] >> 1)


def validate(engine, dataset, batch_size, indices=None):
    """One validation pass, as the JAX CLI's (horizonnet_tpu/cli/train.py:
    272-349): the forward batched at ``batch_size`` through the fixed-batch
    InferenceEngine ``engine`` (the tail chunk padded with repeats), then
    per sample on the host the boundary L1 and the corner BCE (from the
    sigmoid probabilities, clipped to [1e-7, 1 - 1e-7]) and the general
    metrics of postprocess(force_raw=True), scaled by [1024, 512], against
    the ground truth. ``dataset`` yields (img, y_bon, y_cor, gt_cor)
    (return_cor=True). A sample whose forward or postprocess fails gets
    placeholder metrics, and each chunk that had one prints a [WARN] line
    (so, as in the JAX CLI, a width other than postprocess's 1024 gives
    placeholders). Returns the means over the dataset (or its samples
    ``indices``) of {"bon", "cor", "total", "2DIoU", "3DIoU", "rmse",
    "delta_1"}, none for no samples."""
    from ..evals import new_general_losses, test_general
    from ..inference import postprocess

    def fetch(outs):
        return [o.float().cpu().numpy() for o in outs]

    valid_loss = {}
    bsv = max(1, batch_size)
    eps = 1e-7
    indices = list(range(len(dataset)) if indices is None else indices)
    for j0 in range(0, len(indices), bsv):
        samples = [dataset[j] for j in indices[j0:j0 + bsv]]
        nb = len(samples)
        # fixed-batch engine: pad the tail chunk with repeats
        xb = np.stack([s[0] for s in samples] + [samples[-1][0]] * (bsv - nb))
        try:
            vb_all, vc_all = fetch(engine(xb))
            vc_all = np.clip(vc_all, eps, 1 - eps)
        except Exception:
            vb_all = None
        n_placeheld = 0
        for i in range(nb):
            img, y_bon, y_cor, gt_cor = samples[i]
            true_eval = new_general_losses()
            try:
                if vb_all is None:
                    # the chunk's forward failed: retry this sample alone,
                    # so one failure does not zero a whole chunk's metrics
                    x1 = np.broadcast_to(img, (bsv, *img.shape))
                    vb1, vc1 = fetch(engine(np.ascontiguousarray(x1)))
                    vb = vb1[0]
                    vp = np.clip(vc1[0], eps, 1 - eps)
                else:
                    vb, vp = vb_all[i], vc_all[i]
                # BCE from the sigmoid probabilities is BCE with logits
                bon_l = float(np.abs(vb - y_bon).mean())
                cor_l = float(-(y_cor * np.log(vp) +
                                (1 - y_cor) * np.log(1 - vp)).mean())
                losses = {"bon": bon_l, "cor": cor_l, "total": bon_l + cor_l}
                dt_cor_id, _, _ = postprocess(vb, vp[0], force_raw=True)
                dt_cor_id = dt_cor_id * [1024, 512]
            except Exception:
                n_placeheld += 1
                losses = {"bon": 0.0, "cor": 0.0, "total": 0.0}
                dt_cor_id = np.array([
                    [k // 2 * 1024, 256 - ((k % 2) * 2 - 1) * 120]
                    for k in range(8)])
            test_general(dt_cor_id, gt_cor, 1024, 512, true_eval)
            for m in ("2DIoU", "3DIoU", "rmse", "delta_1"):
                vals = true_eval["overall"][m]
                losses[m] = float(vals[0]) if vals else 0.0
            for k, v in losses.items():
                valid_loss[k] = valid_loss.get(k, 0) + v
        if n_placeheld:
            print(f"[WARN] validation: {n_placeheld}/{nb} samples in chunk "
                  f"{j0 // bsv} fell back to placeholder metrics after "
                  "forward failure", file=sys.stderr)
    return {k: v / len(indices) for k, v in valid_loss.items()}


def validate_lgt(model, dataset, batch_size, indices=None):
    """LGT-Net's validation pass: the eval-mode forward of ``model`` on
    the host-labelled samples (``dataset`` yields (img, y_bon, y_cor,
    gt_cor), return_cor=True) in batches of ``batch_size``, and the means
    of its loss terms (models/lgt.py::loss_terms) over the dataset
    (or its samples ``indices``): {"total", "depth", "ratio", "normal",
    "grad"}. The model is left in eval mode."""
    import torch

    from ..data.dataset import lgt_labels

    device = next(model.parameters()).device
    model.eval()
    indices = list(range(len(dataset)) if indices is None else indices)
    sums = {}
    for j0 in range(0, len(indices), max(1, batch_size)):
        samples = [dataset[j] for j in indices[j0:j0 + max(1, batch_size)]]
        H, W = samples[0][0].shape[:2]
        x = torch.from_numpy(np.stack([s[0] for s in samples])).to(device)
        targets = [torch.from_numpy(t).to(device)
                   for t in lgt_labels([s[3] for s in samples], H, W)]
        with torch.no_grad():
            losses = model.losses(model(x.permute(0, 3, 1, 2)), targets)
        for k, v in losses.items():
            sums[k] = sums.get(k, 0.0) + float(v) * len(samples)
    return {k: v / len(indices) for k, v in sums.items()}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch.distributed as dist

    from ..inference import resolve_device
    from ..parallel import init_distributed, make_mesh

    n_model = max(1, args.n_model)
    if "WORLD_SIZE" not in os.environ:
        if n_model != 1:
            raise ValueError(f"--n_model {n_model} needs that many ranks "
                             "or a multiple: launch with torchrun "
                             "--nproc_per_node")
        return _train(args, resolve_device(args.device), None, 0, 1)
    owns_group = not dist.is_initialized()
    device = init_distributed(args.device)
    try:
        world = dist.get_world_size()
        if world % n_model:
            raise ValueError(f"--n_model {n_model} does not divide the "
                             f"{world} ranks")
        mesh = make_mesh(world // n_model, n_model)
        return _train(args, device, mesh, dist.get_rank(), world)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _train(args, device, mesh, rank, world):
    """The training loop of ``main`` on this rank: ``mesh`` None in one
    process, else this rank's place in the (world / n_model, n_model)
    mesh."""
    import torch
    import torch.distributed as dist

    from ..data.dataset import PanoCorBonDataset, make_training_batch
    from ..inference import InferenceEngine
    from ..models import build_model
    from ..train.checkpoint import (load_checkpoint, load_trained_model,
                                    save_checkpoint, save_model)
    from ..train.engine import TrainEngine
    from ..train.schedule import warmup_poly_schedule
    from ..train.step import (create_train_state, encoder_freeze_mask,
                              make_optimizer)

    say = print if rank == 0 else (lambda *a, **k: None)  # noqa: E731
    os.makedirs(os.path.join(args.ckpt, args.id), exist_ok=True)

    aug_flags = dict(flip=not args.no_flip, rotate=not args.no_rotate,
                     gamma=not args.no_gamma, stretch=not args.no_pano_stretch)
    dataset_train = PanoCorBonDataset(args.train_root_dir, wire=args.wire,
                                      **aug_flags)
    dataset_aug = (PanoCorBonDataset(args.train_aug_root_dir, wire=args.wire,
                                     **aug_flags)
                   if args.train_aug_root_dir else None)
    dataset_valid = (PanoCorBonDataset(args.valid_root_dir, return_cor=True)
                     if args.valid_root_dir else None)
    say(f"training dataset contains {len(dataset_train)} images")
    H, W = dataset_train.load_raw(0)[0].shape[:2]

    build_kw = dict(device=device,
                    dtype=torch.bfloat16 if args.bf16 else torch.float32,
                    lstm_impl=LSTM_IMPLS[args.lstm_impl],
                    param_dtype=torch.float32,
                    bn_momentum=args.bn_momentum or 0.1,
                    seam_pool=args.seam_pool)
    lgt = args.model == "lgt"
    if lgt:
        build_kw = dict(build_kw, arch="lgt", W=W)
        del build_kw["lstm_impl"]
    if args.pth:
        say("Finetune model is given. Ignore --backbone and --no_rnn")
        model, _ = load_trained_model(
            args.pth, **{k: v for k, v in build_kw.items()
                         if k not in ("arch", "W")})
        if model.ARCH != args.model:
            raise ValueError(f"--pth holds a {model.ARCH} model; --model "
                             f"is {args.model}")
    else:
        model = build_model(args.backbone, not args.no_rnn, seed=args.seed,
                            **build_kw)
    backbone, use_rnn = model.backbone, model.use_rnn

    # With an aug dataset each batch is half each (the reference
    # re-overwrites the halved batch size, train.py:145-162; the JAX CLI
    # and this one do the documented thing)
    if dataset_aug is not None:
        bs_main = args.batch_size_train // 2
        bs_aug = args.batch_size_train - bs_main
    else:
        bs_main, bs_aug = args.batch_size_train, 0
    # each data rank takes rows [lo, hi) of every global batch
    n_data = 1 if mesh is None else mesh.n_data
    data_rank = 0 if mesh is None else mesh.data_rank
    if (bs_main + bs_aug) % n_data:
        raise ValueError(f"batch of {bs_main + bs_aug} does not split over "
                         f"{n_data} data ranks")
    lo = data_rank * (bs_main + bs_aug) // n_data
    hi = lo + (bs_main + bs_aug) // n_data
    steps_per_epoch = len(dataset_train) // bs_main
    max_iters = args.epochs * steps_per_epoch
    warmup_iters = args.warmup_epochs * steps_per_epoch

    schedule = warmup_poly_schedule(args.lr, max_iters, args.warmup_lr,
                                    warmup_iters, args.lr_pow)
    mask = (encoder_freeze_mask([n for n, _ in model.named_parameters()],
                                args.freeze_earlier_blocks)
            if args.freeze_earlier_blocks != -1 else None)
    tx = make_optimizer(args.optim, schedule, args.lr, args.beta1,
                        args.weight_decay, mask)
    state = create_train_state(model, tx)

    start_epoch, resume_best = 1, 0.0
    if args.resume:
        rp = args.resume
        if os.path.isdir(rp):
            rp = os.path.join(rp, "checkpoint.ckpt")
        state, header = load_checkpoint(rp, state)
        kw = header.get("kwargs", {})
        if (kw.get("backbone", backbone), kw.get("use_rnn", use_rnn),
                kw.get("arch", "horizonnet")) \
                != (backbone, use_rnn, args.model):
            raise ValueError(f"--resume checkpoint was trained with {kw}, "
                             "flags disagree")
        start_epoch = int(header["epoch"]) + 1
        resume_best = float(header["best_valid_score"])
        say(f"Resumed from {rp}: epoch {header['epoch']}, step "
            f"{state.step}, best {resume_best:.4f}")

    # under a mesh the engine shards the whole model it is given
    engine = TrainEngine(model, state, batch_size=bs_main + bs_aug, H=H, W=W,
                         device=device, mesh=mesh)

    tb = None
    if rank == 0:
        try:
            from tensorboardX import SummaryWriter
            tb = SummaryWriter(log_dir=os.path.join(args.logs, args.id))
        except ImportError:
            pass
    try:  # per-epoch progress (ref train.py:246,258 uses trange)
        from tqdm import trange
    except ImportError:
        trange = None
    if trange is None or rank != 0:
        trange = lambda n, **kw: range(n)  # noqa: E731

    from concurrent.futures import ThreadPoolExecutor
    prefetch = (ThreadPoolExecutor(args.num_workers)
                if args.num_workers > 0 else None)

    def build_batch(epoch_order, aug_epoch_order, it, bat_rng):
        rows = [(dataset_train, i)
                for i in epoch_order[it * bs_main:(it + 1) * bs_main]]
        if dataset_aug is not None:
            a_idx = aug_epoch_order[(it * bs_aug) % len(dataset_aug):][:bs_aug]
            rows += [(dataset_aug, i) for i in a_idx]
        parts = []
        for ds in (dataset_train, dataset_aug):
            idx = [i for d, i in rows[lo:hi] if d is ds]
            if idx:
                parts.append(make_training_batch(ds, idx, bat_rng,
                                                 device=device,
                                                 arch=args.model))
        if len(parts) == 1:
            return parts[0]
        (x, *targets), (xa, *targets_a) = parts
        return (torch.cat([x, xa], 0), *[
            np.concatenate([t, ta], 0) for t, ta in zip(targets, targets_a)])

    def validate_all(valid_engine):
        """``validate`` over this rank's share of the validation set (every
        world-th sample), the means over all of it on every rank."""
        idx = range(rank, len(dataset_valid), world)
        if lgt:
            loss = validate_lgt(valid_engine, dataset_valid,
                                args.batch_size_valid, idx)
            keys = model.METRICS
        else:
            loss = validate(valid_engine, dataset_valid,
                            args.batch_size_valid, idx)
            keys = VALID_METRICS
        if world == 1:
            return loss
        sums = torch.tensor([loss.get(k, 0.0) * len(idx)
                             for k in keys], dtype=torch.float64,
                            device=device)
        dist.all_reduce(sums)
        return {k: float(v) / len(dataset_valid)
                for k, v in zip(keys, sums.tolist())}

    best_valid_score = (resume_best if args.resume or not lgt
                        else -float("inf"))
    cur_iter = (start_epoch - 1) * steps_per_epoch
    valid_engine = None  # built lazily; weights swapped in each epoch
    try:
        for epoch in range(start_epoch, args.epochs + 1):
            # the same permutation and dropout generator on every rank;
            # the augmentation draws of rows other than the first data
            # rank's from a stream of their own
            ep_rng = np.random.default_rng([args.seed, epoch])
            gen = torch.Generator(device=device).manual_seed(
                epoch_seed(args.seed, epoch))
            order = ep_rng.permutation(len(dataset_train))
            aug_order = (ep_rng.permutation(len(dataset_aug))
                         if dataset_aug is not None else None)
            bat_rng = (ep_rng if data_rank == 0 else
                       np.random.default_rng([args.seed, epoch, data_rank]))
            nxt = (prefetch.submit(build_batch, order, aug_order, 0, bat_rng)
                   if prefetch else None)
            for it in trange(steps_per_epoch, desc=f"Train ep{epoch}",
                             leave=False):
                if prefetch:
                    x, *targets = nxt.result()
                    if it + 1 < steps_per_epoch:
                        nxt = prefetch.submit(build_batch, order, aug_order,
                                              it + 1, bat_rng)
                else:
                    x, *targets = build_batch(order, aug_order, it, bat_rng)
                metrics = engine.step(x, *targets, gen)
                cur_iter += 1
                if tb is not None:
                    for k, v in metrics.items():
                        tb.add_scalar(f"train/{k}", float(v), cur_iter)
                    tb.add_scalar("train/lr", schedule(cur_iter), cur_iter)

            host = None
            if dataset_valid is not None or epoch % args.save_every == 0:
                host = engine.host_state()   # collective under a mesh
            if dataset_valid is not None:
                if lgt:
                    # the live model, or a whole copy of a sharded one
                    if engine.sharded:
                        valid_engine = valid_engine or build_model(
                            backbone, use_rnn, **build_kw)
                        valid_engine.load_state_dict(host["state_dict"])
                    else:
                        valid_engine = model
                elif valid_engine is None:
                    # the whole model: a model sharded over 'model' serves
                    # from a copy
                    valid_model = (build_model(backbone, use_rnn, **build_kw)
                                   if engine.sharded else model)
                    valid_engine = InferenceEngine(
                        valid_model, host["state_dict"], H=H, W=W,
                        device=device,
                        batch_size=max(1, args.batch_size_valid))
                else:
                    valid_engine.update_variables(host["state_dict"])
                valid_loss = validate_all(valid_engine)
                if tb is not None:
                    for k, v in valid_loss.items():
                        tb.add_scalar(f"valid/{k}", v, epoch)
                now_score = (-valid_loss["total"] if lgt
                             else valid_loss["3DIoU"])
                say(f"Ep{epoch:3d} {now_score:.4f} vs. Best "
                    f"{best_valid_score:.4f}", flush=True)
                is_best = now_score > best_valid_score
                if is_best:
                    best_valid_score = now_score
                if rank == 0:
                    save_checkpoint(os.path.join(args.ckpt, args.id), host,
                                    backbone, use_rnn, epoch,
                                    best_valid_score, is_best,
                                    args=vars(args))

            if epoch % args.save_every == 0 and rank == 0:
                save_model(os.path.join(args.ckpt, args.id,
                                        f"epoch_{epoch}.ckpt"),
                           host["state_dict"], backbone, use_rnn,
                           args=vars(args))
    finally:
        if prefetch:
            prefetch.shutdown(wait=True)
        if tb is not None:
            tb.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
