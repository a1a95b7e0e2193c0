"""Training CLI (reference train.py:61-352 surface).

Counterpart of horizonnet_tpu/cli/train.py, flag for flag, plus
``--device`` (default cuda; a missing CUDA device is an error):

    python -m horizonnet_tpu_torch.cli.train --id run1 \\
        --train_root_dir data/train --valid_root_dir '' \\
        --lstm_impl pallas_train --bf16 [--device cuda]

Same loop: per-update warmup-poly learning rate, an optional second "aug"
dataset filling half of each batch, per-epoch data order, augmentation
draws and dropout generator from (seed, epoch), so a --resume'd run sees
the batches of an unbroken one, a prefetch thread that builds the next
batch while the current step trains, and model checkpoints every
--save_every epochs.

``--lstm_impl``: ``pallas_train`` runs the CUDA pair K2/K3
(csrc/bilstm_train.cu), ``scan`` autograd through the plain loop.
``--s2d_stem`` is accepted and runs the standard stem (the same math
rearranged for the TPU's matrix unit). Still to port, each raising
NotImplementedError: validation (a non-empty --valid_root_dir; it needs
the host raw-polygon postprocess and evals, ROADMAP Queue 1 items 6 and
11), and with it the checkpoint.ckpt that --resume reads, which the JAX
CLI writes only after validation; --seam_pool and the densenet encoders
(item 7); --n_model > 1 (item 9).
"""

import argparse
import os
import sys

import numpy as np

LSTM_IMPLS = {"scan": "plain", "pallas_train": "kernel_train"}


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
    parser.add_argument("--backbone", default="resnet50")
    parser.add_argument("--no_rnn", action="store_true")
    parser.add_argument("--train_root_dir",
                        default="data/layoutnet_dataset/train")
    parser.add_argument("--train_aug_root_dir", default=None)
    parser.add_argument("--valid_root_dir",
                        default="data/layoutnet_dataset/valid",
                        help="'' disables validation (validation itself is "
                             "still to port)")
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
                        help="tensor-parallel axis size (only 1 is ported)")
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
                        help="wrap-padded maxpool (still to port)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on; a missing CUDA "
                             "device is an error")
    return parser


def epoch_seed(seed, epoch):
    """64-bit seed of an epoch's dropout generator, from (seed, epoch) as
    the epoch's numpy RNG."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(
        1, np.uint64)[0] >> 1)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.valid_root_dir:
        raise NotImplementedError(
            "validation (--valid_root_dir) needs the host raw-polygon "
            "postprocess and evals, ROADMAP Queue 1 items 6 and 11; pass "
            "--valid_root_dir '' to train without it")
    if args.seam_pool:
        raise NotImplementedError("--seam_pool is ROADMAP Queue 1 item 7")
    if args.n_model > 1:
        raise NotImplementedError("--n_model > 1 (tensor parallelism) is "
                                  "ROADMAP Queue 1 item 9")

    import torch

    from ..data.dataset import PanoCorBonDataset, make_training_batch
    from ..inference import resolve_device
    from ..models import build_model
    from ..train.checkpoint import (load_checkpoint, load_trained_model,
                                    save_model)
    from ..train.engine import TrainEngine
    from ..train.schedule import warmup_poly_schedule
    from ..train.step import (create_train_state, encoder_freeze_mask,
                              make_optimizer)

    device = resolve_device(args.device)
    os.makedirs(os.path.join(args.ckpt, args.id), exist_ok=True)

    aug_flags = dict(flip=not args.no_flip, rotate=not args.no_rotate,
                     gamma=not args.no_gamma, stretch=not args.no_pano_stretch)
    dataset_train = PanoCorBonDataset(args.train_root_dir, wire=args.wire,
                                      **aug_flags)
    dataset_aug = (PanoCorBonDataset(args.train_aug_root_dir, wire=args.wire,
                                     **aug_flags)
                   if args.train_aug_root_dir else None)
    print(f"training dataset contains {len(dataset_train)} images")
    H, W = dataset_train.load_raw(0)[0].shape[:2]

    build_kw = dict(device=device,
                    dtype=torch.bfloat16 if args.bf16 else torch.float32,
                    lstm_impl=LSTM_IMPLS[args.lstm_impl],
                    param_dtype=torch.float32,
                    bn_momentum=args.bn_momentum or 0.1)
    if args.pth:
        print("Finetune model is given. Ignore --backbone and --no_rnn")
        model, _ = load_trained_model(args.pth, **build_kw)
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

    start_epoch = 1
    if args.resume:
        rp = args.resume
        if os.path.isdir(rp):
            rp = os.path.join(rp, "checkpoint.ckpt")
        state, header = load_checkpoint(rp, state)
        kw = header.get("kwargs", {})
        if (kw.get("backbone", backbone), kw.get("use_rnn", use_rnn)) \
                != (backbone, use_rnn):
            raise ValueError(f"--resume checkpoint was trained with {kw}, "
                             "flags disagree")
        start_epoch = int(header["epoch"]) + 1
        print(f"Resumed from {rp}: epoch {header['epoch']}, step "
              f"{state.step}, best {float(header['best_valid_score']):.4f}")

    engine = TrainEngine(model, state, batch_size=bs_main + bs_aug, H=H, W=W,
                         device=device)

    try:
        from tensorboardX import SummaryWriter
        tb = SummaryWriter(log_dir=os.path.join(args.logs, args.id))
    except ImportError:
        tb = None
    try:  # per-epoch progress (ref train.py:246,258 uses trange)
        from tqdm import trange
    except ImportError:
        trange = lambda n, **kw: range(n)  # noqa: E731

    from concurrent.futures import ThreadPoolExecutor
    prefetch = (ThreadPoolExecutor(args.num_workers)
                if args.num_workers > 0 else None)

    def build_batch(epoch_order, aug_epoch_order, it, bat_rng):
        idx = epoch_order[it * bs_main:(it + 1) * bs_main]
        x, y_bon, y_cor = make_training_batch(dataset_train, idx, bat_rng,
                                              device=device)
        if dataset_aug is not None:
            a_idx = aug_epoch_order[(it * bs_aug) % len(dataset_aug):][:bs_aug]
            xa, ba, ca = make_training_batch(dataset_aug, a_idx, bat_rng,
                                             device=device)
            x = torch.cat([x, xa], 0)
            y_bon = np.concatenate([y_bon, ba], 0)
            y_cor = np.concatenate([y_cor, ca], 0)
        return x, y_bon, y_cor

    cur_iter = (start_epoch - 1) * steps_per_epoch
    try:
        for epoch in range(start_epoch, args.epochs + 1):
            ep_rng = np.random.default_rng([args.seed, epoch])
            gen = torch.Generator(device=device).manual_seed(
                epoch_seed(args.seed, epoch))
            order = ep_rng.permutation(len(dataset_train))
            aug_order = (ep_rng.permutation(len(dataset_aug))
                         if dataset_aug is not None else None)
            nxt = (prefetch.submit(build_batch, order, aug_order, 0, ep_rng)
                   if prefetch else None)
            for it in trange(steps_per_epoch, desc=f"Train ep{epoch}",
                             leave=False):
                if prefetch:
                    x, y_bon, y_cor = nxt.result()
                    if it + 1 < steps_per_epoch:
                        nxt = prefetch.submit(build_batch, order, aug_order,
                                              it + 1, ep_rng)
                else:
                    x, y_bon, y_cor = build_batch(order, aug_order, it,
                                                  ep_rng)
                metrics = engine.step(x, y_bon, y_cor, gen)
                cur_iter += 1
                if tb is not None:
                    for k, v in metrics.items():
                        tb.add_scalar(f"train/{k}", float(v), cur_iter)
                    tb.add_scalar("train/lr", schedule(cur_iter), cur_iter)

            if epoch % args.save_every == 0:
                save_model(os.path.join(args.ckpt, args.id,
                                        f"epoch_{epoch}.ckpt"),
                           model.state_dict(), backbone, use_rnn,
                           args=vars(args))
    finally:
        if prefetch:
            prefetch.shutdown(wait=True)
        if tb is not None:
            tb.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
