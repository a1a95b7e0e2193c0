"""Validation in the port's train CLI, and --resume from the CLI, on the CPU.

``validate`` is held to the JAX CLI's per-epoch loop
(horizonnet_tpu/cli/train.py:272-349), rebuilt here from the JAX
package's forward, ``postprocess`` and ``test_general`` on the same
weights and rooms. The resume case is the port's analogue of
tests/test_cli_train_resume.py: a run interrupted after epoch 1 and
resumed equals an unbroken one bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.data.dataset import PanoCorBonDataset
from horizonnet_tpu_torch.data.synth import synth_room
from horizonnet_tpu_torch.inference import InferenceEngine
from horizonnet_tpu_torch.train import checkpoint
from horizonnet_tpu_torch.utils.image import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "tests", "fixtures", "golden",
                    "resnet18_rnn_synth.ckpt")


def _rooms(root, n, width, seed0=100):
    os.makedirs(os.path.join(root, "img"))
    os.makedirs(os.path.join(root, "label_cor"))
    for i in range(n):
        img, cor = synth_room(np.random.default_rng(seed0 + i), 512, width)
        write_png(os.path.join(root, "img", f"room{i}.png"), img)
        np.savetxt(os.path.join(root, "label_cor", f"room{i}.txt"), cor,
                   fmt="%.4f")
    return root


def _jax_cli_loop(samples, bsv):
    """The JAX CLI's validation loop on the golden checkpoint."""
    from horizonnet_tpu.evals import new_general_losses
    from horizonnet_tpu.evals import test_general as jax_test_general
    from horizonnet_tpu.inference import net_forward, postprocess
    from horizonnet_tpu.train.checkpoint import load_trained_model

    model, variables = load_trained_model(CKPT)
    xb = np.stack([s[0] for s in samples]
                  + [samples[-1][0]] * (bsv - len(samples)))
    vb_all, vc_all = (np.asarray(a) for a in net_forward(model, variables,
                                                         xb))
    vc_all = np.clip(vc_all, 1e-7, 1 - 1e-7)
    total = {}
    for i, (img, y_bon, y_cor, gt_cor) in enumerate(samples):
        vb, vp = vb_all[i], vc_all[i]
        bon_l = float(np.abs(vb - y_bon).mean())
        cor_l = float(-(y_cor * np.log(vp) +
                        (1 - y_cor) * np.log(1 - vp)).mean())
        losses = {"bon": bon_l, "cor": cor_l, "total": bon_l + cor_l}
        dt_cor_id, _, _ = postprocess(vb, vp[0], force_raw=True)
        ev = new_general_losses()
        jax_test_general(dt_cor_id * [1024, 512], gt_cor, 1024, 512, ev)
        for m in ("2DIoU", "3DIoU", "rmse", "delta_1"):
            losses[m] = float(ev["overall"][m][0])
        for k, v in losses.items():
            total[k] = total.get(k, 0) + v
    return {k: v / len(samples) for k, v in total.items()}


def test_validate_matches_the_jax_cli_loop(tmp_path, capsys):
    """2 synthetic rooms at 512x1024 (the real metric path): losses within
    1e-5 relative, IoUs and depth metrics within 1e-4; the padded tail
    chunk (batch 3) gives the same result."""
    from horizonnet_tpu_torch.cli.train import validate

    ds = PanoCorBonDataset(_rooms(str(tmp_path / "valid"), 2, 1024),
                           return_cor=True)
    model, sd = checkpoint.load_trained_model(CKPT, device="cpu")
    got = validate(InferenceEngine(model, sd, batch_size=2, device="cpu"),
                   ds, 2)
    assert "[WARN]" not in capsys.readouterr().err
    want = _jax_cli_loop([ds[i] for i in range(2)], 2)
    assert sorted(got) == sorted(want)
    for k in ("bon", "cor", "total"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    for k in ("2DIoU", "3DIoU", "rmse", "delta_1"):
        assert got[k] == pytest.approx(want[k], rel=0, abs=1e-4), k
    assert got["3DIoU"] > 0.3
    padded = validate(InferenceEngine(model, sd, batch_size=3,
                                      device="cpu"), ds, 3)
    for k, v in got.items():
        assert padded[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k


def _train_args(tmp_path, run_id, data, *extra):
    return ["--id", run_id, "--ckpt", str(tmp_path / "ck"), "--logs",
            str(tmp_path / "lg"), "--backbone", "resnet18",
            "--train_root_dir", data, "--valid_root_dir", data,
            "--batch_size_train", "2", "--batch_size_valid", "2",
            "--num_workers", "0", "--no_flip", "--no_rotate", "--no_gamma",
            "--no_pano_stretch", "--save_every", "100", "--lr", "1e-3",
            "--lstm_impl", "pallas_train", "--device", "cpu", *extra]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def test_cli_resume_matches_unbroken(tmp_path, capsys):
    """2 rooms at 512x128: the unbroken 2-epoch run and the run stopped
    after epoch 1 and resumed write the same checkpoint.ckpt: equal step,
    epoch and best score, bit-identical weights, statistics and moments.
    At a width other than 1024 validation takes the placeholder metrics,
    with the JAX CLI's [WARN] line."""
    from horizonnet_tpu_torch.cli.train import main

    data = _rooms(str(tmp_path / "data"), 2, 128)
    assert main(_train_args(tmp_path, "a", data, "--epochs", "2")) == 0
    out = capsys.readouterr()
    assert "fell back to placeholder metrics" in out.err
    assert "Ep  2" in out.out
    head_a, pay_a = checkpoint.read_checkpoint(
        str(tmp_path / "ck" / "a" / "checkpoint.ckpt"))
    assert head_a["epoch"] == 2 and head_a["kind"] == "train"

    assert main(_train_args(tmp_path, "b", data, "--epochs", "1")) == 0
    head_b1, _ = checkpoint.read_checkpoint(
        str(tmp_path / "ck" / "b" / "checkpoint.ckpt"))
    assert head_b1["epoch"] == 1
    assert main(_train_args(tmp_path, "b", data, "--epochs", "2",
                            "--resume", str(tmp_path / "ck" / "b"))) == 0
    assert "Resumed from" in capsys.readouterr().out
    head_b, pay_b = checkpoint.read_checkpoint(
        str(tmp_path / "ck" / "b" / "checkpoint.ckpt"))
    assert head_b["epoch"] == 2
    assert int(pay_b["step"]) == int(pay_a["step"]) == 2
    assert head_b["best_valid_score"] == head_a["best_valid_score"]
    la, lb = list(_leaves(pay_a)), list(_leaves(pay_b))
    assert [p for p, _ in la] == [p for p, _ in lb] and len(la) > 50
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))


def test_cli_validates_at_full_width_and_keeps_the_best(tmp_path, capsys):
    """One epoch from the golden weights on 2 rooms at 512x1024: the real
    metric path (no [WARN]), a best score above 0 in checkpoint.ckpt, and
    best_model_1.ckpt beside it."""
    from horizonnet_tpu_torch.cli.train import main

    data = _rooms(str(tmp_path / "data"), 2, 1024)
    assert main(_train_args(tmp_path, "v", data, "--epochs", "1", "--pth",
                            CKPT, "--lr", "1e-6")) == 0
    out = capsys.readouterr()
    assert "[WARN]" not in out.err and "Ep  1" in out.out
    head, _ = checkpoint.read_checkpoint(
        str(tmp_path / "ck" / "v" / "checkpoint.ckpt"))
    assert head["epoch"] == 1 and head["best_valid_score"] > 0.3
    assert os.path.isfile(tmp_path / "ck" / "v" / "best_model_1.ckpt")


def test_cli_finetunes_from_a_reference_pth(tmp_path):
    """--pth takes a reference .pth (here the golden, written in the
    reference's layout): one epoch trains from its weights."""
    from horizonnet_tpu_torch.cli.train import main

    model, sd = checkpoint.load_trained_model(CKPT, device="cpu")
    pth = str(tmp_path / "golden.pth")
    torch.save({"kwargs": {"backbone": "resnet18", "use_rnn": True},
                "state_dict": sd}, pth)
    data = _rooms(str(tmp_path / "data"), 2, 128)
    assert main(_train_args(tmp_path, "f", data, "--epochs", "1",
                            "--valid_root_dir", "", "--save_every", "1",
                            "--pth", pth, "--backbone", "resnet50")) == 0
    tuned, tsd = checkpoint.load_trained_model(
        str(tmp_path / "ck" / "f" / "epoch_1.ckpt"), device="cpu")
    assert tuned.backbone == "resnet18"
    moved = [k for k in sd if not torch.equal(sd[k], tsd[k])]
    assert "bi_rnn.bias_ih_l0" in moved
    assert not os.path.isfile(tmp_path / "ck" / "f" / "checkpoint.ckpt")


def test_engine_runs_a_shared_training_model_in_eval_mode():
    """The train CLI's validation engine shares the training model, which
    each step leaves in train mode: the engine still runs it in eval
    mode, so validation neither moves the batch statistics nor draws
    dropout."""
    from horizonnet_tpu_torch.models import build_model

    model = build_model("resnet18", True, device="cpu", seed=2,
                        lstm_impl="kernel_train", param_dtype=torch.float32)
    eng = InferenceEngine(model, model.state_dict(), W=128, device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (1, 512, 128, 3)).astype(
        np.float32)
    want = eng(x)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    eng.update_variables(model.state_dict())
    got = eng(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
