"""The port's host inference path and reference .pth weights, on the CPU.

The inference CLI without --device_postproc (the reference's default) on
the committed golden checkpoint, against golden_outputs.npz, which the
JAX host path made; --force_raw, --visualize, --min_v / --r; and the
reference's .pth formats, whose forward must equal the .ckpt they were
made from and the JAX package's ``load_reference_model``.
"""

import json
import os

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.inference import inference, net_forward, \
    postprocess
from horizonnet_tpu_torch.models import build_model
from horizonnet_tpu_torch.train import checkpoint
from horizonnet_tpu_torch.utils.image import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "golden")
CKPT = os.path.join(FIXDIR, "resnet18_rnn_synth.ckpt")
PANO = os.path.join(FIXDIR, "val_room.png")


@pytest.fixture(scope="module")
def golden():
    model, sd = checkpoint.load_trained_model(CKPT, device="cpu")
    img = read_png(PANO)[..., :3][None].astype(np.float32) / 255.0
    return model, sd, img, np.load(os.path.join(FIXDIR,
                                                "golden_outputs.npz"))


def _cli(tmp_path, *extra):
    from horizonnet_tpu_torch.cli.inference import main

    out = tmp_path / "out"
    assert main(["--pth", CKPT, "--img_glob", PANO, "--output_dir",
                 str(out), "--device", "cpu", *extra]) == 0
    with open(out / "val_room.json") as f:
        return json.load(f), out


@pytest.mark.parametrize("mode", ["cuboid", "general"])
def test_cli_host_path_matches_golden(golden, tmp_path, mode):
    """No --device_postproc: the JAX CLI's default, whose output the
    golden holds. Within 1 px (the CPU bar) and z1 within 0.2."""
    want = golden[3]
    got, _ = _cli(tmp_path, *(["--force_cuboid"] if mode == "cuboid"
                              else []))
    uv = np.asarray(got["uv"])
    assert got["z0"] == 50.0
    assert uv.shape == want[f"{mode}_uv"].shape
    dpx = np.abs(uv - want[f"{mode}_uv"]).max() * 512
    assert dpx < 1.0, f"{mode} corners off golden by {dpx:.3f} px"
    assert abs(got["z1"] - float(want[f"{mode}_z1"])) < 0.2


def test_cli_force_raw_equals_postprocess(golden, tmp_path):
    model, sd, img, _ = golden
    got, _ = _cli(tmp_path, "--force_raw")
    bon, cor = (t.numpy() for t in net_forward(model, sd, img))
    cor_id, z0, z1 = postprocess(bon[0], cor[0, 0], force_raw=True)
    assert len(got["uv"]) == 2 * 1024
    assert got == {"z0": z0, "z1": z1,
                   "uv": [[float(u), float(v)] for u, v in cor_id]}


def test_cli_visualize_writes_the_jax_strip(golden, tmp_path):
    from PIL import Image
    from horizonnet_tpu.viewer.visualize import visualize_a_data

    model, sd, img, want = golden
    (_, _, _, vis), = inference(model, sd, img, visualize=True)
    bon, cor = (t.numpy() for t in net_forward(model, sd, img))
    strip = visualize_a_data(img[0], bon[0], cor[0, 0])
    np.testing.assert_array_equal(vis, strip)
    got, out = _cli(tmp_path, "--visualize", "--force_cuboid")
    png = np.asarray(Image.open(out / "val_room.raw.png"))
    vh, vw = strip.shape[:2]
    half = np.asarray(Image.fromarray(strip).resize((vw // 2, vh // 2),
                                                    Image.LANCZOS))
    np.testing.assert_array_equal(png, half)
    assert np.abs(np.asarray(got["uv"]) - want["cuboid_uv"]).max() * 512 < 1


def test_cli_min_v_r_and_ignored_device_postproc(golden, tmp_path, capsys):
    """--min_v / --r reach postprocess; with --device_postproc they take
    the host path and print the JAX CLI's warning."""
    model, sd, img, _ = golden
    got, _ = _cli(tmp_path, "--device_postproc", "--min_v", "0.3", "--r",
                  "0.1")
    assert "[WARN] --device_postproc ignored" in capsys.readouterr().err
    (cor_id, z0, z1, _), = inference(model, sd, img, min_v=0.3, r=0.1)
    np.testing.assert_array_equal(np.asarray(got["uv"], np.float32), cor_id)
    assert got["z1"] == z1


def test_inference_batches_and_engine_cache(golden):
    """A batch of two panos gives each pano's single result; the cached
    engine is keyed per batch size and pins its key objects."""
    from horizonnet_tpu_torch import inference as inf

    model, sd, img, _ = golden
    x = np.concatenate([img[..., :256, :], np.roll(img, 64, 2)[..., :256, :]])
    both = inference(model, sd, x, force_cuboid=True)
    for b in range(2):
        (cor_id, _, z1, _), = inference(model, sd, x[b:b + 1],
                                        force_cuboid=True)
        np.testing.assert_allclose(both[b][0], cor_id, atol=1e-4)
        assert both[b][2] == pytest.approx(z1, rel=1e-5)
    keys = [k for k in inf._ENGINE_CACHE if k[0] == id(model)]
    assert {k[2] for k in keys} >= {1, 2}
    for key in keys:
        assert inf._ENGINE_CACHE[key][1] is model
        assert inf._ENGINE_CACHE[key][2] is sd
    assert len(inf._ENGINE_CACHE) <= inf._ENGINE_CACHE_MAX


def _reference_state_dict(model, sd, infix=True, seed=0):
    """The reference's state_dict of ``sd``: a nonzero bias_hh split off
    the folded LSTM bias, and optionally the wrap-padded convs' ``.1``
    infix removed (a model saved without the LR_PAD Sequential)."""
    g = torch.Generator().manual_seed(seed)
    out = {k: v.clone() for k, v in sd.items()}
    for k in sd:
        if k.startswith("bi_rnn.bias_hh"):
            r = torch.randn(sd[k].shape, generator=g) * 0.1
            out[k] = r
            ih = "bi_rnn.bias_ih" + k[len("bi_rnn.bias_hh"):]
            out[ih] = sd[ih] - r
    if not infix:
        padded = {n for n, mod in model.named_modules()
                  if isinstance(mod, torch.nn.Conv2d) and n.endswith(".1")}
        out = {(f"{k.rsplit('.', 2)[0]}.{k.rsplit('.', 1)[1]}"
                if k.rsplit(".", 1)[0] in padded else k): v
               for k, v in out.items()}
        assert len(out) == len(sd) and "feature_extractor.encoder.conv1." \
            "weight" in out
    return out


def _forward(model, sd, x):
    return [t.numpy() for t in net_forward(model, sd, x)]


@pytest.mark.parametrize("fmt", ["self_describing", "train_tar",
                                 "self_describing_no_infix",
                                 "train_tar_no_infix"])
def test_pth_formats_load_and_equal_ckpt(golden, tmp_path, fmt):
    """The golden .ckpt written as the reference's .pth (nonzero bias_hh,
    keys with or without the infix, a DataParallel ``module.`` prefix on
    the training checkpoint): the forward equals the .ckpt's (f32, 1e-6),
    and the JAX package's load_reference_model within 2e-4."""
    from horizonnet_tpu.inference import net_forward as jax_net_forward
    from horizonnet_tpu.models.torch_convert import load_reference_model

    model, sd, img, _ = golden
    ref = _reference_state_dict(model, sd, infix="no_infix" not in fmt)
    path = str(tmp_path / "model.pth")
    if fmt.startswith("self_describing"):
        torch.save({"args": {"lr": 1e-4}, "kwargs": {
            "backbone": "resnet18", "use_rnn": True}, "state_dict": ref},
            path)
    else:
        torch.save({"epoch": 3, "backbone": "resnet18",
                    "best_valid_score": 0.5, "optimizer": {},
                    "state_dict": {f"module.{k}": v
                                   for k, v in ref.items()}}, path)
    pmodel, psd = checkpoint.load_trained_model(path, device="cpu")
    assert pmodel.backbone == "resnet18" and pmodel.use_rnn
    assert not any(v.any() for k, v in pmodel.state_dict().items()
                   if "bias_hh" in k)
    x = np.ascontiguousarray(img[..., :128, :])
    got, want = _forward(pmodel, psd, x), _forward(model, sd, x)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-6)
    if fmt in ("self_describing", "train_tar_no_infix"):
        jmodel, variables = load_reference_model(path)
        for g_, w_ in zip(got, jax_net_forward(jmodel, variables, x)):
            np.testing.assert_allclose(g_, np.asarray(w_), rtol=0, atol=2e-4)


def test_bare_pth_defaults_to_resnet50_rnn(tmp_path):
    """A bare state_dict carries no kwargs: resnet50 with the RNN. Its
    forward equals the .ckpt written from the same weights."""
    src = build_model("resnet50", True, device="cpu", seed=5)
    sd = {k: v.detach().clone() for k, v in src.state_dict().items()}
    ckpt = str(tmp_path / "m.ckpt")
    checkpoint.save_model(ckpt, sd, "resnet50", True)
    pth = str(tmp_path / "m.pth")
    torch.save(_reference_state_dict(src, sd, infix=False, seed=1), pth)
    model, psd = checkpoint.load_trained_model(pth, device="cpu")
    assert model.backbone == "resnet50" and model.use_rnn
    want_model, want_sd = checkpoint.load_trained_model(ckpt, device="cpu")
    x = np.random.default_rng(0).uniform(0, 1, (1, 512, 64, 3)).astype(
        np.float32)
    for g_, w_ in zip(_forward(model, psd, x),
                      _forward(want_model, want_sd, x)):
        np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-6)


def test_pth_with_unknown_keys_is_refused(golden, tmp_path):
    model, sd, _, _ = golden
    ref = dict(_reference_state_dict(model, sd))
    ref["bi_rnn.weight_ih_l2"] = torch.zeros(3)
    path = str(tmp_path / "bad.pth")
    torch.save({"kwargs": {"backbone": "resnet18"}, "state_dict": ref}, path)
    with pytest.raises(KeyError, match="weight_ih_l2"):
        checkpoint.load_trained_model(path, device="cpu")


def test_cli_reads_a_reference_pth(golden, tmp_path):
    from horizonnet_tpu_torch.cli.inference import main

    model, sd, _, want = golden
    path = str(tmp_path / "golden.pth")
    torch.save({"kwargs": {"backbone": "resnet18", "use_rnn": True},
                "state_dict": _reference_state_dict(model, sd)}, path)
    assert main(["--pth", path, "--img_glob", PANO, "--output_dir",
                 str(tmp_path / "out"), "--force_cuboid", "--device",
                 "cpu"]) == 0
    with open(tmp_path / "out" / "val_room.json") as f:
        got = json.load(f)
    assert np.abs(np.asarray(got["uv"]) - want["cuboid_uv"]).max() * 512 < 1
