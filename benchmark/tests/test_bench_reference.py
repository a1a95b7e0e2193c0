"""The reference against the program at a small size, on the CPU: each
side computes from the same inputs and weights, neither imports the
other, and the numbers they produce are compared.

The bars: the wire decoder and the fits are the same arithmetic in
float32, so equal; the float32 forward within 1e-5 of the output's
scale (the two order some sums differently: the program's resize is a
product, the reference's F.interpolate); the float32 train step's losses
within 1e-3 over three steps and the first gradient's leaf norms within
1e-4 (a batch norm's statistics of two rows amplify the order of sums
from the second step on)."""

import numpy as np
import pytest
import torch

from harness.weights import make_state_dict
from reference import dct4 as ref_dct
from reference import fit as ref_fit
from reference import model as ref_model
from reference import tail as ref_tail

H, W = 512, 256


@pytest.fixture(scope="module")
def pano():
    from harness.serving import load_pano, rolled

    return rolled(load_pano()[:, ::4].copy(), [0, 77])


def test_dct4_packer_and_decoder_equal_the_programs(pano):
    from horizonnet_tpu_torch.ops import dct

    mine = ref_dct.pack_dct4(pano)
    np.testing.assert_array_equal(mine, dct.pack_dct4(pano))
    x = torch.from_numpy(mine)
    torch.testing.assert_close(ref_dct.unpack_dct4_to_rgb(x, H, W),
                               dct.unpack_dct4_to_rgb(x, H, W), rtol=0,
                               atol=0)


def test_forward_matches_the_programs_float32_forward(pano):
    from horizonnet_tpu_torch.models import build_model

    sd = make_state_dict(3, "cpu")
    x = torch.from_numpy(pano).float().permute(0, 3, 1, 2) / 255.0
    prog = build_model("resnet50", True, device="cpu", dtype=torch.float32,
                       lstm_impl="plain")
    prog.load_state_dict(sd)
    with torch.no_grad():
        b0, c0 = ref_model.build(sd, "cpu")(x)
        b1, c1 = prog.eval()(x)
    assert float((b0 - b1).abs().max()) < 1e-5 * float(b0.abs().max())
    assert float((c0 - c1).abs().max()) < 1e-5 * float(c0.abs().max())


def _signals(B, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = torch.linspace(0, 6.28, 1024)
    bon = torch.stack([
        -0.5 + 0.1 * torch.sin(3 * t + 6 * torch.rand(B, 1, generator=g)),
        0.45 + 0.1 * torch.sin(2 * t + 6 * torch.rand(B, 1, generator=g))],
        1) + 0.01 * torch.randn(B, 2, 1024, generator=g)
    cor = torch.sigmoid(3 * torch.sin(4 * t + 6 * torch.rand(B, 1,
                                                             generator=g))
                        + 0.5 * torch.randn(B, 1024, generator=g))
    return bon, cor


def test_fits_and_tail_equal_the_programs():
    from horizonnet_tpu_torch.postproc import device, serving

    bon, cor = _signals(8)
    for a, b in zip(ref_fit.postprocess_cuboid_batch(bon, cor),
                    device.postprocess_cuboid_batch(bon, cor)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    pa = ref_fit.pack_general_outputs(ref_fit.postprocess_general_batch(
        bon, cor))
    pb = device.pack_general_outputs(device.postprocess_general_batch(
        bon, cor))
    torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    for a, b in zip(ref_tail.finish_general_batch(pa.numpy()),
                    serving.finish_general_batch(pb.numpy())):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[2] == b[2]


def test_segment_means_are_the_fits_own():
    bon, cor = _signals(4, seed=1)
    packed = ref_fit.pack_general_outputs(ref_fit.postprocess_general_batch(
        bon, cor))
    K = (packed.shape[1] - 17) // 9
    locs = packed[:, :K].long()
    mine = ref_fit.segment_means(bon, locs)
    valid = (locs >= 0)[..., None]
    torch.testing.assert_close(
        torch.where(valid, mine, 0.0),
        torch.where(valid, packed[:, 7 * K:9 * K].reshape(-1, K, 2), 0.0))


def test_train_steps_match_the_programs_float32_steps(monkeypatch):
    import horizonnet_tpu_torch.models as models
    from harness import judge_train
    from harness.cell import load_cell
    from harness.kinds.train import Driver
    from harness.trace import Spans

    build = models.build_model

    def float32_model(*a, **k):
        return build(*a, **dict(k, dtype=torch.float32))

    monkeypatch.setattr(models, "build_model", float32_model)
    cell = load_cell("st3d-train-b24")
    cell.config["input_width"] = W
    cell.config["train"]["batch_size"] = 2
    cell.traffic["rooms"] = 4
    d = Driver(cell, 11, torch.device("cpu"), Spans())
    d.setup()
    d.window(0.01)
    d.release()
    gaps = judge_train.compare(d, judge_train.reference_steps(d))
    assert gaps["loss_gap"] < 1e-3
    assert gaps["grad_gap"] < 1e-4
    assert gaps["update_gap"] < 1e-2
