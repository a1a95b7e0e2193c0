"""The yardstick's counts: the reference's FLOPs a pano against the
program's own count (horizonnet_tpu_torch/utils/flops.py), and the
recurrence kernels' operations and bytes.

The two FLOP counts differ only where the two forwards differ in form:
the program resizes the height stage's widths by a product with an
interpolation matrix, which the counter sees, where the reference calls
F.interpolate, which it does not (about 1e-4 of the count at 512x256).
So they are held within 0.1 %."""

import pytest
import torch

from harness import flops

H, W = 512, 256
DCT = (15, 6, 87)


def _program_model(train):
    from horizonnet_tpu_torch.models import build_model

    return build_model("resnet50", True, device="cpu", dtype=torch.bfloat16,
                       lstm_impl="kernel_train" if train else "kernel",
                       param_dtype=torch.float32 if train else None)


def test_serve_flops_match_the_programs_count():
    from horizonnet_tpu_torch.utils.flops import serving_flops

    mine = flops.serve_flops_per_pano(H, W, DCT)
    theirs = serving_flops(_program_model(False), 1, H, W, "dct4", "general")
    assert mine == pytest.approx(theirs, rel=1e-3)


def test_train_flops_match_the_programs_count():
    from horizonnet_tpu_torch.utils.flops import train_step_flops

    mine = flops.train_flops_per_pano(H, W)
    theirs = train_step_flops(_program_model(True), 1, H, W)
    assert mine == pytest.approx(theirs, rel=1e-3)


def test_recurrence_operations():
    # K1 at the serving batch, K2 and K3 at the recipe's, T = 1024 / 4
    assert flops.recurrence_ops(256, 2, 64, 512) / 1e9 == pytest.approx(
        68.72, abs=0.005)
    assert flops.recurrence_ops(256, 2, 24, 512) / 1e9 == pytest.approx(
        25.77, abs=0.005)


def test_roofline_is_the_larger_bound():
    ops, nbytes = 989e12 * 1e-3, 3.35e12 * 2e-3     # 1 ms and 2 ms
    assert flops.roofline_pct(ops, nbytes, 4e-3) == pytest.approx(50.0)
    assert flops.mfu_pct(989e12, 2.0) == pytest.approx(50.0)


def test_k1_bytes_count_each_tensor_once():
    from harness import kernels

    class Run:
        launches = {"cuda_lstm.launches": 2}

        def kernel_seconds(self, match):
            names = ["void bilstm::recurrence_bf16<4, false>(x)",
                     "void bilstm::recurrence_bf16<4, false>(x)",
                     "void bilstm::recurrence_bf16<4, true>(x)"]
            n = sum(match(s) for s in names)
            return n, n * 3e-3

    T, B, Hd = 256, 64, 512
    share = kernels.recurrence_roofline(Run(), "k1", B, T)
    g, h, w = T * 2 * B * 4 * Hd, T * 2 * B * Hd, 2 * Hd * 4 * Hd
    bound = max(flops.recurrence_ops(T, 2, B, Hd) / 989e12,
                2 * (g + h + w) / 3.35e12)
    assert share == pytest.approx(100 * bound / 3e-3)


def test_kernel_share_left_out_when_the_trace_lost_launches():
    from harness import kernels

    class Run:
        launches = {"cuda_lstm.launches": 3}

        def kernel_seconds(self, match):
            return 2, 6e-3

    assert kernels.recurrence_roofline(Run(), "k1", 64, 256) is None


@pytest.mark.parametrize("seen,counted,reported", [
    (576, 576, True), (574, 576, True), (540, 576, False),
    (580, 576, False), (0, 0, False)])
def test_a_roofline_needs_the_kernels_own_records(seen, counted, reported):
    from harness import kernels

    class Run:
        launches = {"cuda_lstm.launches": counted}

        def kernel_seconds(self, match):
            return seen, 1.5e-3 * seen

    t = kernels.mean_launch_seconds(Run(), "k1")
    assert (t is not None) == reported
    if reported:
        assert t == pytest.approx(1.5e-3)
