"""The port's CUDA kernels on the card (marker ``cuda``; they skip without
a CUDA device). This file imports no jax, so it also runs on a GPU host
without the JAX package's dependencies:

    python -m pytest -m cuda tests/test_torch_cuda.py -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from horizonnet_tpu_torch.ops import cuda_lstm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# f32: the same f32 cell on both sides, sums in another order: 1e-5.
# bf16: outputs round to bf16 (half-ulp near 1 is 2e-3): 1e-2.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("T,D,B,H", [(8, 2, 3, 32), (16, 1, 70, 64)])
def test_bilstm_kernel_matches_twin(cuda, dtype, tol, T, D, B, H):
    rng = np.random.default_rng(B)
    tdt = getattr(torch, dtype)
    xw = torch.from_numpy(rng.normal(0, 1, (T, D, B, 4 * H)).astype(
        np.float32)).to(cuda, tdt)
    w = torch.from_numpy((rng.uniform(-1, 1, (D, H, 4 * H))
                          / np.sqrt(H)).astype(np.float32)).to(cuda, tdt)
    before = cuda_lstm.launches
    got = cuda_lstm.bilstm_recurrence(xw, w)
    torch.cuda.synchronize()
    assert cuda_lstm.launches == before + 1
    want = cuda_lstm.bilstm_recurrence_plain(xw, w)
    assert got.dtype == tdt and got.shape == (T, D, B, H)
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_bilstm_kernel_rejects_what_it_cannot_run(cuda):
    xw = torch.zeros(4, 2, 3, 4 * 12, device=cuda)
    with pytest.raises(ValueError, match="multiple of"):
        cuda_lstm.bilstm_recurrence_cuda(xw, torch.zeros(2, 12, 48,
                                                         device=cuda))
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        cuda_lstm.bilstm_recurrence_cuda(xw.half(), torch.zeros(
            2, 12, 48, device=cuda).half())
