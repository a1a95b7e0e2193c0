"""The port's LSTM recurrence (horizonnet_tpu_torch/ops) against JAX.

The plain twin of the CUDA kernel K1 is held to the Pallas kernel run in
interpret mode on the same numpy inputs; the 2-layer bilstm to JAX's
bilstm(impl="pallas_interpret"). The kernel itself runs only on a CUDA
card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from horizonnet_tpu.ops.lstm import bilstm as jax_bilstm
from horizonnet_tpu.ops.pallas_lstm import bilstm_recurrence_pallas
from horizonnet_tpu_torch.ops import cuda_lstm
from horizonnet_tpu_torch.ops.lstm import bilstm

T, D, B, H = 8, 2, 3, 32


def _recurrence_inputs(seed):
    rng = np.random.default_rng(seed)
    xw = rng.normal(0, 1, (T, D, B, 4 * H)).astype(np.float32)
    w = rng.uniform(-1, 1, (D, H, 4 * H)).astype(np.float32) / np.sqrt(H)
    return xw, w


def _layer_params(seed, input_size, layers=2):
    rng = np.random.default_rng(seed)
    k = 1 / np.sqrt(H)
    out = []
    for layer in range(layers):
        in_l = input_size if layer == 0 else 2 * H
        out.append({n: rng.uniform(-k, k, s).astype(np.float32) for n, s in (
            ("w_ih", (D, 4 * H, in_l)), ("w_hh", (D, 4 * H, H)),
            ("b", (D, 4 * H)))})
    return out


# f32: both sides carry h, c in f32 with the same cell (1e-5 covers the
# order of the matmul sums); bf16: inputs and outputs round to bf16,
# whose half-ulp near 1 is 2e-3, so 1e-2 bounds one rounding flip.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_plain_twin_matches_pallas_interpret(dtype, tol):
    xw, w = _recurrence_inputs(0)
    ref = bilstm_recurrence_pallas(jnp.asarray(xw, dtype), jnp.asarray(w, dtype),
                                   interpret=True)
    tdt = getattr(torch, dtype)
    got = cuda_lstm.bilstm_recurrence_plain(torch.from_numpy(xw).to(tdt),
                                            torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (T, D, B, H)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_bilstm_matches_jax_pallas_interpret(dtype, tol):
    """2 layers, projection + recurrence. bf16: the projection rounds to
    bf16 at the same points as JAX (w_ih and b cast before the matmul),
    but the two matmuls sum in different orders, so 2e-2."""
    I = 24
    params = _layer_params(1, I)
    x = np.random.default_rng(2).normal(0, 1, (T, B, I)).astype(np.float32)
    ref = jax_bilstm(jnp.asarray(x, dtype), [
        {k: jnp.asarray(v) for k, v in p.items()} for p in params], H,
        impl="pallas_interpret")
    tdt = getattr(torch, dtype)
    got = bilstm(torch.from_numpy(x).to(tdt), [
        {k: torch.from_numpy(v) for k, v in p.items()} for p in params])
    assert got.shape == (T, B, 2 * H)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=tol)


def test_plain_impl_equals_kernel_impl_on_cpu():
    params = [{k: torch.from_numpy(v) for k, v in p.items()}
              for p in _layer_params(3, 16)]
    x = torch.from_numpy(
        np.random.default_rng(4).normal(0, 1, (T, B, 16)).astype(np.float32))
    torch.testing.assert_close(bilstm(x, params, "kernel"),
                               bilstm(x, params, "plain"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="lstm impl"):
        bilstm(x, params, "pallas")


def test_cpu_tensor_never_bumps_launch_counter():
    xw, w = _recurrence_inputs(5)
    before = cuda_lstm.launches
    cuda_lstm.bilstm_recurrence(torch.from_numpy(xw), torch.from_numpy(w))
    assert cuda_lstm.launches == before
    # the kernel's own wrapper refuses CPU tensors instead of running the twin
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_lstm.bilstm_recurrence_cuda(torch.from_numpy(xw),
                                         torch.from_numpy(w))
    assert cuda_lstm.launches == before


# The bf16 kernel's split of f32 h into three bf16 terms is exact: hi takes
# h's top 8 significand bits, mid the next 8 and lo the last 8. Magnitudes
# from scale/16 to scale keep lo above bf16's smallest normal down to 1e-30.
@pytest.mark.parametrize("scale", [1.0, 1e-10, 1e-20, 1e-30])
def test_split_bf16x3_is_exact(scale):
    rng = np.random.default_rng(6)
    mag = np.exp(rng.uniform(np.log(1 / 16), 0, (64, 512)))
    h = torch.from_numpy((np.where(rng.uniform(size=(64, 512)) < 0.5, -1, 1)
                          * mag * scale).astype(np.float32))
    hi, mid, lo = cuda_lstm.split_bf16x3(h)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, h.double())


# With a bf16 W each term's product is exact, so the three products summed
# in f32 equal the f32 product W.float() h up to f32 summation (1e-6
# relative to the largest entry; the kernel's products are the same).
@pytest.mark.parametrize("B", [1, 64])
def test_split_bf16x3_product_matches_f32(B):
    rng = np.random.default_rng(B)
    h = torch.from_numpy(rng.uniform(-1, 1, (B, 512)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (512, 2048))
                          / np.sqrt(512)).astype(np.float32)).bfloat16()
    want = h.double() @ w.double()
    got = sum(t.float() @ w.float() for t in cuda_lstm.split_bf16x3(h))
    err = ((got.double() - want).abs().max() / want.abs().max()).item()
    assert err <= 1e-6
    # a single bf16 term (h rounded to bf16) is far off: the split matters
    one = h.bfloat16().float() @ w.float()
    assert ((one.double() - want).abs().max() / want.abs().max()).item() > 1e-4
