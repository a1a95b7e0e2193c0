"""The port's LSTM training pair (ops/cuda_lstm_train.py) against JAX.

The plain twins of K2 and K3 are held to the Pallas kernels run in
interpret mode (``_train_fwd`` / ``_train_bwd``) on the same numpy inputs;
the autograd.Function's gradients to jax.grad of the 2-layer bilstm with
impl="pallas_train_interpret". The kernels themselves run only on a CUDA
card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from horizonnet_tpu.ops.lstm import bilstm as jax_bilstm
from horizonnet_tpu.ops.pallas_lstm import _train_bwd, _train_fwd
from horizonnet_tpu_torch.ops import cuda_lstm_train as clt
from horizonnet_tpu_torch.ops.cuda_lstm import bilstm_recurrence_plain
from horizonnet_tpu_torch.ops import dropout as port_dropout
from horizonnet_tpu_torch.ops.lstm import bilstm

T, D, B, H = 8, 2, 3, 32


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xw = rng.normal(0, 1, (T, D, B, 4 * H)).astype(np.float32)
    w = rng.uniform(-1, 1, (D, H, 4 * H)).astype(np.float32) / np.sqrt(H)
    dys = rng.normal(0, 1, (T, D, B, H)).astype(np.float32)
    return xw, w, dys


def _np(t):
    return t.detach().float().numpy()


# f32: the same f32 cell on both sides, sums in another order (1e-6 on
# values in (-1, 1)); bf16: ys, gates and cs round to bf16, whose half-ulp
# near 1 is 2e-3, so 1e-2 bounds one rounding flip.
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6), ("bfloat16", 1e-2)])
def test_k2_twin_matches_pallas_interpret(dtype, tol):
    xw, w, _ = _inputs(0)
    want = _train_fwd(jnp.asarray(xw, dtype), jnp.asarray(w, dtype),
                      interpret=True)
    tdt = getattr(torch, dtype)
    got = clt.train_fwd_plain(torch.from_numpy(xw).to(tdt),
                              torch.from_numpy(w).to(tdt))
    for g, r, shape in zip(got, want, [(T, D, B, H), (T, D, B, 4 * H),
                                       (T, D, B, H)]):
        assert g.dtype == tdt and g.shape == shape
        np.testing.assert_allclose(_np(g), np.asarray(r.astype(jnp.float32)),
                                   atol=tol)


def test_k3_twin_and_weight_grad_match_pallas_interpret():
    """f32: the reverse recurrence carries dh, dc in f32 on both sides and
    dW is one f32 contraction; 1e-5 covers the order of the sums."""
    xw, w, dys = _inputs(1)
    ys, gates, cs = _train_fwd(jnp.asarray(xw), jnp.asarray(w),
                               interpret=True)
    dxw_j, dw_j = _train_bwd(jnp.asarray(w), ys, gates, cs, jnp.asarray(dys),
                             interpret=True)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    dxw = clt.train_bwd_plain(t(gates), t(cs), t(dys), t(w))
    dw = clt.weight_grad(t(ys), dxw, t(w))
    assert dxw.shape == (T, D, B, 4 * H) and dw.shape == (D, H, 4 * H)
    np.testing.assert_allclose(_np(dxw), np.asarray(dxw_j), atol=1e-5)
    np.testing.assert_allclose(_np(dw), np.asarray(dw_j), atol=1e-5)


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


@pytest.mark.parametrize("dropout_rate", [0.0, 0.5])
def test_autograd_function_grads_match_jax(dropout_rate, monkeypatch):
    """Gradients of sum(y * probe) for x and every LSTM parameter through
    the 2-layer bilstm: the port's autograd.Function (K2/K3 twins on the
    CPU) against jax.grad with impl="pallas_train_interpret", at the
    rtol/atol 1e-5 of tests/test_ops.py:167-196. With dropout, both sides
    draw the between-layer mask from one numpy source."""
    I = 24
    params = _layer_params(3, I)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (T, B, I)).astype(np.float32)
    probe = rng.normal(0, 1, (T, B, 2 * H)).astype(np.float32)
    mask = rng.uniform(size=(T, B, 2 * H)) < 0.5

    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(mask))
    monkeypatch.setattr(port_dropout, "keep_mask",
                        lambda shape, p, gen, device: torch.from_numpy(mask))

    def jax_loss(x, params):
        y = jax_bilstm(x, params, H, dropout_rate,
                       jax.random.PRNGKey(0) if dropout_rate else None,
                       impl="pallas_train_interpret")
        return jnp.sum(y * probe)

    gx_j, gp_j = jax.grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x), [{k: jnp.asarray(v) for k, v in p.items()}
                         for p in params])

    xt = torch.from_numpy(x).requires_grad_()
    pt = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
          for p in params]
    y = bilstm(xt, pt, "kernel_train", dropout_rate,
               torch.Generator().manual_seed(0))
    (y * torch.from_numpy(probe)).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-5)
    for p, pj in zip(pt, gp_j):
        for k in p:
            np.testing.assert_allclose(_np(p[k].grad), np.asarray(pj[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)


def test_kernel_train_equals_plain_autograd_on_cpu():
    """The Function's hand-written backward equals autograd through K1's
    plain twin (the "plain" training path) on the same inputs."""
    xw, w, dys = _inputs(5)
    grads = []
    for impl in ("kernel_train", "plain"):
        a = torch.from_numpy(xw).requires_grad_()
        b = torch.from_numpy(w).requires_grad_()
        fn = (clt.bilstm_recurrence_trainable if impl == "kernel_train"
              else bilstm_recurrence_plain)
        (fn(a, b) * torch.from_numpy(dys)).sum().backward()
        grads.append((a.grad, b.grad))
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_never_bump_launch_counters():
    xw, w, dys = _inputs(6)
    before = (clt.fwd_launches, clt.bwd_launches)
    a = torch.from_numpy(xw).requires_grad_()
    (clt.bilstm_recurrence_trainable(a, torch.from_numpy(w))
     * torch.from_numpy(dys)).sum().backward()
    assert (clt.fwd_launches, clt.bwd_launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        clt.train_fwd_cuda(torch.from_numpy(xw), torch.from_numpy(w))
    assert (clt.fwd_launches, clt.bwd_launches) == before


# K3's bf16 carry dh = da @ W^T multiplies an f32 da by bf16 W on the tensor
# cores as three exact bf16 products (cuda_lstm.split_bf16x3). Gradients
# span many orders of magnitude, so da here is log-uniform from 1e-6 to 10
# with random signs, over the 4H = 2048 contraction of the training shape:
# the three products summed in f32 equal the f32 product to 1e-6 relative
# to the largest entry, and the single term bf16(da) is far off.
@pytest.mark.parametrize("B", [1, 8])
def test_split_bf16x3_da_product_matches_f32(B):
    from horizonnet_tpu_torch.ops.cuda_lstm import split_bf16x3

    rng = np.random.default_rng(100 + B)
    Hs = 512
    da = (np.exp(rng.uniform(np.log(1e-6), np.log(10.0), (B, 4 * Hs)))
          * np.where(rng.uniform(size=(B, 4 * Hs)) < 0.5, -1, 1))
    da = torch.from_numpy(da.astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (Hs, 4 * Hs)) / np.sqrt(Hs))
                         .astype(np.float32)).bfloat16()
    want = da.double() @ w.double().T
    hi, mid, lo = split_bf16x3(da)
    assert torch.equal(hi.double() + mid.double() + lo.double(), da.double())
    got = sum(t.float() @ w.float().T for t in (hi, mid, lo))
    scale = want.abs().max()
    assert ((got.double() - want).abs().max() / scale).item() <= 1e-6
    one = hi.float() @ w.float().T
    assert ((one.double() - want).abs().max() / scale).item() > 1e-4
