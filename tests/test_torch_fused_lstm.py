"""The port's fused biLSTM (pepper_tpu_torch/ops/fused_lstm.py) against the
JAX package's, on the same numpy inputs and weights.

On the CPU the port runs the kernel's plain version; the JAX side runs its
Pallas kernel in interpret mode (as tests/test_pallas_ops.py does) and its
lax.scan LSTM. The CUDA kernel itself is held to the plain version on the
card by tests/test_torch_kernels_cuda.py.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pepper_tpu.ops.fused_lstm as jax_fl
from pepper_tpu.models.rnn import lstm as jax_lstm
from pepper_tpu_torch.models.rnn import lstm as torch_lstm
from pepper_tpu_torch.ops import fused_lstm as fl

NAMES = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]


def _params(rng, F, H):
    bound = 1.0 / np.sqrt(H)
    shapes = [(4 * H, F), (4 * H, H), (4 * H,), (4 * H,)]
    out = {}
    for suffix in ("", "_reverse"):
        for name, shape in zip(NAMES, shapes):
            out[name + suffix] = rng.uniform(-bound, bound,
                                             shape).astype(np.float32)
    return out


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


def _jax_fused_interpret(params, x, block_b=8):
    real_call = jax_fl.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    with mock.patch.object(jax_fl.pl, "pallas_call", interp_call):
        return jax_fl.fused_bilstm.__wrapped__(params, x, block_b=block_b)


CASES = [(8, 33, 26, 256), (5, 17, 26, 128)]   # full width; ragged batch


@pytest.mark.parametrize("B,T,F,H", CASES)
def test_fused_bilstm_matches_jax_pallas_interpret(B, T, F, H):
    rng = np.random.default_rng(10 + B)
    p_jax, p_torch = _both(_params(rng, F, H))
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    want = np.asarray(_jax_fused_interpret(p_jax, jnp.asarray(x)))
    got = fl.fused_bilstm(p_torch, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, T, 2 * H)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("B,T,F,H", CASES)
def test_fused_bilstm_matches_jax_lstm(B, T, F, H):
    rng = np.random.default_rng(20 + B)
    p_jax, p_torch = _both(_params(rng, F, H))
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    want = np.asarray(jax_lstm(p_jax, jnp.asarray(x)))
    got = fl.fused_bilstm(p_torch, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("B,T,F,H", CASES)
def test_plain_lstm_matches_jax_lstm(B, T, F, H):
    rng = np.random.default_rng(30 + B)
    p_jax, p_torch = _both(_params(rng, F, H))
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    want = np.asarray(jax_lstm(p_jax, jnp.asarray(x)))
    got = torch_lstm(p_torch, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_permuted_gate_layout_matches_plain():
    """The kernel's weight layout: thread j reads columns 4j..4j+3 of the
    permuted W_hh^T and must find gates i, f, g, o of hidden unit j. One
    step computed through that layout equals the plain step."""
    rng = np.random.default_rng(4)
    B, H = 3, 16
    w = torch.from_numpy(rng.standard_normal((H, 4 * H)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    per_unit = (h @ fl._permute_gates(w)).reshape(B, H, 4)   # [b, j, q]
    plain = (h @ w).reshape(B, 4, H).transpose(1, 2)         # [b, j, q]
    np.testing.assert_allclose(per_unit.numpy(), plain.numpy(), atol=1e-5)


def test_plain_rounds_h_to_input_dtype():
    """bf16 inputs: h is rounded to bf16 each step and c stays f32, so the
    plain version sits within bf16 resolution of the f32 recurrence."""
    rng = np.random.default_rng(5)
    B, T, H = 4, 9, 32
    xp = [torch.from_numpy(rng.standard_normal((B, T, 4 * H))
                           .astype(np.float32)) for _ in range(2)]
    w = [torch.from_numpy((rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H))
                          .astype(np.float32)) for _ in range(2)]
    want = fl.bilstm_recurrence_plain(*xp, *w)
    got = fl.bilstm_recurrence_plain(*(t.bfloat16() for t in xp + w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2)


def test_cpu_tensors_never_launch_and_kernel_rejects_them():
    rng = np.random.default_rng(6)
    _, p_torch = _both(_params(rng, 10, 32))
    before = fl.launches
    fl.fused_bilstm(p_torch, torch.zeros(2, 5, 10))
    assert fl.launches == before
    xp = torch.zeros(2, 5, 128)
    w = torch.zeros(32, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fl.bilstm_recurrence_kernel(xp, xp, w, w)
    assert fl.launches == before
