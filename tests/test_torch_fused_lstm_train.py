"""The port's training biLSTM (`fused_bilstm_train`: kernels K3/K4 on the
card, their plain versions here) against the JAX package's, on the same
numpy inputs and weights, in f32 on the CPU.

The JAX side runs its Pallas kernels in interpret mode (as
tests/test_pallas_ops.py does) and its lax.scan LSTM. Tolerances are the
JAX package's own: 2e-4 for a fused forward against the scan, 5e-4 / 1e-3
for gradients (tests/test_pallas_ops.py:40,85). The CUDA kernels themselves
are held to the plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pepper_tpu.ops.fused_lstm as jax_fl
from pepper_tpu.models.rnn import lstm as jax_lstm
from pepper_tpu_torch.models.rnn import lstm as torch_lstm
from pepper_tpu_torch.ops import fused_lstm as fl


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain recurrences issue thousands of tiny ops. With several
    test workers on one host, torch's intra-op thread pool then spends far
    more time waiting at its barriers than computing; one thread per worker
    keeps the file's run time the same under load as alone. Set for this
    file's tests only: a process-wide setting at import would reach every
    file the worker collects."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NAMES = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]
# the base shape, a ragged batch (the Pallas tile pads 5 -> 8), T=1
SHAPES = [(6, 12, 10, 32), (5, 9, 10, 32), (3, 1, 6, 16)]


def _params(rng, F, H):
    bound = 1.0 / np.sqrt(H)
    shapes = [(4 * H, F), (4 * H, H), (4 * H,), (4 * H,)]
    return {name + suffix: rng.uniform(-bound, bound, shape).astype(np.float32)
            for suffix in ("", "_reverse")
            for name, shape in zip(NAMES, shapes)}


def _to_jax(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _to_torch(params, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad)
            for k, v in params.items()}


def _interpret():
    real_call = jax_fl.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    return mock.patch.object(jax_fl.pl, "pallas_call", interp_call)


def _case(seed, B, T, F, H):
    rng = np.random.default_rng(seed)
    return (_params(rng, F, H),
            rng.standard_normal((B, T, F)).astype(np.float32),
            rng.standard_normal((B, T, 2 * H)).astype(np.float32))


def _torch_grads(layers, x, weight, fn):
    """Gradients of sum(stack(x) * weight) through `fn` per layer: a list
    of per-layer parameter gradients, and dx."""
    ps = [_to_torch(p, grad=True) for p in layers]
    xt = torch.from_numpy(x.copy()).requires_grad_()
    h = xt
    for p in ps:
        h = fn(p, h)
    (h * torch.from_numpy(weight)).sum().backward()
    return ([{k: v.grad.numpy() for k, v in p.items()} for p in ps],
            xt.grad.numpy())


def _jax_grads(layers, x, weight, fn):
    def loss(ps, xj):
        h = xj
        for p in ps:
            h = fn(p, h)
        return jnp.sum(h * weight)

    gp, gx = jax.grad(loss, argnums=(0, 1))(
        [_to_jax(p) for p in layers], jnp.asarray(x))
    return ([{k: np.asarray(v) for k, v in p.items()} for p in gp],
            np.asarray(gx))


def _assert_grads_close(got, want, atol=5e-4, rtol=1e-3):
    (got_p, got_x), (want_p, want_x) = got, want
    for layer, (gp, wp) in enumerate(zip(got_p, want_p)):
        assert set(gp) == set(wp) and len(gp) == 8
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], atol=atol, rtol=rtol,
                                       err_msg=f"layer {layer} {k}")
    np.testing.assert_allclose(got_x, want_x, atol=atol, rtol=rtol)


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_forward_and_residuals_match_jax_pallas_interpret(B, T, F, H):
    """out, and the residuals K4 reads: activated gates [i,f,g,o] and the
    cell state, per direction, at the original time index."""
    params, x, _ = _case(1, B, T, F, H)
    with _interpret():
        want_out, res = jax_fl._train_fwd(_to_jax(params), jnp.asarray(x))
    out_f, out_b, gat_f, gat_b, cs_f, cs_b = (np.asarray(r) for r in res)
    pt = _to_torch(params)
    xp_f, xp_b = fl.input_projections(pt, torch.from_numpy(x))
    out, gates, cs = fl.bilstm_train_forward(
        xp_f, xp_b, pt["weight_hh_l0"].t(), pt["weight_hh_l0_reverse"].t())
    assert out.shape == (B, T, 2 * H)
    assert gates.shape == (2, B, T, 4 * H) and cs.shape == (2, B, T, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-4)
    # the JAX residuals are time-major and padded to the batch tile
    for d, (gat, c) in enumerate(((gat_f, cs_f), (gat_b, cs_b))):
        np.testing.assert_allclose(gates[d].numpy(),
                                   gat.swapaxes(0, 1)[:B], atol=2e-4)
        np.testing.assert_allclose(cs[d].numpy(), c.swapaxes(0, 1)[:B],
                                   atol=2e-4)


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_forward_matches_jax_lstm_and_the_inference_forward(B, T, F, H):
    params, x, _ = _case(2, B, T, F, H)
    want = np.asarray(jax_lstm(_to_jax(params), jnp.asarray(x)))
    pt = _to_torch(params)
    got = fl.fused_bilstm_train(pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert torch.equal(got, fl.fused_bilstm(pt, torch.from_numpy(x)))


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_gradients_match_jax_pallas_interpret(B, T, F, H):
    params, x, weight = _case(3, B, T, F, H)
    with _interpret():
        want = _jax_grads([params], x, weight, jax_fl.fused_bilstm_train)
    got = _torch_grads([params], x, weight, fl.fused_bilstm_train)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_gradients_match_jax_scan(B, T, F, H):
    params, x, weight = _case(4, B, T, F, H)
    want = _jax_grads([params], x, weight, jax_lstm)
    got = _torch_grads([params], x, weight, fl.fused_bilstm_train)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("B,T,F,H", SHAPES)
def test_gradients_match_torch_autograd_through_plain_lstm(B, T, F, H):
    """The explicit reverse-time loop against autograd through the port's
    step loop: same framework, so only summation order differs."""
    params, x, weight = _case(5, B, T, F, H)
    want = _torch_grads([params], x, weight, torch_lstm)
    got = _torch_grads([params], x, weight, fl.fused_bilstm_train)
    _assert_grads_close(got, want, atol=2e-5, rtol=1e-4)


def test_two_stacked_layers_match_jax():
    """The second layer's dx feeds the first layer's backward."""
    rng = np.random.default_rng(6)
    B, T, F, H = 5, 8, 10, 16
    layers = [_params(rng, F, H), _params(rng, 2 * H, H)]
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    weight = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    got = _torch_grads(layers, x, weight, fl.fused_bilstm_train)
    _assert_grads_close(got, _jax_grads(layers, x, weight, jax_lstm))
    with _interpret():
        want = _jax_grads(layers, x, weight, jax_fl.fused_bilstm_train)
    _assert_grads_close(got, want)


def test_first_step_is_masked_with_one_timestep():
    """T=1: every step is a first step, so h_prev and c_prev are the zero
    state: dW_hh and the forget gate's dxp are exactly zero, and the saved
    cell state is i*g."""
    params, x, weight = _case(7, 4, 1, 6, 16)
    pt = _to_torch(params)
    xp_f, xp_b = fl.input_projections(pt, torch.from_numpy(x))
    out, gates, cs = fl.bilstm_train_forward(
        xp_f, xp_b, pt["weight_hh_l0"].t(), pt["weight_hh_l0_reverse"].t())
    i, f, g, o = gates.chunk(4, dim=-1)
    assert torch.allclose(cs, i * g)
    dxp, dwhh = fl.bilstm_train_backward(
        torch.from_numpy(weight), gates, cs, out, pt["weight_hh_l0"],
        pt["weight_hh_l0_reverse"])
    assert not dwhh.any()
    H = 16
    assert not dxp[..., H:2 * H].any() and dxp[..., :H].any()


def test_backward_is_deterministic_and_x_grad_is_optional():
    params, x, weight = _case(8, 6, 12, 10, 32)
    first = _torch_grads([params], x, weight, fl.fused_bilstm_train)
    second = _torch_grads([params], x, weight, fl.fused_bilstm_train)
    for k in first[0][0]:
        assert np.array_equal(first[0][0][k], second[0][0][k]), k
    # x without requires_grad (the classifier's first layer): no dx
    pt = _to_torch(params, grad=True)
    out = fl.fused_bilstm_train(pt, torch.from_numpy(x))
    (out * torch.from_numpy(weight)).sum().backward()
    for k in pt:
        np.testing.assert_array_equal(pt[k].grad.numpy(), first[0][0][k])


def test_cpu_tensors_never_launch_and_the_kernels_reject_them():
    params, x, weight = _case(9, 2, 5, 10, 32)
    before = (fl.launches, fl.train_fwd_launches, fl.train_bwd_launches)
    got = _torch_grads([params], x, weight, fl.fused_bilstm_train)
    assert got[1].shape == x.shape
    assert (fl.launches, fl.train_fwd_launches,
            fl.train_bwd_launches) == before
    xp = torch.zeros(2, 5, 128)
    w = torch.zeros(32, 128)
    with pytest.raises(ValueError, match="CUDA"):
        fl.bilstm_train_forward_kernel(xp, xp, w, w)
    out = torch.zeros(2, 5, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fl.bilstm_train_backward_kernel(
            out, torch.zeros(2, 2, 5, 128), torch.zeros(2, 2, 5, 32), out,
            w.t(), w.t())
    assert (fl.train_fwd_launches, fl.train_bwd_launches) == before[1:]
