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
    out, gates, cs = fl.bilstm_train_forward_plain(
        *fl.raw_projections(pt, torch.from_numpy(x)), pt["weight_hh_l0"].t(),
        pt["weight_hh_l0_reverse"].t(), fl.layer_biases(pt))
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
    out, gates, cs = fl.bilstm_train_forward_plain(
        *fl.raw_projections(pt, torch.from_numpy(x)), pt["weight_hh_l0"].t(),
        pt["weight_hh_l0_reverse"].t(), fl.layer_biases(pt))
    i, f, g, o = gates.chunk(4, dim=-1)
    assert torch.allclose(cs, i * g)
    dxp, dwhh = fl.bilstm_train_backward_plain(
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
    pack = fl.pack_bilstm(_to_torch(params), "generic")
    with pytest.raises(ValueError, match="CUDA"):
        fl.bilstm_train_forward_packed(pack, xp, xp)
    out = torch.zeros(2, 5, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fl.bilstm_train_backward_kernel(
            pack, out, torch.zeros(2, 2, 5, 128), torch.zeros(2, 2, 5, 32),
            out)
    assert (fl.train_fwd_launches, fl.train_bwd_launches) == before[1:]


# ------------------------------------ K3 with separate biases and a pack
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_with_separate_biases_is_bit_equal_to_folded(dtype):
    """K3's plain version on raw xp and the biases is the same function as
    on xp with the biases folded in: out and both residuals."""
    params, x, _ = _case(10, 5, 7, 10, 32)
    pt = {k: v.to(dtype) for k, v in _to_torch(params).items()}
    xt = torch.from_numpy(x).to(dtype)
    w = (pt["weight_hh_l0"].t(), pt["weight_hh_l0_reverse"].t())
    raw, b = fl.raw_projections(pt, xt), fl.layer_biases(pt)
    folded = fl.bilstm_train_forward_plain(
        raw[0] + b[0] + b[1], raw[1] + b[2] + b[3], *w)
    split = fl.bilstm_train_forward_plain(*raw, *w, b)
    for a, b in zip(folded, split):
        assert torch.equal(a, b)
    assert torch.equal(split[0], fl.fused_bilstm_train(pt, xt))


@pytest.mark.parametrize("name,H", [("cluster_fma", 64), ("cluster_fma", 128),
                                    ("generic", 16)])
def test_packed_residuals_land_in_the_original_gate_order(name, H):
    """K3's kernels read xp, the biases and W_hh^T in the pack's order
    (column 4u+q) and store the activated gates at q*H + u: one step from
    the packed arrays, block slice by block slice, scattered that way,
    equals the plain version's residuals."""
    params, x, _ = _case(11, 4, 1, 6, H)
    pt = _to_torch(params)
    xt = torch.from_numpy(x)
    pack = fl.pack_bilstm(pt, name)
    want_out, want_gates, want_cs = fl.bilstm_train_forward_plain(
        *fl.raw_projections(pt, xt), pt["weight_hh_l0"].t(),
        pt["weight_hh_l0_reverse"].t(), fl.layer_biases(pt))
    units = H if name == "generic" else 32
    for d, xp in enumerate(fl.packed_projections(pack, xt)):
        gates = torch.empty(4, 4 * H)
        cs = torch.empty(4, H)
        for r in range(H // units):
            cols = slice(4 * units * r, 4 * units * (r + 1))
            pre = ((xp[:, 0, cols] + pack.bias[d, 0, cols])
                   + pack.bias[d, 1, cols]).reshape(4, units, 4)
            # h_{t-1} = 0 at the only step, so W_hh adds nothing; its slice
            # must still have the block's shape
            assert pack.w_hh[d][:, cols].shape == (H, 4 * units)
            i, f, o = (torch.sigmoid(pre[..., q]) for q in (0, 1, 3))
            g = torch.tanh(pre[..., 2])
            own = torch.arange(units * r, units * (r + 1))
            for q, act in enumerate((i, f, g, o)):
                gates[:, q * H + own] = act
            cs[:, own] = i * g
        np.testing.assert_allclose(gates.numpy(), want_gates[d, :, 0].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(cs.numpy(), want_cs[d, :, 0].numpy(),
                                   atol=1e-6)


def test_pack_cache_follows_an_optimizer_step():
    """Adam updates the parameters in place every train step: the cached
    pack must be rebuilt from the new values, and only then."""
    params, x, weight = _case(12, 3, 4, 6, 64)
    pt = _to_torch(params, grad=True)
    optimizer = torch.optim.Adam(pt.values(), lr=1e-2)
    first = fl.packed_layer(pt, "cluster_fma")
    assert fl.packed_layer(pt, "cluster_fma") is first
    out = fl.fused_bilstm_train(pt, torch.from_numpy(x))
    (out * torch.from_numpy(weight)).sum().backward()
    assert fl.packed_layer(pt, "cluster_fma") is first   # grads are no update
    optimizer.step()
    second = fl.packed_layer(pt, "cluster_fma")
    assert second is not first
    fresh = fl.pack_bilstm({k: v.detach() for k, v in pt.items()},
                           "cluster_fma")
    for d in range(2):
        assert torch.equal(second.w_hh[d], fresh.w_hh[d])
        assert torch.equal(second.w_ih[d], fresh.w_ih[d])
        assert not torch.equal(second.w_hh[d], first.w_hh[d])
    assert torch.equal(second.bias, fresh.bias)


@pytest.mark.parametrize("B,T,H,dtype,want", [
    (64, 33, 256, torch.float32, "cluster_fma"),     # the trainer's step
    (512, 33, 256, torch.float32, "cluster_fma"),
    (37, 21, 256, torch.float32, "cluster_fma"),     # HP window, ragged
    (64, 33, 256, torch.bfloat16, "cluster_fma"),    # residuals: no mma
    (5, 1, 128, torch.float32, "cluster_fma"),
    (9, 12, 64, torch.bfloat16, "cluster_fma"),
    (17, 3, 32, torch.float32, "generic"),
    (6, 12, 16, torch.float32, "generic"),
])
def test_select_kernel_for_the_training_forward(B, T, H, dtype, want):
    assert fl.select_kernel(B, T, H, dtype, residuals=True) == want


# ------------------------------------------- K4's cluster pair, emulated
def _dgates(gates, cs, gout_t, dh, dc, first, t, t_prev, d):
    """One reverse step of K4 for the rows given: (dgates [n,4,H], dc)."""
    i, f, g, o = gates[d, :, t].chunk(4, dim=-1)
    c_prev = torch.zeros_like(dh) if first else cs[d, :, t_prev]
    dh_tot = gout_t + dh
    tc = torch.tanh(cs[d, :, t])
    dc_tot = dc + dh_tot * o * (1.0 - tc * tc)
    dgates = torch.stack([dc_tot * g * i * (1.0 - i),
                          dc_tot * c_prev * f * (1.0 - f),
                          dc_tot * i * (1.0 - g * g),
                          dh_tot * tc * o * (1.0 - o)], dim=1)
    return dgates, dc_tot * f


def _rank_order_dh(pack, d, dgates):
    """dh = dgates @ W_hh as the cluster computes it: block r forms the
    partial of its 32 units' four gates (pack columns 128r.., 4u+q) against
    its W_hh^T slice, and the H/32 partials are summed in rank order."""
    n, _, H = dgates.shape
    w = pack.w_hh[d].float()                                  # [H, 4H]
    dh = None
    for r in range(H // 32):
        own = dgates[:, :, 32 * r:32 * (r + 1)].transpose(1, 2).reshape(n, 128)
        part = own @ w[:, 128 * r:128 * (r + 1)].t()          # [n, H]
        dh = part if dh is None else dh + part
    return dh


def _dwhh_chunk_rows(B, T, H):
    """The rows of (b, t) per chunk of the split dW_hh kernel
    (csrc/fused_lstm_bwd_cluster.cuh::dwhh_split)."""
    units = 64 if H == 64 else 128
    tiles = (4 * H // 128) * (H // units) * 2
    want = max(1, 256 // tiles)
    rows = -(-B * T // want)
    return -(-rows // 16) * 16


def _emulate_cluster_backward(pack, gout, gates, cs, out):
    """K4's cluster pair as the kernels run it: 16-row tiles, the partials
    summed in rank order, no product at a direction's first forward step;
    dW_hh over fixed chunks of (b, t), summed in chunk order."""
    B, T, H2 = gout.shape
    H = H2 // 2
    dxp = torch.zeros(2, B, T, 4 * H)
    dwhh = torch.zeros(2, 4 * H, H)
    for d in range(2):
        for b0 in range(0, B, 16):
            rows = slice(b0, min(B, b0 + 16))
            sub = (gates[:, rows], cs[:, rows])
            dh = torch.zeros(rows.stop - b0, H)
            dc = torch.zeros_like(dh)
            for s in range(T):
                t = s if d else T - 1 - s
                dgates, dc = _dgates(*sub, gout[rows, t, d * H:(d + 1) * H],
                                     dh, dc, s == T - 1, t,
                                     t + 1 if d else t - 1, d)
                dxp[d, rows, t] = dgates.reshape(-1, 4 * H)
                if s < T - 1:
                    dh = _rank_order_dh(pack, d, dgates)
        h_prev = torch.zeros(B, T, H)
        if d:
            h_prev[:, :-1] = out[:, 1:, H:]
        else:
            h_prev[:, 1:] = out[:, :-1, :H]
        dg_rows = dxp[d].reshape(B * T, 4 * H)
        hp_rows = h_prev.reshape(B * T, H)
        step = _dwhh_chunk_rows(B, T, H)
        for n0 in range(0, B * T, step):
            dwhh[d] += dg_rows[n0:n0 + step].t() @ hp_rows[n0:n0 + step]
    return dxp, dwhh


@pytest.mark.parametrize("H", [256, 64])
def test_k4_partials_in_rank_order_equal_the_full_product(H):
    """A random 16-row tile: the per-block partials of the cluster pack's
    slices, summed in rank order, are dgates @ W_hh."""
    rng = np.random.default_rng(13 + H)
    params = _to_torch(_params(rng, 6, H))
    pack = fl.pack_bilstm(params, "cluster_fma")
    dgates = torch.from_numpy(rng.standard_normal((16, 4, H)).astype(
        np.float32))
    for d, w in enumerate((params["weight_hh_l0"],
                           params["weight_hh_l0_reverse"])):
        got = _rank_order_dh(pack, d, dgates)
        want = dgates.reshape(16, 4 * H) @ w
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("B,T,H", [(20, 5, 64), (16, 3, 128), (3, 1, 64)])
def test_emulated_cluster_backward_equals_plain(B, T, H):
    """The cluster pair's scheme over all steps (a ragged second tile, and
    T=1 where no step exchanges) against K4's plain version."""
    params, x, weight = _case(14 + B, B, T, 6, H)
    pt = _to_torch(params)
    out, gates, cs = fl.bilstm_train_forward_plain(
        *fl.raw_projections(pt, torch.from_numpy(x)), pt["weight_hh_l0"].t(),
        pt["weight_hh_l0_reverse"].t(), fl.layer_biases(pt))
    gout = torch.from_numpy(weight)
    pack = fl.pack_bilstm(pt, "cluster_fma")
    got = _emulate_cluster_backward(pack, gout, gates, cs, out)
    want = fl.bilstm_train_backward_plain(gout, gates, cs, out,
                                          pt["weight_hh_l0"],
                                          pt["weight_hh_l0_reverse"])
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), atol=1e-4)


def test_generic_backward_reads_torch_rows_gathered_from_the_pack():
    """The generic pair reads W_hh in torch's row order, gathered from the
    forward's pack: the gather returns W_hh exactly."""
    params = _to_torch(_params(np.random.default_rng(15), 6, 32))
    pack = fl.pack_bilstm(params, "generic")
    w_f, w_b = fl._torch_layout_whh(pack)
    assert torch.equal(w_f, params["weight_hh_l0"])
    assert torch.equal(w_b, params["weight_hh_l0_reverse"])


@pytest.mark.parametrize("B,T,H,dtype,want", [
    (64, 33, 256, torch.float32, "cluster_fma"),     # the trainer's step
    (512, 33, 256, torch.float32, "cluster_fma"),    # the JAX trainer's
    (8192, 33, 256, torch.float32, "cluster_fma"),   # no batch threshold
    (16385, 2, 128, torch.float32, "cluster_fma"),
    (37, 21, 256, torch.bfloat16, "cluster_fma"),    # HP window, ragged
    (5, 1, 128, torch.float32, "cluster_fma"),
    (1, 2, 64, torch.float32, "cluster_fma"),
    (17, 3, 32, torch.float32, "generic"),
    (15, 4, 192, torch.float32, "generic"),
    (6, 12, 16, torch.bfloat16, "generic"),
])
def test_select_backward_kernel(B, T, H, dtype, want):
    assert fl.select_backward_kernel(B, T, H, dtype) == want


@pytest.mark.parametrize("B,T,H,dtype,error", [
    (4, 3, 30, torch.float32, ValueError),           # not a multiple of 4
    (4, 3, 512, torch.float32, ValueError),
    (0, 3, 64, torch.float32, ValueError),
    (4, 0, 64, torch.float32, ValueError),
    (4, 3, 64, torch.float16, TypeError),
])
def test_select_backward_kernel_rejects(B, T, H, dtype, error):
    with pytest.raises(error):
        fl.select_backward_kernel(B, T, H, dtype)
