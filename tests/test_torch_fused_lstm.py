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
    """The generic kernel's weight layout: thread j reads columns 4j..4j+3
    of the packed W_hh^T and must find gates i, f, g, o of hidden unit j. One
    step computed through that layout equals the plain step."""
    rng = np.random.default_rng(4)
    B, H = 3, 16
    w = torch.from_numpy(rng.standard_normal((H, 4 * H)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    pack = fl.pack_weights("generic", w.t(), w.t(), None)
    per_unit = (h @ pack.w_hh[0]).reshape(B, H, 4)           # [b, j, q]
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
    for name in ("generic", "cluster_fma"):
        with pytest.raises(ValueError, match="CUDA"):
            fl.bilstm_recurrence_packed(fl.pack_bilstm(p_torch, name), xp, xp)
    assert fl.launches == before


# ------------------------------------------------ packing and kernel choice
def _torch_params(rng, F, H, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype)
            for k, v in _params(rng, F, H).items()}


def _folded_projections(params, x):
    """(xp_f, xp_b) with the biases folded in, each sum rounded to x's
    dtype: x @ W_ih^T + b_ih + b_hh."""
    xp_f, xp_b = fl.raw_projections(params, x)
    b = fl.layer_biases(params)
    return xp_f + b[0] + b[1], xp_b + b[2] + b[3]


def _packed_emulation(pack, xp_f, xp_b):
    """The recurrence as the kernels compute it, from the packed arrays
    alone: per step each block of the cluster takes its contiguous slice of
    the packed W_hh, xp and biases and produces its slice of h; slices are
    put together as the kernels' output is. Returns [B,T,2H]."""
    H = pack.hidden
    B, T, _ = xp_f.shape
    dtype = xp_f.dtype
    units = {"generic": H, "cluster_fma": 32, "cluster_mma": 64}[pack.name]
    out = torch.empty((B, T, 2 * H), dtype=dtype)
    for d, xp in enumerate((xp_f, xp_b)):
        b_ih, b_hh = pack.bias[d]
        h = torch.zeros((B, H), dtype=dtype)
        c = torch.zeros((B, H))
        for t in (range(T - 1, -1, -1) if d else range(T)):
            h_new = torch.empty_like(h)
            for r in range(H // units):
                cols = slice(4 * units * r, 4 * units * (r + 1))
                x_r = ((xp[:, t, cols] + b_ih[cols]) + b_hh[cols]).float()
                if pack.name == "cluster_mma":
                    w_r = pack.w_hh[d][cols]                 # [4*64, H]
                    pre_w = (h.float() @ w_r.float().t()).reshape(
                        B, units // 8, 4, 8).permute(0, 2, 1, 3)
                    pre_x = x_r.reshape(B, units // 2, 4, 2).permute(
                        0, 2, 1, 3)
                else:
                    w_r = pack.w_hh[d][:, cols]              # [H, 4*units]
                    pre_w = (h.float() @ w_r.float()).reshape(
                        B, units, 4).permute(0, 2, 1)
                    pre_x = x_r.reshape(B, units, 4).permute(0, 2, 1)
                pre = pre_x.reshape(B, 4, units) + pre_w.reshape(B, 4, units)
                own = slice(units * r, units * (r + 1))
                c[:, own] = (torch.sigmoid(pre[:, 1]) * c[:, own]
                             + torch.sigmoid(pre[:, 0]) * torch.tanh(pre[:, 2]))
                h_new[:, own] = (torch.sigmoid(pre[:, 3])
                                 * torch.tanh(c[:, own])).to(dtype)
            h = h_new
            out[:, t, d * H:(d + 1) * H] = h
    return out


PACK_CASES = [("generic", 16), ("generic", 96), ("cluster_fma", 64),
              ("cluster_fma", 256), ("cluster_mma", 64),
              ("cluster_mma", 128), ("cluster_mma", 256)]


@pytest.mark.parametrize("name,H", PACK_CASES)
def test_gate_permutations_round_trip(name, H):
    """Both orders are permutations of the 4H gate columns, block r of a
    cluster owns the four gates of a contiguous run of units, and packing
    then un-permuting gives the parameters back."""
    xp_order, w_order = fl.gate_permutations(name, H)
    for order in (xp_order, w_order):
        assert sorted(order.tolist()) == list(range(4 * H))
    units = {"generic": H, "cluster_fma": 32, "cluster_mma": 64}[name]
    for order in (xp_order, w_order):
        for r in range(H // units):
            got = sorted(order[4 * units * r:4 * units * (r + 1)].tolist())
            want = sorted(q * H + u for q in range(4)
                          for u in range(units * r, units * (r + 1)))
            assert got == want
    rng = np.random.default_rng(H)
    params = _torch_params(rng, 7, H)
    pack = fl.pack_bilstm(params, name)
    inv_x, inv_w = torch.argsort(xp_order), torch.argsort(w_order)
    for d, sfx in enumerate(("", "_reverse")):
        assert torch.equal(pack.w_ih[d][inv_x], params["weight_ih_l0" + sfx])
        w = pack.w_hh[d] if name == "cluster_mma" else pack.w_hh[d].t()
        assert torch.equal(w[inv_w], params["weight_hh_l0" + sfx])
        assert torch.equal(pack.bias[d, 0][inv_x], params["bias_ih_l0" + sfx])
        assert torch.equal(pack.bias[d, 1][inv_x], params["bias_hh_l0" + sfx])


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name,H", PACK_CASES)
def test_packed_emulation_matches_plain(name, H, dtype, atol):
    """The step computed slice by slice from the packed arrays equals the
    plain recurrence on the original ones (sums in another order)."""
    rng = np.random.default_rng(100 + H)
    B, T, F = 3, 4, 6
    params = _torch_params(rng, F, H, dtype)
    x = torch.from_numpy(rng.standard_normal((B, T, F)).astype(
        np.float32)).to(dtype)
    pack = fl.pack_bilstm(params, name)
    got = _packed_emulation(pack, *fl.packed_projections(pack, x))
    want = fl.bilstm_recurrence_plain(
        *fl.raw_projections(params, x), params["weight_hh_l0"].t(),
        params["weight_hh_l0_reverse"].t(), fl.layer_biases(params))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,H", [("generic", 32), ("cluster_fma", 64),
                                    ("cluster_mma", 128)])
def test_packed_projection_equals_raw_after_unpermuting(name, H, dtype):
    """x @ W_ih_packed^T is x @ W_ih^T with its columns in the kernel's
    order: a column of a matmul does not depend on its neighbours."""
    rng = np.random.default_rng(200 + H)
    params = _torch_params(rng, 26, H, dtype)
    x = torch.from_numpy(rng.standard_normal((5, 9, 26)).astype(
        np.float32)).to(dtype)
    pack = fl.pack_bilstm(params, name)
    inv = torch.argsort(pack.xp_order)
    raw = fl.raw_projections(params, x)
    for got, want in zip(fl.packed_projections(pack, x), raw):
        np.testing.assert_allclose(got[..., inv].float().numpy(),
                                   want.float().numpy(), atol=1e-6, rtol=0)
    folded = _folded_projections(params, x)
    for d in range(2):
        with_bias = ((fl.packed_projections(pack, x)[d] + pack.bias[d, 0])
                     + pack.bias[d, 1])[..., inv]
        np.testing.assert_allclose(with_bias.float().numpy(),
                                   folded[d].float().numpy(),
                                   atol=1e-6 if dtype == torch.float32
                                   else 2e-2, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_with_separate_biases_is_bit_equal_to_folded(dtype):
    """The plain version given raw xp and the biases is the same function
    as the plain version on xp with the biases folded in."""
    rng = np.random.default_rng(7)
    params = _torch_params(rng, 10, 32, dtype)
    x = torch.from_numpy(rng.standard_normal((4, 6, 10)).astype(
        np.float32)).to(dtype)
    w = (params["weight_hh_l0"].t(), params["weight_hh_l0_reverse"].t())
    folded = fl.bilstm_recurrence_plain(*_folded_projections(params, x), *w)
    split = fl.bilstm_recurrence_plain(*fl.raw_projections(params, x), *w,
                                       fl.layer_biases(params))
    assert torch.equal(folded, split)
    assert torch.equal(fl.fused_bilstm(params, x), folded)


def test_pack_cache_rebuilds_after_in_place_update():
    rng = np.random.default_rng(8)
    params = _torch_params(rng, 10, 64)
    before = fl.pack_builds
    first = fl.packed_layer(params, "cluster_fma")
    assert fl.packed_layer(params, "cluster_fma") is first
    assert fl.pack_builds == before + 1
    assert fl.packed_layer(params, "generic") is not first   # another kernel
    assert fl.pack_builds == before + 2
    with torch.no_grad():
        params["bias_hh_l0_reverse"].add_(1.0)               # as Adam does
    second = fl.packed_layer(params, "cluster_fma")
    assert second is not first and fl.pack_builds == before + 3
    assert torch.equal(second.bias[1, 1], first.bias[1, 1] + 1.0)
    replaced = dict(params, weight_ih_l0=params["weight_ih_l0"].clone())
    assert fl.packed_layer(replaced, "cluster_fma") is not second
    assert fl.pack_builds == before + 4


def test_pack_cache_is_not_fooled_by_a_freed_layer():
    """A layer is dropped and another of the same shapes and dtype with
    other values appears at the same addresses, as when an allocator hands
    a freed model's memory to the next one; fresh tensors start at version
    0, so addresses, versions and shapes all match. The second layer's pack
    must still be its own."""
    rng = np.random.default_rng(9)
    buffers = _params(rng, 10, 64)
    for round_ in range(3):
        params = {k: torch.from_numpy(v) for k, v in buffers.items()}
        got = fl.packed_layer(params, "cluster_fma")
        assert fl.packed_layer(params, "cluster_fma") is got
        want = fl.pack_bilstm(params, "cluster_fma")
        for d in range(2):
            assert torch.equal(got.w_hh[d], want.w_hh[d])
            assert torch.equal(got.w_ih[d], want.w_ih[d])
        assert torch.equal(got.bias, want.bias)
        del params
        for v in buffers.values():      # the next model's values, in place
            v[...] = rng.uniform(-0.1, 0.1, v.shape)
    # a parameter given other storage under the same tensor object
    params = _torch_params(rng, 10, 64)
    first = fl.packed_layer(params, "generic")
    params["bias_ih_l0"].data = params["bias_ih_l0"].data + 1.0
    second = fl.packed_layer(params, "generic")
    assert torch.equal(second.bias[0, 0], first.bias[0, 0] + 1.0)


def test_pack_cache_skips_inference_tensors():
    """Inference tensors track no version, so an in-place update could not
    be seen: such a layer is packed on every call."""
    rng = np.random.default_rng(10)
    with torch.inference_mode():
        params = _torch_params(rng, 10, 64)
        first = fl.packed_layer(params, "cluster_fma")
        params["bias_hh_l0"].add_(1.0)
        second = fl.packed_layer(params, "cluster_fma")
    assert torch.equal(second.bias[0, 1], first.bias[0, 1] + 1.0)
    # a normal tensor updated in place under inference mode is seen
    params = _torch_params(rng, 10, 64)
    first = fl.packed_layer(params, "cluster_fma")
    with torch.inference_mode():
        assert fl.packed_layer(params, "cluster_fma") is first
        params["bias_hh_l0"].add_(1.0)
        second = fl.packed_layer(params, "cluster_fma")
    assert torch.equal(second.bias[0, 1], first.bias[0, 1] + 1.0)


SELECT_CASES = [
    # the runner's batch, bf16 and f32
    (16384, 33, 256, torch.bfloat16, False, "cluster_mma"),
    (16384, 33, 256, torch.float32, False, "generic"),
    (640, 33, 256, torch.float32, False, "cluster_fma"),
    (641, 33, 256, torch.float32, False, "generic"),
    # the trainer's step (f32, residuals) and its bf16 variant
    (64, 33, 256, torch.float32, True, "cluster_fma"),
    (512, 33, 256, torch.bfloat16, True, "cluster_fma"),
    (4096, 33, 256, torch.float32, True, "generic"),
    # the HP window (T=21, F=48) has the same hidden size
    (1000, 21, 256, torch.bfloat16, False, "cluster_mma"),
    (1000, 21, 256, torch.float32, False, "generic"),
    (37, 21, 256, torch.float32, True, "cluster_fma"),
    # odd shapes: one row, one step, ragged batch, narrow layers
    (1, 1, 256, torch.bfloat16, False, "cluster_mma"),
    (16385, 33, 256, torch.bfloat16, False, "cluster_mma"),
    (5, 17, 128, torch.bfloat16, False, "cluster_mma"),
    (5, 17, 128, torch.float32, False, "cluster_fma"),
    (9, 7, 64, torch.float32, False, "cluster_fma"),
    (17, 3, 32, torch.bfloat16, False, "generic"),
    (17, 3, 32, torch.float32, True, "generic"),
    (3, 5, 192, torch.bfloat16, False, "generic"),
    (3, 5, 6, torch.float32, False, "generic"),
]


@pytest.mark.parametrize("B,T,H,dtype,residuals,want", SELECT_CASES)
def test_select_kernel(B, T, H, dtype, residuals, want):
    assert fl.select_kernel(B, T, H, dtype, residuals) == want


def test_select_kernel_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="hidden size"):
        fl.select_kernel(2, 3, 512, torch.float32)
    with pytest.raises(ValueError, match="hidden size"):
        fl.select_kernel(2, 3, 6, torch.float32, residuals=True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fl.select_kernel(2, 3, 64, torch.float16)
    with pytest.raises(ValueError, match="positive"):
        fl.select_kernel(0, 3, 64, torch.float32)


def test_kernel_takes_states_what_each_kernel_can_run():
    bf16, f32 = torch.bfloat16, torch.float32
    assert fl.kernel_takes("generic", 6, f32)
    assert not fl.kernel_takes("generic", 6, f32, residuals=True)
    assert not fl.kernel_takes("generic", 512, bf16)
    assert fl.kernel_takes("cluster_fma", 256, bf16, residuals=True)
    assert fl.kernel_takes("cluster_fma", 256, f32)
    assert not fl.kernel_takes("cluster_fma", 256, bf16)    # cluster_mma's
    assert not fl.kernel_takes("cluster_fma", 192, f32)
    assert fl.kernel_takes("cluster_mma", 128, bf16)
    assert not fl.kernel_takes("cluster_mma", 128, f32)
    assert not fl.kernel_takes("cluster_mma", 128, bf16, residuals=True)
    # what select_kernel returns is always a kernel that takes the shape
    for B, T, H, dtype, residuals, _ in SELECT_CASES:
        assert fl.kernel_takes(fl.select_kernel(B, T, H, dtype, residuals),
                               H, dtype, residuals)
