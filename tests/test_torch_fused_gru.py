"""The port's fused biGRU (pepper_tpu_torch/ops/fused_gru.py) against the
JAX package's, on the same numpy inputs, weights and nonzero h0.

On the CPU the port runs the kernel's plain version; the JAX side runs its
Pallas kernel in interpret mode (as tests/test_pallas_ops.py does) and its
lax.scan GRU. The CUDA kernel itself is held to the plain version on the
card by tests/test_torch_kernels_cuda.py.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pepper_tpu.ops.fused_gru as jax_fg
from pepper_tpu.models.rnn import gru as jax_gru
from pepper_tpu_torch.models.rnn import gru as torch_gru
from pepper_tpu_torch.ops import fused_gru as fg

NAMES = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain recurrences issue thousands of tiny ops. With several
    test workers on one host, torch's intra-op thread pool then spends far
    more time waiting at its barriers than computing; one thread per worker
    keeps the file's run time the same under load as alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(rng, F, H):
    bound = 1.0 / np.sqrt(H)
    shapes = [(3 * H, F), (3 * H, H), (3 * H,), (3 * H,)]
    out = {}
    for suffix in ("", "_reverse"):
        for name, shape in zip(NAMES, shapes):
            out[name + suffix] = rng.uniform(-bound, bound,
                                             shape).astype(np.float32)
    return out


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in params.items()})


def _inputs(rng, B, T, F, H):
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((B, 2, H))).astype(np.float32)
    return x, h0


def _jax_fused_interpret(params, x, h0, block_b=8):
    real_call = jax_fg.pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        return real_call(*args, **kw)

    with mock.patch.object(jax_fg.pl, "pallas_call", interp_call):
        return jax_fg.fused_bigru.__wrapped__(params, x, h0, block_b=block_b)


CASES = [(8, 100, 10, 128), (5, 40, 10, 64)]   # full width; ragged batch


@pytest.mark.parametrize("B,T,F,H", CASES)
def test_fused_bigru_matches_jax_pallas_interpret(B, T, F, H):
    rng = np.random.default_rng(10 + B)
    p_jax, p_torch = _both(_params(rng, F, H))
    x, h0 = _inputs(rng, B, T, F, H)
    want_out, want_h = _jax_fused_interpret(p_jax, jnp.asarray(x),
                                            jnp.asarray(h0))
    got_out, got_h = fg.fused_bigru(p_torch, torch.from_numpy(x),
                                    torch.from_numpy(h0))
    assert got_out.shape == want_out.shape == (B, T, 2 * H)
    assert got_h.shape == want_h.shape == (B, 2, H)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-4)


@pytest.mark.parametrize("B,T,F,H", CASES)
def test_fused_bigru_matches_jax_gru(B, T, F, H):
    rng = np.random.default_rng(20 + B)
    p_jax, p_torch = _both(_params(rng, F, H))
    x, h0 = _inputs(rng, B, T, F, H)
    want_out, want_h = jax_gru(p_jax, jnp.asarray(x), jnp.asarray(h0))
    got_out, got_h = fg.fused_bigru(p_torch, torch.from_numpy(x),
                                    torch.from_numpy(h0))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-5)


@pytest.mark.parametrize("B,T,F,H", CASES)
def test_plain_gru_matches_jax_gru(B, T, F, H):
    rng = np.random.default_rng(30 + B)
    p_jax, p_torch = _both(_params(rng, F, H))
    x, h0 = _inputs(rng, B, T, F, H)
    want_out, want_h = jax_gru(p_jax, jnp.asarray(x), jnp.asarray(h0))
    got_out, got_h = torch_gru(p_torch, torch.from_numpy(x),
                               torch.from_numpy(h0))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=2e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-5)


def test_final_hidden_of_each_direction():
    """h_final[:, 0] is the forward output at the last time index and
    h_final[:, 1] the reverse output at time index 0."""
    rng = np.random.default_rng(3)
    _, p_torch = _both(_params(rng, 6, 16))
    x, h0 = _inputs(rng, 3, 7, 6, 16)
    out, h_n = fg.fused_bigru(p_torch, torch.from_numpy(x),
                              torch.from_numpy(h0))
    assert torch.equal(h_n[:, 0], out[:, -1, :16])
    assert torch.equal(h_n[:, 1], out[:, 0, 16:])


def test_permuted_gate_layout_matches_plain():
    """The kernel's weight layout: thread j reads columns 3j..3j+2 of the
    permuted W_hh^T and must find gates r, z, n of hidden unit j. One
    product computed through that layout equals the plain product."""
    rng = np.random.default_rng(4)
    B, H = 3, 16
    w = torch.from_numpy(rng.standard_normal((H, 3 * H)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    per_unit = (h @ fg._permute_gates(w)).reshape(B, H, 3)   # [b, j, q]
    plain = (h @ w).reshape(B, 3, H).transpose(1, 2)         # [b, j, q]
    np.testing.assert_allclose(per_unit.numpy(), plain.numpy(), atol=1e-5)


def test_plain_rounds_h_to_input_dtype():
    """bf16 inputs: h0 and h are rounded to bf16 each step while the gates
    stay f32, so the plain version sits within bf16 resolution of the f32
    recurrence, and both outputs come back in bf16."""
    rng = np.random.default_rng(5)
    B, T, H = 4, 30, 32
    xp = [torch.from_numpy(rng.standard_normal((B, T, 3 * H))
                           .astype(np.float32)) for _ in range(2)]
    w = [torch.from_numpy((rng.uniform(-1, 1, (H, 3 * H)) / np.sqrt(H))
                          .astype(np.float32)) for _ in range(2)]
    b = [torch.from_numpy((rng.uniform(-1, 1, 3 * H) / np.sqrt(H))
                          .astype(np.float32)) for _ in range(2)]
    h0 = [torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
          for _ in range(2)]
    want_out, want_h = fg.bigru_recurrence_plain(*xp, *w, *b, *h0)
    got_out, got_h = fg.bigru_recurrence_plain(
        *(t.bfloat16() for t in xp + w), *b, *h0)
    assert got_out.dtype == got_h.dtype == torch.bfloat16
    np.testing.assert_allclose(got_out.float().numpy(), want_out.numpy(),
                               atol=3e-2)
    np.testing.assert_allclose(got_h.float().numpy(), want_h.numpy(),
                               atol=3e-2)


def test_cpu_tensors_never_launch_and_kernel_rejects_them():
    rng = np.random.default_rng(6)
    _, p_torch = _both(_params(rng, 10, 32))
    before = fg.launches
    fg.fused_bigru(p_torch, torch.zeros(2, 5, 10), torch.zeros(2, 2, 32))
    assert fg.launches == before
    xp = torch.zeros(2, 5, 96)
    for name in fg.KERNEL_CODES:
        pack = fg.pack_bigru(p_torch, name)
        with pytest.raises(ValueError, match="CUDA"):
            fg.bigru_recurrence_packed(pack, xp, xp, torch.zeros(2, 2, 32))
    assert fg.launches == before


# ------------------------------------------------- packs and the mma layout
def _bf16_params(seed, F, H):
    return {k: v.bfloat16() for k, v in
            _both(_params(np.random.default_rng(seed), F, H))[1].items()}


@pytest.mark.parametrize("H", [128, 48, 16])
def test_packs_round_trip_to_whh(H):
    """mma's bf16 rows in mma_row_order and generic's permuted W_hh^T give
    back W_hh exactly; b_hh is kept in f32 in the original order."""
    p = _bf16_params(7, 10, H)
    mma = fg.pack_bigru(p, "mma")
    generic = fg.pack_bigru(p, "generic")
    order = fg.mma_row_order(H)
    assert sorted(order.tolist()) == list(range(3 * H))
    for d, sfx in enumerate(("", "_reverse")):
        w = p["weight_hh_l0" + sfx]
        assert mma.w_hh[d].dtype == torch.bfloat16
        back = torch.empty_like(w)
        back[order] = mma.w_hh[d]
        assert torch.equal(back, w)
        wt = generic.w_hh[d].reshape(H, H, 3).transpose(1, 2).reshape(H, 3 * H)
        assert torch.equal(wt, w.t())
        assert mma.bhh.dtype == torch.float32
        assert torch.equal(mma.bhh[d], p["bias_hh_l0" + sfx].float())


def _mma_slot(H, warp, lane, nb, frag):
    """(row of the 16-row tile, hidden unit, gate) that accumulator fragment
    `frag` of n-block `nb` holds in `lane` of `warp` (mma.sync m16n8k16:
    rows g and g+8, columns 2*tq and 2*tq+1 of the n-block), read through
    the pack's row order."""
    g, tq = lane // 4, lane % 4
    n = 48 * warp + 8 * nb + 2 * tq + frag % 2
    original = int(fg.mma_row_order(H)[n])
    return g + 8 * (frag // 2), original % H, original // H


@pytest.mark.parametrize("H", [128, 48])
def test_mma_fragments_hold_one_units_three_gates(H):
    """A thread's fragments of n-blocks 3v, 3v+1, 3v+2 hold r, z and n of
    the same (row, unit) pair, so the gate update needs no exchange."""
    for warp in range(H // 16):
        for lane in range(32):
            for v in range(2):
                for frag in range(4):
                    slots = [_mma_slot(H, warp, lane, 3 * v + q, frag)
                             for q in range(3)]
                    assert [s[2] for s in slots] == [0, 1, 2]
                    assert len({s[:2] for s in slots}) == 1
                    assert slots[0][1] == 16 * warp + 8 * v + 2 * (
                        lane % 4) + frag % 2


@pytest.mark.parametrize("B,H", [(16, 128), (5, 48)])
def test_mma_layout_computes_one_step_of_the_plain_version(B, H):
    """One step computed slot by slot through the fragment layout (the
    products of the packed bf16 rows and the bf16 h tile, f32 sums, b_hh
    after the product, b_hn inside the reset product, h rounded to bf16)
    equals bigru_recurrence_plain's step on a ragged tile."""
    rng = np.random.default_rng(8)
    p = _bf16_params(9, 10, H)
    pack = fg.pack_bigru(p, "mma")
    x = torch.from_numpy(rng.standard_normal((B, 1, 10)).astype(
        np.float32)).bfloat16()
    h0 = torch.from_numpy(0.5 * rng.standard_normal((B, 2, H)).astype(
        np.float32)).bfloat16()
    xp = fg.input_projections(p, x)
    want_out, want_h = fg.bigru_recurrence_plain(
        *xp, p["weight_hh_l0"].t(), p["weight_hh_l0_reverse"].t(),
        p["bias_hh_l0"], p["bias_hh_l0_reverse"], h0[:, 0], h0[:, 1])
    tile = torch.zeros(16, 2, H, dtype=torch.bfloat16)    # masked rows: 0
    tile[:B] = h0
    for d in range(2):
        acc = tile[:, d].float() @ pack.w_hh[d].float().t()   # [16, 3H]
        got = torch.zeros(B, H)
        for warp in range(H // 16):
            for lane in range(32):
                for v in range(2):
                    for frag in range(4):
                        row, unit, _ = _mma_slot(H, warp, lane, 3 * v, frag)
                        if row >= B:
                            continue
                        n = [48 * warp + 8 * (3 * v + q) + 2 * (lane % 4)
                             + frag % 2 for q in range(3)]
                        hp = [acc[row, n[q]] + pack.bhh[d, q * H + unit]
                              for q in range(3)]
                        xr, xz, xn = (xp[d][row, 0, q * H + unit].float()
                                      for q in range(3))
                        r = torch.sigmoid(xr + hp[0])
                        z = torch.sigmoid(xz + hp[1])
                        n_gate = torch.tanh(xn + r * hp[2])
                        h = (1 - z) * n_gate + z * tile[row, d, unit].float()
                        got[row, unit] = h.bfloat16().float()
        want = want_out[:, 0, d * H:(d + 1) * H].float()
        assert (got - want).abs().max().item() <= 2.0 ** -8
        assert torch.equal(want_h[:, d], want_out[:, 0, d * H:(d + 1) * H])


@pytest.mark.parametrize("B,T,H,dtype,want", [
    (128, 100, 128, torch.bfloat16, "mma"),          # the consensus batch
    (37, 100, 128, torch.bfloat16, "mma"),
    (1, 1, 64, torch.bfloat16, "mma"),
    (5, 40, 16, torch.bfloat16, "mma"),
    (128, 100, 128, torch.float32, "generic"),       # PEPPER_TPU_PRECISION=f32
    (5, 3, 40, torch.bfloat16, "generic"),
    (3, 7, 127, torch.float32, "generic"),
])
def test_select_kernel(B, T, H, dtype, want):
    assert fg.select_kernel(B, T, H, dtype) == want
    assert fg.kernel_takes(want, H, dtype)


@pytest.mark.parametrize("B,T,H,dtype,error", [
    (4, 3, 256, torch.bfloat16, ValueError),
    (0, 3, 64, torch.bfloat16, ValueError),
    (4, 3, 64, torch.float16, TypeError),
])
def test_select_kernel_rejects(B, T, H, dtype, error):
    with pytest.raises(error):
        fg.select_kernel(B, T, H, dtype)


def test_mma_pack_rejects_hidden_sizes_it_does_not_take():
    """The mma layout needs whole n8-blocks of 16 units a warp."""
    with pytest.raises(ValueError, match="does not take"):
        fg.pack_bigru(_bf16_params(14, 10, 40), "mma")
    with pytest.raises(ValueError, match="unknown"):
        fg.pack_bigru(_bf16_params(14, 10, 32), "wgmma")


# ------------------------------------------------------ the shared cache
def test_pack_cache_hits_and_rebuilds_after_in_place_update():
    """One cache serves the biGRU and the biLSTM packs: a hit for the same
    tensors, a miss per kernel and after an in-place update."""
    from pepper_tpu_torch.ops import fused_lstm as fl
    from pepper_tpu_torch.ops import pack_cache

    p = _bf16_params(10, 10, 64)
    before = fg.pack_builds
    first = fg.packed_layer(p, "mma")
    assert fg.packed_layer(p, "mma") is first
    assert fg.pack_builds == before + 1
    assert fg.packed_layer(p, "generic") is not first
    with torch.no_grad():
        p["bias_hh_l0"].add_(1.0)                # as an optimizer step does
    second = fg.packed_layer(p, "mma")
    assert second is not first and fg.pack_builds == before + 3
    assert torch.equal(second.bhh[0], p["bias_hh_l0"].float())
    assert not torch.equal(second.bhh[0], first.bhh[0])
    shapes = {"weight_ih_l0": (256, 10), "weight_hh_l0": (256, 64),
              "bias_ih_l0": (256,), "bias_hh_l0": (256,)}
    lstm = {n: torch.zeros(shapes[n.replace("_reverse", "")])
            for n in fl._PARAM_NAMES}
    fl.packed_layer(lstm, "cluster_fma")
    kinds = {key[0] for key in pack_cache._cache}
    assert {"bigru:mma", "bilstm:cluster_fma"} <= kinds


def test_pack_cache_is_not_fooled_by_a_freed_layer():
    """A layer is dropped and another of the same shapes and dtype with
    other values appears at the same addresses (fresh tensors at version
    0): the second layer's pack must still be its own."""
    rng = np.random.default_rng(11)
    buffers = _params(rng, 10, 32)
    for _ in range(3):
        p = {k: torch.from_numpy(v) for k, v in buffers.items()}
        got = fg.packed_layer(p, "generic")
        assert fg.packed_layer(p, "generic") is got
        want = fg.pack_bigru(p, "generic")
        for d in range(2):
            assert torch.equal(got.w_hh[d], want.w_hh[d])
        assert torch.equal(got.bhh, want.bhh)
        del p
        for v in buffers.values():       # the next model's values, in place
            v[...] = rng.uniform(-0.1, 0.1, v.shape)


def test_pack_cache_skips_inference_tensors():
    """Inference tensors track no version: such a layer is packed on every
    call, while a normal layer updated under inference mode is seen."""
    with torch.inference_mode():
        p = _bf16_params(12, 10, 32)
        first = fg.packed_layer(p, "mma")
        p["bias_hh_l0"].add_(1.0)
        second = fg.packed_layer(p, "mma")
    assert second is not first
    assert torch.equal(second.bhh[0], p["bias_hh_l0"].float())
    p = _bf16_params(13, 10, 32)
    first = fg.packed_layer(p, "mma")
    with torch.inference_mode():
        assert fg.packed_layer(p, "mma") is first
        p["bias_hh_l0"].add_(1.0)
        assert fg.packed_layer(p, "mma") is not first
