"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips where there is no CUDA
device (a CUDA kernel has no CPU mode). This file imports neither jax nor
the JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from pepper_tpu_torch.ops import fused_gru as fg
from pepper_tpu_torch.ops import fused_lstm as fl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _packed(launch, residuals, xp_f, xp_b, w_t_f, w_t_b, biases, name):
    B, T, G = xp_f.shape
    name = name or fl.select_kernel(B, T, G // 4, xp_f.dtype, residuals)
    pack = fl.pack_weights(name, w_t_f.t(), w_t_b.t(), biases)
    return launch(pack, xp_f[..., pack.xp_order], xp_b[..., pack.xp_order])


def _k1(xp_f, xp_b, w_t_f, w_t_b, biases=None, name=None):
    """K1 on xp [B,T,4H] and W_hh^T [H,4H] in their original gate order:
    packs the weights for the selected (or the named) kernel and gathers
    xp's columns into its order, as the layer's packed W_ih would."""
    return _packed(fl.bilstm_recurrence_packed, False, xp_f, xp_b, w_t_f,
                   w_t_b, biases, name)


def _k3(xp_f, xp_b, w_t_f, w_t_b, biases=None, name=None):
    """K3 likewise."""
    return _packed(fl.bilstm_train_forward_packed, True, xp_f, xp_b, w_t_f,
                   w_t_b, biases, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,T,H", [(1000, 21, 256), (5, 17, 128),
                                   (64, 33, 256), (17, 3, 32)])
def test_bilstm_kernel_matches_plain(cuda_device, dtype, atol, B, T, H):
    """bf16 tolerance: h is rounded to bf16 each step and the two versions
    sum the product in different orders."""
    g = torch.Generator().manual_seed(B + T)
    xp = [(torch.randn(B, T, 4 * H, generator=g) * 0.5).to(cuda_device, dtype)
          for _ in range(2)]
    w = [((torch.rand(H, 4 * H, generator=g) * 2 - 1) / 16)
         .to(cuda_device, dtype) for _ in range(2)]
    before = fl.launches
    got = _k1(*xp, *w)
    torch.cuda.synchronize()
    assert fl.launches == before + 1
    want = fl.bilstm_recurrence_plain(*xp, *w)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err


def _lstm_layer(device, dtype, F, H, seed):
    """A layer's eight parameters with torch's default init scale."""
    g = torch.Generator().manual_seed(seed)
    return {n: ((torch.rand((4 * H, F) if "weight_ih" in n else
                            (4 * H, H) if "weight_hh" in n else (4 * H,),
                            generator=g) * 2 - 1) / H ** 0.5).to(device, dtype)
            for n in fl._PARAM_NAMES}


# the runner's tile edge cases for the cluster kernels: B below one tile, not
# a multiple of the 64-row (mma) or 16-row (fma) tile, one past many tiles,
# T=1, every hidden size they take, and shapes only the generic kernel takes
LAYER_SHAPES = [(1, 1, 26, 256), (5, 17, 26, 128), (37, 21, 48, 256),
                (63, 2, 10, 64), (65, 3, 512, 256), (1000, 21, 48, 256),
                (16385, 2, 26, 256), (17, 3, 10, 32), (9, 4, 10, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,T,F,H", LAYER_SHAPES)
def test_fused_bilstm_layer_matches_plain(cuda_device, dtype, atol, B, T, F,
                                          H):
    """The layer path the runner takes (packed W_ih projection, raw xp and
    the biases into the selected kernel) against the plain version on the
    original parameters; the selected kernel's own counter moves; a second
    call gives identical bits and reuses the cached pack."""
    params = _lstm_layer(cuda_device, dtype, F, H, seed=B + T + H)
    g = torch.Generator().manual_seed(B)
    x = torch.randn(B, T, F, generator=g).to(cuda_device, dtype)
    name = fl.select_kernel(B, T, H, dtype)
    before = (fl.launches, fl.kernel_launches[name])
    got = fl.fused_bilstm(params, x)
    torch.cuda.synchronize()
    assert (fl.launches, fl.kernel_launches[name]) == (before[0] + 1,
                                                       before[1] + 1)
    builds = fl.pack_builds
    again = fl.fused_bilstm(params, x)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and fl.pack_builds == builds
    want = fl.bilstm_recurrence_plain(
        *fl.raw_projections(params, x), params["weight_hh_l0"].t(),
        params["weight_hh_l0_reverse"].t(), fl.layer_biases(params))
    assert got.dtype == dtype and got.shape == (B, T, 2 * H)
    assert bool(torch.isfinite(got.float()).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
def test_generic_kernel_takes_the_cluster_kernels_shapes(cuda_device, dtype,
                                                         atol):
    """The generic kernel stays callable at the shapes the cluster kernels
    take (the timing comparison uses it)."""
    B, T, H = 37, 5, 256
    g = torch.Generator().manual_seed(3)
    xp = [(torch.randn(B, T, 4 * H, generator=g) * 0.5).to(cuda_device, dtype)
          for _ in range(2)]
    w = [((torch.rand(H, 4 * H, generator=g) * 2 - 1) / 16)
         .to(cuda_device, dtype) for _ in range(2)]
    b = tuple((torch.rand(4 * H, generator=g) / 16).to(cuda_device, dtype)
              for _ in range(4))
    before = fl.kernel_launches["generic"]
    got = _k1(*xp, *w, b, name="generic")
    torch.cuda.synchronize()
    assert fl.kernel_launches["generic"] == before + 1
    want = fl.bilstm_recurrence_plain(*xp, *w, b)
    assert (got.float() - want.float()).abs().max().item() <= atol


@pytest.mark.cuda
def test_cluster_fma_alternates_between_hidden_sizes(cuda_device):
    """One kernel serves every hidden size with its own shared-memory
    size, and the launcher remembers what it asked the runtime per size: a
    wide layer must still launch after a narrow one used the same kernel."""
    for H in (256, 128, 256, 64, 256):
        params = _lstm_layer(cuda_device, torch.float32, 10, H, seed=H)
        x = torch.randn(21, 3, 10, device=cuda_device)
        assert fl.select_kernel(21, 3, H, torch.float32) == "cluster_fma"
        got = fl.fused_bilstm(params, x)
        want = fl.bilstm_recurrence_plain(
            *fl.raw_projections(params, x), params["weight_hh_l0"].t(),
            params["weight_hh_l0_reverse"].t(), fl.layer_biases(params))
        assert (got - want).abs().max().item() <= 1e-4
        out = fl.fused_bilstm_train(params, x)        # K3, the same kernel
        assert (out - want).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_packed_kernels_refuse_a_pack_of_another_shape(cuda_device):
    params = _lstm_layer(cuda_device, torch.float32, 10, 64, seed=1)
    xp = torch.zeros(4, 3, 4 * 64, device=cuda_device)
    before = fl.launches
    mma = fl.pack_bilstm(params, "cluster_mma")              # f32: not mma's
    with pytest.raises(ValueError, match="does not take"):
        fl.bilstm_recurrence_packed(mma, xp, xp)
    fma = fl.pack_bilstm(params, "cluster_fma")
    with pytest.raises(ValueError, match="does not fit"):
        fl.bilstm_recurrence_packed(fma, xp[..., :128], xp[..., :128])
    with pytest.raises(ValueError, match="one device and dtype"):
        fl.bilstm_recurrence_packed(fma, xp.bfloat16(), xp.bfloat16())
    # bf16 inference is the tensor-core kernel's at every such shape
    fma16 = fl.pack_bilstm({k: v.bfloat16() for k, v in params.items()},
                           "cluster_fma")
    with pytest.raises(ValueError, match="does not take"):
        fl.bilstm_recurrence_packed(fma16, xp.bfloat16(), xp.bfloat16())
    assert fl.launches == before


@pytest.mark.cuda
def test_bilstm_kernel_takes_strided_and_offset_inputs(cuda_device):
    """A time-major view and an xp slice at an odd offset (both taken as
    projections in the pack's column order) give the same result as
    contiguous copies (the wrapper copies what the kernel cannot read
    directly)."""
    g = torch.Generator().manual_seed(1)
    B, T, H = 9, 7, 64
    big = torch.randn(T, B, 4 * H + 1, generator=g).to(cuda_device)
    xp_f = big[..., 1:].transpose(0, 1)            # [B,T,4H], not contiguous
    flat = torch.randn(B * T * 4 * H + 1, generator=g).to(cuda_device)
    xp_b = flat[1:].view(B, T, 4 * H)              # contiguous, base 4 B off
    assert xp_b.is_contiguous() and xp_b.data_ptr() % 16
    w = (torch.rand(2, 4 * H, H, generator=g) / 8).to(cuda_device)
    pack = fl.pack_weights("cluster_fma", w[0], w[1], None)
    got = fl.bilstm_recurrence_packed(pack, xp_f, xp_b)
    want = fl.bilstm_recurrence_packed(pack, xp_f.contiguous(), xp_b.clone())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bilstm_kernel_rejects_what_it_does_not_take(cuda_device):
    xp = torch.zeros(2, 3, 4 * 512, device=cuda_device)
    w = torch.zeros(512, 4 * 512, device=cuda_device)
    before = fl.launches
    with pytest.raises(ValueError, match="hidden size"):
        _k1(xp, xp, w, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _k1(xp[..., :64].half(), xp[..., :64].half(), w[:16, :64].half(),
            w[:16, :64].half())
    assert fl.launches == before


def _gru_layer(device, dtype, F, H, seed):
    """A biGRU layer's parameters with torch's default init scale."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) / H ** 0.5).to(
            device, dtype)

    return {name + sfx: u(3 * H, F) if name == "weight_ih_l0" else
            u(3 * H, H) if name == "weight_hh_l0" else u(3 * H)
            for sfx in ("", "_reverse")
            for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0")}


def _gru_plain(params, xp_f, xp_b, h0):
    return fg.bigru_recurrence_plain(
        xp_f, xp_b, params["weight_hh_l0"].t(),
        params["weight_hh_l0_reverse"].t(), params["bias_hh_l0"],
        params["bias_hh_l0_reverse"], h0[:, 0], h0[:, 1])


# the consensus batch, a ragged batch, the 16-row mma tile's edges, one
# step, both widths the polish model could use, and a width only the
# generic kernel takes
GRU_SHAPES = [(128, 100, 10, 128), (128, 100, 256, 128), (37, 100, 10, 128),
              (1, 1, 10, 64), (15, 7, 10, 128), (16, 3, 256, 128),
              (17, 100, 10, 64), (5, 1, 256, 128), (9, 40, 10, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,T,F,H", GRU_SHAPES)
def test_bigru_kernel_matches_plain(cuda_device, dtype, atol, B, T, F, H):
    """The layer path (the selected kernel's pack, h0 as [B,2,H]) against
    the plain version; the selected kernel's counter moves; a second call
    gives identical bits and reuses the cached pack. bf16 tolerance: h is
    rounded to bf16 each step and the two versions sum the product in
    different orders; checked on out and the final h."""
    params = _gru_layer(cuda_device, dtype, F, H, seed=B + T + F)
    g = torch.Generator().manual_seed(B)
    x = torch.randn(B, T, F, generator=g).to(cuda_device, dtype)
    h0 = (torch.randn(B, 2, H, generator=g) * 0.5).to(cuda_device, dtype)
    name = fg.select_kernel(B, T, H, dtype)
    before = (fg.launches, fg.kernel_launches[name])
    got = fg.fused_bigru(params, x, h0)
    torch.cuda.synchronize()
    assert (fg.launches, fg.kernel_launches[name]) == (before[0] + 1,
                                                       before[1] + 1)
    builds = fg.pack_builds
    again = fg.fused_bigru(params, x, h0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert fg.pack_builds == builds
    want = _gru_plain(params, *fg.input_projections(params, x), h0)
    assert got[0].dtype == got[1].dtype == dtype
    assert got[1].shape == (B, 2, H)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a.float()).all())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= atol, err


@pytest.mark.cuda
def test_generic_bigru_kernel_takes_the_mma_kernels_shapes(cuda_device):
    """The generic kernel stays callable in bf16 at the polish shape (the
    timing comparison uses it)."""
    params = _gru_layer(cuda_device, torch.bfloat16, 10, 128, seed=5)
    x = torch.randn(37, 20, 10, device=cuda_device).bfloat16()
    h0 = torch.randn(37, 2, 128, device=cuda_device).bfloat16()
    xp = fg.input_projections(params, x)
    before = fg.kernel_launches["generic"]
    got = fg.bigru_recurrence_packed(fg.pack_bigru(params, "generic"), *xp,
                                     h0)
    torch.cuda.synchronize()
    assert fg.kernel_launches["generic"] == before + 1
    want = _gru_plain(params, *xp, h0)
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("mma", torch.bfloat16),
                                        ("generic", torch.float32)])
def test_bigru_kernel_takes_strided_and_offset_inputs(cuda_device, name,
                                                      dtype):
    """A time-major view, an xp slice at an odd offset and h0 as a strided
    view give the same result as contiguous copies."""
    g = torch.Generator().manual_seed(2)
    B, T, H = 9, 7, 64
    big = torch.randn(T, B, 3 * H + 1, generator=g).to(cuda_device, dtype)
    xp_f = big[..., 1:].transpose(0, 1)            # [B,T,3H], not contiguous
    flat = torch.randn(B * T * 3 * H + 1, generator=g).to(cuda_device, dtype)
    xp_b = flat[1:].view(B, T, 3 * H)              # contiguous, base off
    assert xp_b.is_contiguous() and xp_b.data_ptr() % 16
    h0 = torch.randn(2, B, H, generator=g).to(cuda_device, dtype)
    params = _gru_layer(cuda_device, dtype, 10, H, seed=3)
    pack = fg.pack_bigru(params, name)
    got = fg.bigru_recurrence_packed(pack, xp_f, xp_b, h0.transpose(0, 1))
    want = fg.bigru_recurrence_packed(pack, xp_f.contiguous(), xp_b.clone(),
                                      h0.transpose(0, 1).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_bigru_kernel_rejects_what_it_does_not_take(cuda_device):
    params = _gru_layer(cuda_device, torch.float32, 10, 64, seed=4)
    xp = torch.zeros(2, 3, 3 * 64, device=cuda_device)
    h0 = torch.zeros(2, 2, 64, device=cuda_device)
    before = fg.launches
    with pytest.raises(ValueError, match="hidden size"):
        wide = torch.zeros(2, 3, 3 * 256, device=cuda_device)
        fg.bigru_recurrence_packed(fg.pack_bigru(params, "generic"), wide,
                                   wide, torch.zeros(2, 2, 256,
                                                     device=cuda_device))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fg.select_kernel(2, 3, 64, torch.float16)
    mma = fg.pack_bigru(params, "mma")                  # f32: not mma's
    with pytest.raises(ValueError, match="does not take"):
        fg.bigru_recurrence_packed(mma, xp, xp, h0)
    generic = fg.pack_bigru(params, "generic")
    with pytest.raises(ValueError, match="do not fit"):
        fg.bigru_recurrence_packed(generic, xp, xp, h0[:, :1])
    with pytest.raises(ValueError, match="one dtype"):
        fg.bigru_recurrence_packed(generic, xp.bfloat16(), xp.bfloat16(), h0)
    with pytest.raises(ValueError, match="does not take"):    # 40 % 16
        fg.pack_bigru(_gru_layer(cuda_device, torch.bfloat16, 10, 40,
                                 seed=6), "mma")
    assert fg.launches == before


# ------------------------------------------------------- K3 / K4 (training)
def _train_inputs(device, dtype, B, T, H, seed):
    """(xp_f, xp_b, W_hh f/b [4H,H]) with torch's default init scale."""
    g = torch.Generator().manual_seed(seed)
    xp = [(torch.randn(B, T, 4 * H, generator=g) * 0.5).to(device, dtype)
          for _ in range(2)]
    w = [((torch.rand(4 * H, H, generator=g) * 2 - 1) / H ** 0.5)
         .to(device, dtype) for _ in range(2)]
    return xp, w


TRAIN_SHAPES = [(64, 33, 256), (37, 21, 256), (5, 1, 128), (17, 3, 32),
                (9, 12, 64), (1, 2, 256), (513, 3, 256), (15, 4, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,T,H", TRAIN_SHAPES)
def test_bilstm_train_forward_kernel_matches_plain(cuda_device, dtype, atol,
                                                   B, T, H):
    """K3: out, the activated gates and the cell states. bf16 tolerance: h
    is rounded to bf16 each step and the sums run in another order."""
    xp, w = _train_inputs(cuda_device, dtype, B, T, H, seed=B + T)
    g = torch.Generator().manual_seed(B)
    biases = tuple((torch.rand(4 * H, generator=g) / H ** 0.5).to(
        cuda_device, dtype) for _ in range(4))
    name = fl.select_kernel(B, T, H, dtype, residuals=True)
    before = (fl.train_fwd_launches, fl.kernel_launches[name])
    got = _k3(*xp, w[0].t(), w[1].t(), biases)
    torch.cuda.synchronize()
    assert (fl.train_fwd_launches, fl.kernel_launches[name]) == (
        before[0] + 1, before[1] + 1)
    again = _k3(*xp, w[0].t(), w[1].t(), biases)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fl.bilstm_train_forward_plain(*xp, w[0].t(), w[1].t(), biases)
    assert got[0].dtype == dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, a, b in zip(("out", "gates", "cs"), got, want):
        assert a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= atol, (name, err)


def _k4_case(device, dtype, B, T, H, seed):
    """(pack, gout, gates, cs, out, W_hh f/b): the plain forward's residuals
    of a random layer and the pack its forward kernel would use."""
    xp, w = _train_inputs(device, dtype, B, T, H, seed=seed)
    out, gates, cs = fl.bilstm_train_forward_plain(*xp, w[0].t(), w[1].t())
    pack = fl.pack_weights(fl.select_kernel(B, T, H, dtype, residuals=True),
                           w[0], w[1], None)
    g = torch.Generator().manual_seed(seed)
    gout = torch.randn(B, T, 2 * H, generator=g).to(device, dtype)
    return pack, gout, gates, cs, out, w


def _assert_k4_matches_plain(got, case):
    """dxp within 1e-4; dW_hh, which sums B*T products, within 1e-3 of its
    largest entry: both versions compute in f32 from the same residuals,
    so only the order of the sums differs."""
    pack, gout, gates, cs, out, w = case
    want_dxp, want_dwhh = fl.bilstm_train_backward_plain(
        gout, gates, cs, out, w[0].float(), w[1].float())
    assert (got[0] - want_dxp).abs().max().item() <= 1e-4
    scale = max(1.0, want_dwhh.abs().max().item())
    assert (got[1] - want_dwhh).abs().max().item() <= 1e-3 * scale


# the trainer's batch, a ragged HP window, the 16-row tile's edges (below
# one tile, one tile, one row past it, one row past many), one step, every
# hidden size the cluster pair takes, shapes only the generic pair takes
# (H=32 and 192), and a batch past the generic forward's 640 rows (a
# `generic` pack into the cluster pair)
K4_SHAPES = [(64, 33, 256), (37, 21, 256), (1, 1, 256), (5, 1, 128),
             (16, 3, 128), (17, 3, 64), (1, 2, 256), (513, 3, 256),
             (9, 12, 64), (17, 3, 32), (15, 4, 192), (1100, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,H", K4_SHAPES)
def test_bilstm_train_backward_kernel_matches_plain(cuda_device, dtype, B, T,
                                                    H):
    """K4, the selected pair, on the plain forward's residuals: dxp and
    dW_hh; its counter moves; two calls give identical bits (no atomics)."""
    case = _k4_case(cuda_device, dtype, B, T, H, seed=B + T + 1)
    name = fl.select_backward_kernel(B, T, H, dtype)
    before = (fl.train_bwd_launches, fl.bwd_kernel_launches[name])
    got = fl.bilstm_train_backward_kernel(*case[:5])
    again = fl.bilstm_train_backward_kernel(*case[:5])
    torch.cuda.synchronize()
    assert (fl.train_bwd_launches, fl.bwd_kernel_launches[name]) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    _assert_k4_matches_plain(got, case)


@pytest.mark.cuda
def test_generic_backward_pair_takes_the_cluster_shapes(cuda_device):
    """The generic pair stays callable where the cluster pair is selected
    (the timing comparison uses it), from the same pack."""
    case = _k4_case(cuda_device, torch.float32, 37, 9, 256, seed=8)
    assert fl.select_backward_kernel(37, 9, 256, torch.float32) == \
        "cluster_fma"
    before = fl.bwd_kernel_launches["generic"]
    got = fl.launch_backward("generic", *case[:5])
    torch.cuda.synchronize()
    assert fl.bwd_kernel_launches["generic"] == before + 1
    _assert_k4_matches_plain(got, case)


@pytest.mark.cuda
def test_cluster_backward_alternates_between_hidden_sizes(cuda_device):
    """One cluster kernel per hidden size, but the dW_hh kernel and the
    launcher's tables are shared: a wide layer must still launch after a
    narrow one."""
    for H in (256, 128, 256, 64, 256):
        case = _k4_case(cuda_device, torch.float32, 21, 3, H, seed=H)
        assert fl.select_backward_kernel(21, 3, H, torch.float32) == \
            "cluster_fma"
        _assert_k4_matches_plain(fl.bilstm_train_backward_kernel(*case[:5]),
                                 case)


@pytest.mark.cuda
def test_bilstm_train_backward_kernel_is_deterministic(cuda_device):
    """No atomics: two calls on the K3 forward's residuals give the same
    bits, with either pair."""
    B, T, H = 100, 33, 256
    xp, w = _train_inputs(cuda_device, torch.float32, B, T, H, seed=8)
    pack = fl.pack_weights("cluster_fma", w[0], w[1], None)
    out, gates, cs = fl.bilstm_train_forward_packed(
        pack, xp[0][..., pack.xp_order], xp[1][..., pack.xp_order])
    gout = torch.randn(B, T, 2 * H, device=cuda_device)
    for name in ("cluster_fma", "generic"):
        first = fl.launch_backward(name, pack, gout, gates, cs, out)
        second = fl.launch_backward(name, pack, gout, gates, cs, out)
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0])
        assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_bilstm_train_kernels_take_strided_and_offset_inputs(cuda_device):
    """A time-major xp view, an xp slice at an odd offset (both taken as
    projections in the pack's column order), gout as a transposed view and
    W_hh as a slice of a larger tensor give the same result as contiguous
    copies."""
    g = torch.Generator().manual_seed(4)
    B, T, H = 9, 7, 64
    big = torch.randn(T, B, 4 * H + 1, generator=g).to(cuda_device)
    xp_f = big[..., 1:].transpose(0, 1)            # [B,T,4H], not contiguous
    flat = torch.randn(B * T * 4 * H + 1, generator=g).to(cuda_device)
    xp_b = flat[1:].view(B, T, 4 * H)              # contiguous, base 4 B off
    w = (torch.rand(2, 4 * H + 1, H, generator=g) / 8).to(cuda_device)[:, 1:]
    pack = fl.pack_weights("cluster_fma", w[0], w[1], None)
    got = fl.bilstm_train_forward_packed(pack, xp_f, xp_b)
    want = fl.bilstm_train_forward_packed(pack, xp_f.contiguous(),
                                          xp_b.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out, gates, cs = want
    gout = torch.randn(T, B, 2 * H, generator=g).to(cuda_device).transpose(
        0, 1)
    got = fl.bilstm_train_backward_kernel(pack, gout, gates, cs, out)
    want = fl.bilstm_train_backward_kernel(pack, gout.contiguous(), gates,
                                           cs, out)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,F,H", [(64, 33, 26, 256), (37, 21, 48, 256),
                                     (6, 12, 10, 32)])
def test_fused_bilstm_train_gradients_match_plain(cuda_device, B, T, F, H):
    """Through the autograd function: the kernels' gradients of x and of
    all eight parameters against the plain versions' on the CPU (f32).
    Tolerance relative to each gradient's largest entry: the two sides sum
    B*T-long products in different orders."""
    g = torch.Generator().manual_seed(B + F)
    names = fl._PARAM_NAMES
    params = {n: (torch.rand((4 * H, F) if "weight_ih" in n else
                             (4 * H, H) if "weight_hh" in n else (4 * H,),
                             generator=g) * 2 - 1) / H ** 0.5 for n in names}
    x = torch.randn(B, T, F, generator=g)
    weight = torch.randn(B, T, 2 * H, generator=g)

    def grads(device):
        p = {n: v.to(device).requires_grad_() for n, v in params.items()}
        xd = x.to(device).requires_grad_()
        out = fl.fused_bilstm_train(p, xd)
        (out * weight.to(device)).sum().backward()
        return (out.detach().cpu(),
                {**{n: v.grad.cpu() for n, v in p.items()},
                 "x": xd.grad.cpu()})

    before = (fl.train_fwd_launches, fl.train_bwd_launches)
    got_out, got = grads(cuda_device)
    assert (fl.train_fwd_launches, fl.train_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    want_out, want = grads(torch.device("cpu"))
    assert (got_out - want_out).abs().max().item() <= 1e-4
    for name in want:
        scale = max(1.0, want[name].abs().max().item())
        err = (got[name] - want[name]).abs().max().item()
        assert err <= 1e-3 * scale, (name, err, scale)


@pytest.mark.cuda
def test_bilstm_train_kernels_reject_what_they_do_not_take(cuda_device):
    xp = torch.zeros(2, 3, 4 * 512, device=cuda_device)
    w = torch.zeros(512, 4 * 512, device=cuda_device)
    before = (fl.train_fwd_launches, fl.train_bwd_launches)
    with pytest.raises(ValueError, match="hidden size"):
        _k3(xp, xp, w, w)
    with pytest.raises(ValueError, match="hidden size"):     # 6 % 4 != 0
        _k3(xp[..., :24], xp[..., :24], w[:6, :24], w[:6, :24])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _k3(xp[..., :64].half(), xp[..., :64].half(), w[:16, :64].half(),
            w[:16, :64].half())
    out = torch.zeros(2, 3, 32, device=cuda_device)
    pack = fl.pack_weights("generic", w[:64, :16], w[:64, :16], None)
    with pytest.raises(ValueError, match="bad residuals"):
        fl.bilstm_train_backward_kernel(pack, out, xp[None, ..., :64],
                                        out[None], out)
    mma = fl.pack_weights("cluster_mma", w[:64, :16], w[:64, :16], None)
    with pytest.raises(ValueError, match="does not fit"):
        fl.bilstm_train_backward_kernel(
            mma, out, torch.zeros(2, 2, 3, 64, device=cuda_device),
            torch.zeros(2, 2, 3, 16, device=cuda_device), out)
    with pytest.raises(ValueError, match="does not take"):
        fl.launch_backward(
            "cluster_fma", pack, out,
            torch.zeros(2, 2, 3, 64, device=cuda_device),
            torch.zeros(2, 2, 3, 16, device=cuda_device), out)
    assert (fl.train_fwd_launches, fl.train_bwd_launches) == before


@pytest.mark.cuda
def test_inference_kernels_raise_under_grad(cuda_device):
    """K1 and K2 write their outputs through ctypes, with no autograd node:
    under grad, with a parameter or the input requiring it, their wrappers
    raise instead of returning an output with no gradient; under
    inference_mode they launch."""
    gru = {n: v.requires_grad_() for n, v in
           _gru_layer(cuda_device, torch.float32, 10, 32, 1).items()}
    x = torch.randn(3, 5, 10, device=cuda_device)
    h0 = torch.zeros(3, 2, 32, device=cuda_device)
    lstm = {n: v.requires_grad_() for n, v in
            _lstm_layer(cuda_device, torch.float32, 10, 32, 2).items()}
    before = (fg.launches, fl.launches)
    with pytest.raises(RuntimeError, match="fused_rnn=False"):
        fg.fused_bigru(gru, x, h0)
    with pytest.raises(RuntimeError, match="fused_bilstm_train"):
        fl.fused_bilstm(lstm, x)
    plain = {n: v.detach() for n, v in gru.items()}
    with pytest.raises(RuntimeError, match="no backward"):
        fg.fused_bigru(plain, x, h0.clone().requires_grad_())
    assert (fg.launches, fl.launches) == before
    with torch.inference_mode():
        fg.fused_bigru(gru, x, h0)
        fl.fused_bilstm(lstm, x)
    assert (fg.launches, fl.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_polish_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One window step of the polish trainer (the differentiable step loop,
    Adam) at full width on the card against the same step on the CPU, from
    the same weights: the loss at rtol 1e-4, the updated parameters within
    2 lr (Adam's first update is lr * g / (|g| + eps))."""
    from pepper_tpu_torch.models.polish_model import init_polish_params
    from pepper_tpu_torch.train import polish_train as pt
    from pepper_tpu_torch.train import variant_train as vt

    tree = init_polish_params(torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    x = (torch.rand(8, 100, 10, generator=g) * 60).floor()
    y = torch.randint(0, 5, (8, 100), generator=g)
    h0 = torch.randn(8, 2, 128, generator=g) * 0.5
    lr = 1e-3
    runs = {}
    for device in (cuda_device, torch.device("cpu")):
        params = vt.trainable(tree, device)
        step = pt.make_polish_train_step(params, vt.make_optimizer(
            params, lr, 1e-6))
        hidden, loss = step(x.to(device), y.to(device), h0.to(device))
        runs[device.type] = (float(loss), hidden.cpu(), {
            k: p.detach().cpu() for k, p in vt.sorted_leaves(params)})
    (loss, hidden, got), (want_loss, want_hidden, want) = (
        runs["cuda"], runs["cpu"])
    assert loss == pytest.approx(want_loss, rel=1e-4)
    assert (hidden - want_hidden).abs().max().item() <= 1e-4
    for k in want:
        assert (got[k] - want[k]).abs().max().item() <= 2 * lr, k


@pytest.mark.cuda
def test_hp_runner_batch_launches_k1_at_21x48(cuda_device, monkeypatch):
    """A streamed runner batch of 21x48 HP images through a 48-feature
    classifier (first W_ih [1024, 48]): K1 launches once per biLSTM layer on
    the card, and the probabilities agree with the CPU runner's f32 ones."""
    import numpy as np

    from pepper_tpu_torch.models.variant_model import init_variant_params
    from pepper_tpu_torch.runtime.streaming import DeviceRunner

    params = init_variant_params(torch.Generator().manual_seed(5),
                                 image_features=48, window=21)
    tree = {grp: {k: v.numpy() for k, v in leaves.items()}
            for grp, leaves in params.items()}
    assert tree["encoder"]["weight_ih_l0"].shape == (1024, 48)
    rng = np.random.default_rng(6)
    images = rng.integers(-125, 126, (300, 21, 48))
    images[rng.random(images.shape) < 0.7] = 0
    images = images.astype(np.int8)
    probs = {}
    for precision in ("bf16", "f32"):
        monkeypatch.setenv("PEPPER_TPU_PRECISION", precision)
        runner = DeviceRunner(tree, 1000, device="cuda")
        before = fl.launches
        probs[precision] = np.asarray(runner.submit(images))[:300]
        assert fl.launches == before + 2
    want = np.asarray(DeviceRunner(tree, 1000, device="cpu")
                      .submit(images))[:300]
    assert np.abs(probs["f32"] - want).max() <= 1e-3
    assert np.abs(probs["bf16"] - want).max() <= 2e-2


@pytest.mark.cuda
def test_two_replica_runner_on_one_card_matches_one_replica(cuda_device,
                                                            monkeypatch):
    """A 2-entry mesh on one card (two parameter replicas, each on its own
    stream) against one replica, bf16. K1 (`cluster_mma` at every row
    count) takes each row on its own: on the two halves of a batch it
    gives the whole's bits. The cuBLAS GEMMs around it choose their kernel
    by row count, so the probabilities agree within bf16 rounding (1e-2),
    a class changing only at a top-two margin that small. K1 launches
    twice per replica."""
    import numpy as np

    from pepper_tpu_torch.models.variant_model import init_variant_params
    from pepper_tpu_torch.runtime.streaming import DeviceRunner

    monkeypatch.setenv("PEPPER_TPU_PRECISION", "bf16")
    params = init_variant_params(torch.Generator().manual_seed(8))
    tree = {grp: {k: v.numpy() for k, v in leaves.items()}
            for grp, leaves in params.items()}
    rng = np.random.default_rng(9)
    images = rng.integers(-125, 126, (3000, 33, 26))
    images[rng.random(images.shape) < 0.7] = 0
    images = images.astype(np.int8)
    two = DeviceRunner(tree, 4096, device=["cuda:0", "cuda:0"])
    one = DeviceRunner(tree, 4096, device="cuda:0")
    assert two.batch == one.batch == 4096 and len(two.mesh) == 2
    before = fl.launches
    got = np.asarray(two.submit(images))
    assert fl.launches == before + 4
    want = np.asarray(one.submit(images))
    err = np.abs(got - want).max()
    assert err <= 1e-2
    flipped = got.argmax(1) != want.argmax(1)
    top2 = np.sort(want, axis=1)[:, -2:]
    assert (np.diff(top2[flipped], axis=1) <= 2 * err).all()
    x8 = torch.from_numpy(images[:2048]).to(cuda_device)
    assert (two.forward(x8) - one.forward(x8)).abs().max() <= 1e-2
    enc = one._replicas[0]["encoder"]
    pack = fl.packed_layer(enc, fl.select_kernel(2048, 33, 256,
                                                 torch.bfloat16))
    with torch.inference_mode():
        xp = fl.packed_projections(pack, x8.to(torch.bfloat16))
        whole = fl.bilstm_recurrence_packed(pack, *xp)
        halves = torch.cat([
            fl.bilstm_recurrence_packed(pack, *(p[:1024] for p in xp)),
            fl.bilstm_recurrence_packed(pack, *(p[1024:] for p in xp))])
    assert torch.equal(whole, halves)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("features,window", [(26, 33), (48, 21)])
def test_runner_graph_replays_the_eager_forward_bit_for_bit(
        cuda_device, monkeypatch, precision, features, window):
    """A runner's batches at 16384 rows: the first of a shape runs eagerly
    and its forward is then captured as a CUDA graph, every later one
    replays it. The replay gives the eager forward's bits (33x26 and the HP
    pass's 21x48, bf16 and f32), counts its two K1 launches and one replay,
    and a short batch in a reused slot reads zeros after its rows."""
    import numpy as np

    from pepper_tpu_torch.models.variant_model import init_variant_params
    from pepper_tpu_torch.runtime.streaming import DeviceRunner

    monkeypatch.setenv("PEPPER_TPU_PRECISION", precision)
    params = init_variant_params(torch.Generator().manual_seed(12),
                                 image_features=features, window=window)
    tree = {grp: {k: v.numpy() for k, v in leaves.items()}
            for grp, leaves in params.items()}
    runner = DeviceRunner(tree, 16384, device="cuda")
    assert runner.batch == 16384
    rng = np.random.default_rng(13)
    images = rng.integers(-125, 126, (16384, window, features))
    images[rng.random(images.shape) < 0.7] = 0
    images = images.astype(np.int8)
    kernel = fl.select_kernel(16384, window, 256, runner.dtype)
    launches, by_kernel = fl.launch_counts()
    replays = fl.graph_replays
    first = np.asarray(runner.submit(images))        # eager, then captured
    assert (fl.launches, fl.graph_replays) == (launches + 2, replays)
    second = np.asarray(runner.submit(images))       # the graph
    assert (fl.launches, fl.graph_replays) == (launches + 4, replays + 1)
    assert fl.kernel_launches[kernel] == by_kernel[kernel] + 4
    with torch.inference_mode():
        eager = runner.forward(torch.from_numpy(images).to(
            cuda_device)).cpu().numpy()
    assert (_bits(first) == _bits(eager)).all()
    assert (_bits(second) == _bits(eager)).all()
    short = images[:5000]
    got = np.asarray(runner.submit([short[:3000], short[3000:]]))
    assert fl.graph_replays == replays + 2
    padded = np.zeros_like(images)
    padded[:5000] = short
    with torch.inference_mode():
        want = runner.forward(torch.from_numpy(padded).to(
            cuda_device)).cpu().numpy()
    assert (_bits(got) == _bits(want)).all()


@pytest.mark.cuda
def test_two_replica_runner_graphs_replay_each_replicas_forward(
        cuda_device, monkeypatch):
    """A 2-entry mesh on one card: each replica captures its own graph on
    its own stream after the first batch, and a replay gives the eager
    batch's bits, with two K1 launches and one replay per replica."""
    import numpy as np

    from pepper_tpu_torch.models.variant_model import init_variant_params
    from pepper_tpu_torch.runtime.streaming import DeviceRunner

    monkeypatch.setenv("PEPPER_TPU_PRECISION", "bf16")
    params = init_variant_params(torch.Generator().manual_seed(14))
    tree = {grp: {k: v.numpy() for k, v in leaves.items()}
            for grp, leaves in params.items()}
    rng = np.random.default_rng(15)
    images = rng.integers(-125, 126, (8000, 33, 26))
    images[rng.random(images.shape) < 0.7] = 0
    images = images.astype(np.int8)
    two = DeviceRunner(tree, 8192, device=["cuda:0", "cuda:0"])
    launches, replays = fl.launches, fl.graph_replays
    first = np.asarray(two.submit(images))
    assert (fl.launches, fl.graph_replays) == (launches + 4, replays)
    second = np.asarray(two.submit(images))
    assert (fl.launches, fl.graph_replays) == (launches + 8, replays + 2)
    assert (_bits(first) == _bits(second)).all()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_train_as_one_process(cuda_device,
                                                         tmp_path):
    """Two ranks of a gloo group over CUDA tensors on one card (NCCL
    refuses two ranks on one card): 4 variant train steps with dropout on,
    the ranks bit-identical and equal to one process that runs the two
    blocks as in-process replicas; K3 and K4 launch in each rank."""
    import os
    import socket
    import subprocess
    import sys

    import numpy as np

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(10)
    np.save(tmp_path / "images.npy",
            rng.integers(-125, 126, (64, 33, 26)).astype(np.int8))
    np.save(tmp_path / "labels.npy", rng.integers(0, 3, 64))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def rank_cmd(tag, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "pepper_tpu_torch.parallel.dp_rehearsal",
             "variant", "--data", str(tmp_path), "--steps", "4", "--hidden",
             "64", "--device", "cuda:0", "--dropout", "--out",
             str(tmp_path / f"{tag}.npz"), *extra], cwd=root,
            env=dict(os.environ, PYTHONPATH=root), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)

    procs = [rank_cmd(f"rank{r}", "--rank", str(r), "--world", "2",
                    "--backend", "gloo", "--coordinator",
                    f"127.0.0.1:{port}") for r in range(2)]
    procs.append(rank_cmd("single", "--blocks", "2"))
    for p in procs:
        try:
            _, err = p.communicate(timeout=600)
        finally:
            p.kill()
        assert p.returncode == 0, err.decode()[-3000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    single = np.load(tmp_path / "single.npz")
    keys = [k for k in single.files if not k.startswith("__")]
    assert len(keys) == 28
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        np.testing.assert_allclose(ranks[0][k], single[k], rtol=5e-3,
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(ranks[0]["__losses__"], single["__losses__"],
                               rtol=1e-4)
    for r in ranks:
        assert list(r["__launches__"]) == [8, 8]   # K3, K4: 2 per step


def _numpy_tree(params):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("seq_len", [1000, 230])
def test_hp_legacy_votes_through_k2_match_the_plain_route(cuda_device,
                                                          monkeypatch,
                                                          seq_len):
    """The legacy chunked-HP vote at full width (48 features, hidden 128,
    5 classes): at f32 on the card, both biGRU layers of every window
    launch K2 (19 windows x 2 layers x 2 haplotypes at seq_len 1000; at
    230 the last window is skipped, 3 windows), and the int votes are within
    +-2 of the plain step loop's on the CPU (two windows cover an interior
    position and each truncation can move by one). In bf16 every launch
    runs K2 `mma`, and each is held against K2's plain version on the
    inputs it had, at the bf16 bound of the kernel tests (2e-2)."""
    import numpy as np

    from pepper_tpu_torch.models import polish_model
    from pepper_tpu_torch.models.polish_model import init_polish_params
    from pepper_tpu_torch.pipelines.hp_legacy import make_hp_window_vote_fn

    tree = _numpy_tree(init_polish_params(torch.Generator().manual_seed(7),
                                          image_features=48, hidden=128,
                                          num_classes=5))
    rng = np.random.default_rng(8)
    x = rng.integers(0, 60, (2, 16, seq_len, 48))
    x[rng.random(x.shape) < 0.6] = 0
    x1, x2 = (torch.from_numpy(a.astype(np.uint8)) for a in x)
    windows = (seq_len - 100) // 50 + 1
    kw = dict(num_classes=5, seq_len=seq_len, hidden_size=128)
    want = make_hp_window_vote_fn(tree, device="cpu", fused_rnn=False,
                                  **kw)(x1, x2)
    layer, calls = polish_model.fused_bigru, []

    def recorded(params, x, h0):
        result = layer(params, x, h0)
        calls.append((params, x, h0, result))
        return result

    monkeypatch.setattr(polish_model, "fused_bigru", recorded)
    for precision in ("f32", "bf16"):
        monkeypatch.setenv("PEPPER_TPU_PRECISION", precision)
        fn = make_hp_window_vote_fn(tree, device="cuda", **kw)
        before, mma_before = fg.launches, fg.kernel_launches["mma"]
        calls.clear()
        got = fn(x1, x2)
        torch.cuda.synchronize()
        assert fg.launches == before + 4 * windows == before + len(calls)
        for g, w in zip(got, want):
            g = g.cpu()
            assert g.dtype == torch.int32 and g.shape == w.shape
            covered = g[:, :(windows - 1) * 50 + 100].sum(-1)
            assert (covered >= 9990).all() and (covered <= 20000).all()
            if precision == "f32":
                assert (g - w).abs().max().item() <= 2
        if precision == "bf16":
            assert fg.kernel_launches["mma"] == mma_before + 4 * windows
            with torch.inference_mode():
                for params, x, h0, (out, h_n) in calls:
                    assert x.dtype == torch.bfloat16
                    plain = _gru_plain(params,
                                       *fg.input_projections(params, x), h0)
                    for a, b in zip((out, h_n), plain):
                        err = (a.float() - b.float()).abs().max().item()
                        assert err <= 2e-2, err


@pytest.mark.cuda
def test_alternate_models_on_the_card_match_the_cpu(cuda_device,
                                                    monkeypatch):
    """The transformer (F=26, window 33, 6 layers, d=104) and the no-CNN
    biLSTM (hidden 128, a random carried state) at full width in f32 on the
    card against the CPU (TF32 off): probabilities within 1e-4."""
    from pepper_tpu_torch.models import variant_no_cnn as no_cnn
    from pepper_tpu_torch.models import variant_transformer as tf

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator().manual_seed(9)
    x = torch.randint(-125, 126, (64, 33, 26), generator=g).float()
    h = torch.randn(64, 2, 128, generator=g)
    c = torch.randn(64, 2, 128, generator=g)
    cases = [(tf.init_transformer_params(g), tf.transformer_forward, (x,)),
             (no_cnn.init_no_cnn_params(g), no_cnn.no_cnn_forward,
              (x, h, c))]
    for params, forward, args in cases:
        want = forward(params, *args)
        got = forward(_to(params, cuda_device),
                      *(a.to(cuda_device) for a in args))
        assert got.shape == want.shape == (64, 3)
        assert (got.cpu() - want).abs().max().item() <= 1e-4


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_scale_rehearsal_resumes_byte_identical_on_the_card(cuda_device,
                                                            tmp_path):
    """The scale rehearsal at 1 Mbp over 2 contigs on cuda:0 in bf16 at the
    16384-row batch: the run killed after half of the batches exits 9, the
    resume replays at least one interval and writes the uninterrupted run's
    5 VCFs byte for byte, and K1 launches twice per batch."""
    import json
    import subprocess
    import sys

    out = str(tmp_path / "record.json")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PEPPER_TPU_MIN_DEVICE_BATCH",
                        "PEPPER_TPU_PRECISION")}
    p = subprocess.run(
        [sys.executable, "-m", "pepper_tpu_torch.utils.scale_rehearsal",
         "--mbp", "1", "--contigs", "2", "--device", "cuda:0", "--out", out,
         "--cache-dir", str(tmp_path)],
        cwd=_REPO, env=env, capture_output=True, timeout=900)
    assert p.returncode == 0, p.stderr.decode()[-4000:]
    with open(out) as fh:
        rec = json.load(fh)
    assert rec["precision"] == "bf16" and rec["batch_floor"] == 16384
    assert rec["crash_exit_code"] == 9
    assert int(rec["resume_replayed"].split("/")[0]) >= 1
    assert rec["resume_byte_identical"] is True, rec["first_difference"]
    assert rec["k1_launches"] == 2 * -(-rec["candidates"] // 16384)
    assert 0 < rec["peak_device_mb"] < 80_000
    assert 0 < rec["device_busy_s"] < rec["stream_s"]
    assert 0 < rec["device_idle_share"] < 1
    end = rec["rss_parts_mb"]["end"]
    assert 0 < end["pinned_host_mb"] <= end["pinned_host_peak_mb"]


_POLISH_DRIVER = """
import sys
sys.path.insert(0, {repo!r})
from pepper_tpu_torch.polish.pipeline import polish
bam, draft, model, out = sys.argv[1:5]
polish(bam, draft, model, out, threads=2, realignment=False, device="cuda")
"""


@pytest.mark.cuda
def test_polish_kill9_resume_byte_identical_on_the_card(cuda_device,
                                                        tmp_path):
    """The streamed polish through the CUDA ConsensusRunner (K2, bf16):
    killed after 6 flushed sequences it exits 9 and leaves its journal; the
    resume replays from it and writes the uninterrupted run's FASTA byte
    for byte."""
    import subprocess
    import sys

    from pepper_tpu_torch.models.checkpoint import save_checkpoint
    from pepper_tpu_torch.models.polish_model import init_polish_params
    from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                              simulate_reads_fast,
                                              write_dataset)

    genome = random_genome(8000, seed=81, n_contigs=4)
    edits = plant_variants(dict(genome), 8, 2, 2, seed=82)
    edits = [type(v)(v.contig, v.pos, v.ref, v.alt, (1, 1)) for v in edits]
    draft, bam = write_dataset(str(tmp_path), genome, simulate_reads_fast(
        genome, edits, coverage=25, read_length=1500, error_rate=0.03,
        seed=83))
    model = str(tmp_path / "polish_model.npz")
    save_checkpoint(model, init_polish_params(
        torch.Generator().manual_seed(4)), {})

    def run(out, crash_after=0):
        env = {k: v for k, v in os.environ.items()
               if k != "PEPPER_TPU_PRECISION"}
        if crash_after:
            env["PEPPER_TPU_TEST_CRASH_AFTER_POLISH_FLUSH"] = str(crash_after)
        return subprocess.run(
            [sys.executable, "-c", _POLISH_DRIVER.format(repo=_REPO), bam,
             draft, model, out], env=env, capture_output=True, timeout=600)

    ref_out = str(tmp_path / "ref_out") + "/"
    p = run(ref_out)
    assert p.returncode == 0, p.stderr.decode()[-3000:]
    with open(ref_out + "PEPPER_pepper_polished.fa", "rb") as fh:
        ref = fh.read()
    assert ref
    out = str(tmp_path / "crash_out") + "/"
    p = run(out, crash_after=6)
    assert p.returncode == 9, (p.returncode, p.stderr.decode()[-2000:])
    assert os.path.isfile(out + "pepper_polish_resume.journal")
    p = run(out)
    assert p.returncode == 0, p.stderr.decode()[-3000:]
    assert "REPLAYED FROM JOURNAL" in p.stderr.decode()
    with open(out + "PEPPER_pepper_polished.fa", "rb") as fh:
        assert fh.read() == ref
    assert not os.path.isfile(out + "pepper_polish_resume.journal")
