"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips where there is no CUDA
device (a CUDA kernel has no CPU mode). This file imports neither jax nor
the JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from pepper_tpu_torch.ops import fused_gru as fg
from pepper_tpu_torch.ops import fused_lstm as fl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


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
    got = fl.bilstm_recurrence(*xp, *w)
    torch.cuda.synchronize()
    assert fl.launches == before + 1
    want = fl.bilstm_recurrence_plain(*xp, *w)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= atol, err


@pytest.mark.cuda
def test_bilstm_kernel_takes_strided_and_offset_inputs(cuda_device):
    """A time-major view and an xp slice at an odd offset give the same
    result as contiguous copies (the wrapper copies what the kernel cannot
    read directly)."""
    g = torch.Generator().manual_seed(1)
    B, T, H = 9, 7, 64
    big = torch.randn(T, B, 4 * H + 1, generator=g).to(cuda_device)
    xp_f = big[..., 1:].transpose(0, 1)            # [B,T,4H], not contiguous
    flat = torch.randn(B * T * 4 * H + 1, generator=g).to(cuda_device)
    xp_b = flat[1:].view(B, T, 4 * H)              # contiguous, base 4 B off
    assert xp_b.is_contiguous() and xp_b.data_ptr() % 16
    w = (torch.rand(2, H, 4 * H, generator=g) / 8).to(cuda_device)
    got = fl.bilstm_recurrence(xp_f, xp_b, w[0], w[1])
    want = fl.bilstm_recurrence(xp_f.contiguous(), xp_b.clone(), w[0], w[1])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bilstm_kernel_rejects_what_it_does_not_take(cuda_device):
    xp = torch.zeros(2, 3, 4 * 512, device=cuda_device)
    w = torch.zeros(512, 4 * 512, device=cuda_device)
    before = fl.launches
    with pytest.raises(ValueError, match="hidden size"):
        fl.bilstm_recurrence(xp, xp, w, w)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fl.bilstm_recurrence(xp[..., :64].half(), xp[..., :64].half(),
                             w[:16, :64].half(), w[:16, :64].half())
    assert fl.launches == before


def _gru_inputs(device, dtype, B, T, F, H, seed):
    """(xp_f, xp_b, W_hh^T f/b, b_hh f/b, h0 f/b) from a seeded biGRU layer
    with torch's default init, a random input and a nonzero h0."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return ((torch.rand(*shape, generator=g) * 2 - 1) / H ** 0.5).to(
            device, dtype)

    params = {}
    for sfx in ("", "_reverse"):
        params["weight_ih_l0" + sfx] = u(3 * H, F)
        params["bias_ih_l0" + sfx] = u(3 * H)
    x = torch.randn(B, T, F, generator=g).to(device, dtype)
    xp_f, xp_b = fg.input_projections(params, x)
    h0 = (torch.randn(2, B, H, generator=g) * 0.5).to(device, dtype)
    return (xp_f, xp_b, u(H, 3 * H), u(H, 3 * H), u(3 * H).float(),
            u(3 * H).float(), h0[0], h0[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,T,F,H", [(128, 100, 10, 128),
                                     (128, 100, 256, 128),
                                     (37, 100, 10, 128), (5, 1, 256, 128),
                                     (9, 40, 10, 64)])
def test_bigru_kernel_matches_plain(cuda_device, dtype, atol, B, T, F, H):
    """bf16 tolerance: h is rounded to bf16 each step and the two versions
    sum the product in different orders; checked on out and the final h."""
    args = _gru_inputs(cuda_device, dtype, B, T, F, H, seed=B + T + F)
    before = fg.launches
    got_out, got_h = fg.bigru_recurrence(*args)
    torch.cuda.synchronize()
    assert fg.launches == before + 1
    want_out, want_h = fg.bigru_recurrence_plain(*args)
    assert got_out.dtype == got_h.dtype == dtype
    assert got_h.shape == (B, 2, H)
    for got, want in ((got_out, want_out), (got_h, want_h)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= atol, err


@pytest.mark.cuda
def test_bigru_kernel_takes_strided_and_offset_inputs(cuda_device):
    """A time-major view, an xp slice at an odd offset, W_hh^T as a
    transposed view and h0 as a strided slice of [B,2,H] give the same
    result as contiguous copies."""
    g = torch.Generator().manual_seed(2)
    B, T, H = 9, 7, 64
    big = torch.randn(T, B, 3 * H + 1, generator=g).to(cuda_device)
    xp_f = big[..., 1:].transpose(0, 1)            # [B,T,3H], not contiguous
    flat = torch.randn(B * T * 3 * H + 1, generator=g).to(cuda_device)
    xp_b = flat[1:].view(B, T, 3 * H)              # contiguous, base 4 B off
    w = (torch.rand(2, 3 * H, H, generator=g) / 8).to(cuda_device)
    b = (torch.rand(2, 3 * H, generator=g) / 8).to(cuda_device)
    h0 = torch.randn(B, 2, H, generator=g).to(cuda_device)
    got = fg.bigru_recurrence(xp_f, xp_b, w[0].t(), w[1].t(), b[0], b[1],
                              h0[:, 0], h0[:, 1])
    want = fg.bigru_recurrence(xp_f.contiguous(), xp_b.clone(),
                               w[0].t().contiguous(), w[1].t().contiguous(),
                               b[0].clone(), b[1].clone(),
                               h0[:, 0].contiguous(), h0[:, 1].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_bigru_kernel_rejects_what_it_does_not_take(cuda_device):
    def inputs(B, T, H, dtype):
        xp = torch.zeros(B, T, 3 * H, device=cuda_device, dtype=dtype)
        w = torch.zeros(H, 3 * H, device=cuda_device, dtype=dtype)
        b = torch.zeros(3 * H, device=cuda_device)
        h0 = torch.zeros(B, H, device=cuda_device, dtype=dtype)
        return xp, xp, w, w, b, b, h0, h0

    before = fg.launches
    with pytest.raises(ValueError, match="hidden size"):
        fg.bigru_recurrence(*inputs(2, 3, 256, torch.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fg.bigru_recurrence(*inputs(2, 3, 32, torch.float16))
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
                (9, 12, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-4)])
@pytest.mark.parametrize("B,T,H", TRAIN_SHAPES)
def test_bilstm_train_forward_kernel_matches_plain(cuda_device, dtype, atol,
                                                   B, T, H):
    """K3: out, the activated gates and the cell states. bf16 tolerance: h
    is rounded to bf16 each step and the sums run in another order."""
    xp, w = _train_inputs(cuda_device, dtype, B, T, H, seed=B + T)
    before = fl.train_fwd_launches
    got = fl.bilstm_train_forward(*xp, w[0].t(), w[1].t())
    torch.cuda.synchronize()
    assert fl.train_fwd_launches == before + 1
    want = fl.bilstm_train_forward_plain(*xp, w[0].t(), w[1].t())
    assert got[0].dtype == dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, a, b in zip(("out", "gates", "cs"), got, want):
        assert a.shape == b.shape, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= atol, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,H", TRAIN_SHAPES)
def test_bilstm_train_backward_kernel_matches_plain(cuda_device, dtype, B, T,
                                                    H):
    """K4 on the plain forward's residuals: dxp and dW_hh. Both versions
    compute in f32 from the same residuals, so only the order of the sums
    differs: 1e-4 on dxp; dW_hh sums B*T products, 1e-3 relative to its
    largest entry."""
    xp, w = _train_inputs(cuda_device, dtype, B, T, H, seed=B + T + 1)
    out, gates, cs = fl.bilstm_train_forward_plain(*xp, w[0].t(), w[1].t())
    g = torch.Generator().manual_seed(3)
    gout = torch.randn(B, T, 2 * H, generator=g).to(cuda_device, dtype)
    before = fl.train_bwd_launches
    dxp, dwhh = fl.bilstm_train_backward(gout, gates, cs, out, w[0].float(),
                                         w[1].float())
    torch.cuda.synchronize()
    assert fl.train_bwd_launches == before + 1
    want_dxp, want_dwhh = fl.bilstm_train_backward_plain(
        gout, gates, cs, out, w[0].float(), w[1].float())
    assert (dxp - want_dxp).abs().max().item() <= 1e-4
    scale = max(1.0, want_dwhh.abs().max().item())
    assert (dwhh - want_dwhh).abs().max().item() <= 1e-3 * scale


@pytest.mark.cuda
def test_bilstm_train_backward_kernel_is_deterministic(cuda_device):
    """No atomics: two calls on the same inputs give the same bits."""
    B, T, H = 100, 33, 256
    xp, w = _train_inputs(cuda_device, torch.float32, B, T, H, seed=8)
    out, gates, cs = fl.bilstm_train_forward(*xp, w[0].t(), w[1].t())
    gout = torch.randn(B, T, 2 * H, device=cuda_device)
    first = fl.bilstm_train_backward(gout, gates, cs, out, w[0], w[1])
    second = fl.bilstm_train_backward(gout, gates, cs, out, w[0], w[1])
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_bilstm_train_kernels_take_strided_and_offset_inputs(cuda_device):
    """A time-major xp view, an xp slice at an odd offset, gout as a
    transposed view and W_hh as a slice of a larger tensor give the same
    result as contiguous copies."""
    g = torch.Generator().manual_seed(4)
    B, T, H = 9, 7, 64
    big = torch.randn(T, B, 4 * H + 1, generator=g).to(cuda_device)
    xp_f = big[..., 1:].transpose(0, 1)            # [B,T,4H], not contiguous
    flat = torch.randn(B * T * 4 * H + 1, generator=g).to(cuda_device)
    xp_b = flat[1:].view(B, T, 4 * H)              # contiguous, base 4 B off
    w = (torch.rand(2, 4 * H + 1, H, generator=g) / 8).to(cuda_device)[:, 1:]
    got = fl.bilstm_train_forward(xp_f, xp_b, w[0].t(), w[1].t())
    want = fl.bilstm_train_forward(xp_f.contiguous(), xp_b.clone(),
                                   w[0].t().contiguous(),
                                   w[1].t().contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    out, gates, cs = want
    gout = torch.randn(T, B, 2 * H, generator=g).to(cuda_device).transpose(
        0, 1)
    got = fl.bilstm_train_backward(gout, gates, cs, out, w[0], w[1])
    want = fl.bilstm_train_backward(gout.contiguous(), gates, cs, out,
                                    w[0].contiguous(), w[1].contiguous())
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
    names = fl._TRAIN_PARAM_NAMES
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
        fl.bilstm_train_forward(xp, xp, w, w)
    with pytest.raises(ValueError, match="hidden size"):     # 6 % 4 != 0
        fl.bilstm_train_forward(xp[..., :24], xp[..., :24], w[:6, :24],
                                w[:6, :24])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fl.bilstm_train_forward(xp[..., :64].half(), xp[..., :64].half(),
                                w[:16, :64].half(), w[:16, :64].half())
    out = torch.zeros(2, 3, 32, device=cuda_device)
    with pytest.raises(ValueError, match="bad residuals"):
        fl.bilstm_train_backward(out, xp[None, ..., :64], out[None], out,
                                 w[:64, :16], w[:64, :16])
    assert (fl.train_fwd_launches, fl.train_bwd_launches) == before
