"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips where there is no CUDA
device (a CUDA kernel has no CPU mode). This file imports neither jax nor
the JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

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
