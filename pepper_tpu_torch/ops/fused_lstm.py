"""Fused bidirectional LSTM layer (inference, zero initial state).

The recurrent loop of the variant classifier's biLSTM is the serial part of
the device forward: per step a [B,H] @ [H,4H] product plus the gate
nonlinearities. The input projection x @ W_ih^T for all timesteps (both
biases folded in) is one batched `torch.matmul` per direction outside the
recurrence, as in the JAX package (pepper_tpu/ops/fused_lstm.py:75-80).

The recurrence itself is kernel K1, `csrc/fused_lstm.cu`, for CUDA tensors,
and `bilstm_recurrence_plain` (same rounding points: xp and h in the input
dtype, c and the gate sums in f32) for CPU tensors. A CUDA tensor always
launches the kernel or raises; it never takes the plain loop.
"""
import ctypes
from typing import Dict

import torch

# kernel launches made by this process (reset by callers that count a run)
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        from pepper_tpu_torch.ops.cuda_build import load_library
        lib = load_library("fused_lstm")
        lib.pepper_bilstm_forward.restype = ctypes.c_int
        lib.pepper_bilstm_forward.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.pepper_bilstm_max_hidden.restype = ctypes.c_int
        lib.pepper_bilstm_max_hidden.argtypes = []
        _lib = lib
    return _lib


def bilstm_recurrence_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                            whh_t_f: torch.Tensor,
                            whh_t_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1. xp_*: [B,T,4H] (gates i,f,g,o, biases
    folded in); whh_t_*: [H,4H] (W_hh^T). Returns [B,T,2H] in xp's dtype."""
    B, T, G = xp_f.shape
    H = G // 4
    dtype = xp_f.dtype
    out = torch.empty((B, T, 2 * H), dtype=dtype, device=xp_f.device)
    for d, (xp, w) in enumerate(((xp_f, whh_t_f), (xp_b, whh_t_b))):
        w32 = w.float()
        h = torch.zeros((B, H), dtype=dtype, device=xp.device)
        c = torch.zeros((B, H), dtype=torch.float32, device=xp.device)
        steps = range(T - 1, -1, -1) if d else range(T)
        for t in steps:
            gates = xp[:, t].float() + h.float() @ w32
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
            out[:, t, d * H:(d + 1) * H] = h
    return out


def _permute_gates(whh_t: torch.Tensor) -> torch.Tensor:
    """[H,4H] -> [H,4H] with column 4j+q = gate q of hidden unit j, so one
    kernel thread reads its unit's four gate weights as one vector."""
    H = whh_t.shape[0]
    return whh_t.reshape(H, 4, H).transpose(1, 2).reshape(H, 4 * H)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernel's vector loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def bilstm_recurrence_kernel(xp_f: torch.Tensor, xp_b: torch.Tensor,
                             whh_t_f: torch.Tensor,
                             whh_t_b: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the tensors' CUDA device (current stream)."""
    global launches
    B, T, G = xp_f.shape
    H = G // 4
    dtype = xp_f.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused biLSTM kernel takes float32 or bfloat16, "
                        f"got {dtype}")
    tensors = (xp_f, xp_b, whh_t_f, whh_t_b)
    if any(not t.is_cuda or t.device != xp_f.device or t.dtype != dtype
           for t in tensors):
        raise ValueError("fused biLSTM kernel: all inputs must be CUDA "
                         "tensors of one device and dtype")
    if xp_b.shape != xp_f.shape or G != 4 * H \
            or whh_t_f.shape != (H, G) or whh_t_b.shape != (H, G):
        raise ValueError(f"fused biLSTM kernel: bad shapes xp {tuple(xp_f.shape)}"
                         f"/{tuple(xp_b.shape)}, W_hh^T {tuple(whh_t_f.shape)}")
    lib = _kernel_lib()
    if H > lib.pepper_bilstm_max_hidden():
        raise ValueError(f"fused biLSTM kernel: hidden size {H} exceeds "
                         f"{lib.pepper_bilstm_max_hidden()}")
    xp_f, xp_b = _aligned(xp_f), _aligned(xp_b)
    w_f, w_b = _permute_gates(whh_t_f), _permute_gates(whh_t_b)
    out = torch.empty((B, T, 2 * H), dtype=dtype, device=xp_f.device)
    with torch.cuda.device(xp_f.device):
        stream = torch.cuda.current_stream(xp_f.device).cuda_stream
        err = lib.pepper_bilstm_forward(
            xp_f.data_ptr(), xp_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
            out.data_ptr(), B, T, H, _DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused biLSTM kernel launch failed: error {err}")
    launches += 1
    return out


def bilstm_recurrence(xp_f: torch.Tensor, xp_b: torch.Tensor,
                      whh_t_f: torch.Tensor,
                      whh_t_b: torch.Tensor) -> torch.Tensor:
    """K1 for CUDA tensors, its plain version for CPU tensors."""
    if xp_f.is_cuda:
        return bilstm_recurrence_kernel(xp_f, xp_b, whh_t_f, whh_t_b)
    return bilstm_recurrence_plain(xp_f, xp_b, whh_t_f, whh_t_b)


def input_projections(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """(xp_f, xp_b): x @ W_ih^T + b_ih + b_hh per direction, [B,T,4H]."""
    xp_f = (torch.matmul(x, params["weight_ih_l0"].t())
            + params["bias_ih_l0"] + params["bias_hh_l0"])
    xp_b = (torch.matmul(x, params["weight_ih_l0_reverse"].t())
            + params["bias_ih_l0_reverse"] + params["bias_hh_l0_reverse"])
    return xp_f, xp_b


def fused_bilstm(params: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM with zero initial state, drop-in for rnn.lstm.

    x: [B, T, F] -> [B, T, 2H] (forward || backward), in x's dtype."""
    xp_f, xp_b = input_projections(params, x)
    return bilstm_recurrence(xp_f, xp_b, params["weight_hh_l0"].t(),
                             params["weight_hh_l0_reverse"].t())
