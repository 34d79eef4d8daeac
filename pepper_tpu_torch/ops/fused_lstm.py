"""Fused bidirectional LSTM layer (zero initial state): inference and
training.

The recurrent loop of the variant classifier's biLSTM is the serial part of
the device forward: per step a [B,H] @ [H,4H] product plus the gate
nonlinearities. The input projection x @ W_ih^T for all timesteps (both
biases folded in) is one batched `torch.matmul` per direction outside the
recurrence, as in the JAX package (pepper_tpu/ops/fused_lstm.py:75-80).

The recurrence itself is kernel K1, `csrc/fused_lstm.cu`, for CUDA tensors,
and `bilstm_recurrence_plain` (same rounding points: xp and h in the input
dtype, c and the gate sums in f32) for CPU tensors. A CUDA tensor always
launches the kernel or raises; it never takes the plain loop.

Training (`fused_bilstm_train`, a `torch.autograd.Function`) follows
pepper_tpu/ops/fused_lstm.py:232-373. Its forward is kernel K3 (the same
recurrence, which also stores the activated gates and the cell state of
every step in f32), its backward kernel K4 (reverse-time BPTT with a
(dh, dc) carry, emitting dgates as dxp, plus dW_hh), both in
`csrc/fused_lstm_train.cu`; the gradients of W_ih, of the four biases and
of x are batched `torch.matmul`s and sums outside the kernel. For CPU
tensors the forward is `bilstm_train_forward_plain` and the backward
`bilstm_train_backward_plain`, an explicit reverse-time loop with K4's
formulas (not autograd through the forward loop), so the CPU tests run the
wiring the card runs.
"""
import ctypes
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

# kernel launches made by this process (reset by callers that count a run):
# K1, K3 (train forward) and K4 (train backward: its two kernels count once)
launches = 0
train_fwd_launches = 0
train_bwd_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_train_lib = None


def _train_kernel_lib():
    global _train_lib
    if _train_lib is None:
        from pepper_tpu_torch.ops.cuda_build import load_library
        lib = load_library("fused_lstm_train")
        lib.pepper_bilstm_train_forward.restype = ctypes.c_int
        lib.pepper_bilstm_train_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.pepper_bilstm_train_backward.restype = ctypes.c_int
        lib.pepper_bilstm_train_backward.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.pepper_bilstm_train_max_hidden.restype = ctypes.c_int
        lib.pepper_bilstm_train_max_hidden.argtypes = []
        _train_lib = lib
    return _train_lib


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


def _check_forward_inputs(what: str, xp_f, xp_b, whh_t_f, whh_t_b) -> None:
    """The checks K1 and K3 share: type, device and shapes of xp [B,T,4H]
    and W_hh^T [H,4H] of both directions."""
    B, T, G = xp_f.shape
    H = G // 4
    dtype = xp_f.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {dtype}")
    tensors = (xp_f, xp_b, whh_t_f, whh_t_b)
    if any(not t.is_cuda or t.device != xp_f.device or t.dtype != dtype
           for t in tensors):
        raise ValueError(f"{what}: all inputs must be CUDA tensors of one "
                         f"device and dtype")
    if xp_b.shape != xp_f.shape or G != 4 * H \
            or whh_t_f.shape != (H, G) or whh_t_b.shape != (H, G):
        raise ValueError(f"{what}: bad shapes xp {tuple(xp_f.shape)}"
                         f"/{tuple(xp_b.shape)}, W_hh^T {tuple(whh_t_f.shape)}")


def bilstm_recurrence_kernel(xp_f: torch.Tensor, xp_b: torch.Tensor,
                             whh_t_f: torch.Tensor,
                             whh_t_b: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the tensors' CUDA device (current stream)."""
    global launches
    B, T, G = xp_f.shape
    H = G // 4
    dtype = xp_f.dtype
    _check_forward_inputs("fused biLSTM kernel", xp_f, xp_b, whh_t_f, whh_t_b)
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


# ---------------------------------------------------------------- training
def bilstm_train_forward_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                               whh_t_f: torch.Tensor, whh_t_b: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch version of K3: K1's recurrence, which also keeps every
    step's residuals at the original time index. Returns (out [B,T,2H] in
    xp's dtype, gates [2,B,T,4H] f32: activated i,f,g,o per direction,
    cs [2,B,T,H] f32: the updated cell state)."""
    B, T, G = xp_f.shape
    H = G // 4
    dtype, dev = xp_f.dtype, xp_f.device
    out = torch.empty((B, T, 2 * H), dtype=dtype, device=dev)
    gates = torch.empty((2, B, T, G), dtype=torch.float32, device=dev)
    cs = torch.empty((2, B, T, H), dtype=torch.float32, device=dev)
    for d, (xp, w) in enumerate(((xp_f, whh_t_f), (xp_b, whh_t_b))):
        w32 = w.float()
        h = torch.zeros((B, H), dtype=dtype, device=dev)
        c = torch.zeros((B, H), dtype=torch.float32, device=dev)
        for t in (range(T - 1, -1, -1) if d else range(T)):
            pre = xp[:, t].float() + h.float() @ w32
            i, f, g, o = pre.chunk(4, dim=-1)
            i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                          torch.sigmoid(o))
            c = f * c + i * g
            h = (o * torch.tanh(c)).to(dtype)
            gates[d, :, t] = torch.cat([i, f, g, o], dim=-1)
            cs[d, :, t] = c
            out[:, t, d * H:(d + 1) * H] = h
    return out, gates, cs


def bilstm_train_backward_plain(gout: torch.Tensor, gates: torch.Tensor,
                                cs: torch.Tensor, out: torch.Tensor,
                                whh_f: torch.Tensor, whh_b: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 (pepper_tpu/ops/fused_lstm.py:167-229).

    gout: [B,T,2H] gradient of the layer output; gates, cs, out: the
    forward's residuals and output; whh_*: W_hh [4H,H]. Each direction
    walks its forward steps in reverse with a (dh, dc) carry; its previous
    step is t-1 (forward direction) or t+1 (reverse direction), and at its
    first forward step h_prev and c_prev are the zero initial state.
    Returns (dxp [2,B,T,4H] f32: the gradient of the pre-activation gates,
    dwhh [2,4H,H] f32)."""
    B, T, H2 = gout.shape
    H = H2 // 2
    dev = gout.device
    dxp = torch.empty((2, B, T, 4 * H), dtype=torch.float32, device=dev)
    dwhh = torch.zeros((2, 4 * H, H), dtype=torch.float32, device=dev)
    for d, w in enumerate((whh_f, whh_b)):
        w32 = w.float()
        dh = torch.zeros((B, H), dtype=torch.float32, device=dev)
        dc = torch.zeros((B, H), dtype=torch.float32, device=dev)
        order = range(T) if d else range(T - 1, -1, -1)
        for s, t in enumerate(order):
            i, f, g, o = gates[d, :, t].chunk(4, dim=-1)
            if s == T - 1:
                c_prev = h_prev = torch.zeros_like(dh)
            else:
                t_prev = t + 1 if d else t - 1
                c_prev = cs[d, :, t_prev]
                h_prev = out[:, t_prev, d * H:(d + 1) * H].float()
            dh_tot = gout[:, t, d * H:(d + 1) * H].float() + dh
            tc = torch.tanh(cs[d, :, t])
            d_o = dh_tot * tc
            dc_tot = dc + dh_tot * o * (1.0 - tc * tc)
            dgates = torch.cat([dc_tot * g * i * (1.0 - i),
                                dc_tot * c_prev * f * (1.0 - f),
                                dc_tot * i * (1.0 - g * g),
                                d_o * o * (1.0 - o)], dim=-1)
            dxp[d, :, t] = dgates
            dh = dgates @ w32
            dc = dc_tot * f
            dwhh[d] += dgates.t() @ h_prev
    return dxp, dwhh


def _check_train_hidden(lib, H: int) -> None:
    if H > lib.pepper_bilstm_train_max_hidden() or H % 4:
        raise ValueError(
            f"fused biLSTM training kernels: hidden size {H} must be a "
            f"multiple of 4, at most {lib.pepper_bilstm_train_max_hidden()}")


def bilstm_train_forward_kernel(xp_f: torch.Tensor, xp_b: torch.Tensor,
                                whh_t_f: torch.Tensor, whh_t_b: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Launch K3 on the tensors' CUDA device (current stream)."""
    global train_fwd_launches
    B, T, G = xp_f.shape
    H = G // 4
    dtype, dev = xp_f.dtype, xp_f.device
    _check_forward_inputs("fused biLSTM training kernel", xp_f, xp_b,
                          whh_t_f, whh_t_b)
    lib = _train_kernel_lib()
    _check_train_hidden(lib, H)
    xp_f, xp_b = _aligned(xp_f), _aligned(xp_b)
    w_f, w_b = _permute_gates(whh_t_f), _permute_gates(whh_t_b)
    out = torch.empty((B, T, 2 * H), dtype=dtype, device=dev)
    gates = torch.empty((2, B, T, G), dtype=torch.float32, device=dev)
    cs = torch.empty((2, B, T, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pepper_bilstm_train_forward(
            xp_f.data_ptr(), xp_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
            out.data_ptr(), gates.data_ptr(), cs.data_ptr(), B, T, H,
            _DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused biLSTM training forward launch failed: "
                           f"error {err}")
    train_fwd_launches += 1
    return out, gates, cs


def bilstm_train_backward_kernel(gout: torch.Tensor, gates: torch.Tensor,
                                 cs: torch.Tensor, out: torch.Tensor,
                                 whh_f: torch.Tensor, whh_b: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (the reverse-time recurrence, then dW_hh) on the tensors'
    CUDA device (current stream)."""
    global train_bwd_launches
    B, T, H2 = gout.shape
    H = H2 // 2
    dtype, dev = out.dtype, out.device
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused biLSTM training kernel takes float32 or "
                        f"bfloat16, got {dtype}")
    tensors = (gout, gates, cs, out, whh_f, whh_b)
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError("fused biLSTM training kernel: all inputs must be "
                         "CUDA tensors of one device")
    if H2 != 2 * H or out.shape != gout.shape \
            or gates.shape != (2, B, T, 4 * H) or cs.shape != (2, B, T, H) \
            or whh_f.shape != (4 * H, H) or whh_b.shape != (4 * H, H) \
            or gates.dtype != torch.float32 or cs.dtype != torch.float32:
        raise ValueError(f"fused biLSTM training kernel: bad residuals gout "
                         f"{tuple(gout.shape)}, out {tuple(out.shape)}, gates "
                         f"{tuple(gates.shape)} {gates.dtype}, cs "
                         f"{tuple(cs.shape)} {cs.dtype}, W_hh "
                         f"{tuple(whh_f.shape)}")
    lib = _train_kernel_lib()
    _check_train_hidden(lib, H)
    gout, out = _aligned(gout.to(dtype)), _aligned(out)
    gates, cs = _aligned(gates), _aligned(cs)
    whh_f, whh_b = _aligned(whh_f.float()), _aligned(whh_b.float())
    dxp = torch.empty((2, B, T, 4 * H), dtype=torch.float32, device=dev)
    dwhh = torch.empty((2, 4 * H, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pepper_bilstm_train_backward(
            gout.data_ptr(), gates.data_ptr(), cs.data_ptr(), out.data_ptr(),
            whh_f.data_ptr(), whh_b.data_ptr(), dxp.data_ptr(),
            dwhh.data_ptr(), B, T, H, _DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused biLSTM training backward launch failed: "
                           f"error {err}")
    train_bwd_launches += 1
    return dxp, dwhh


def bilstm_train_forward(xp_f, xp_b, whh_t_f, whh_t_b):
    """K3 for CUDA tensors, its plain version for CPU tensors."""
    if xp_f.is_cuda:
        return bilstm_train_forward_kernel(xp_f, xp_b, whh_t_f, whh_t_b)
    return bilstm_train_forward_plain(xp_f, xp_b, whh_t_f, whh_t_b)


def bilstm_train_backward(gout, gates, cs, out, whh_f, whh_b):
    """K4 for CUDA tensors, its plain version for CPU tensors."""
    if out.is_cuda:
        return bilstm_train_backward_kernel(gout, gates, cs, out, whh_f,
                                            whh_b)
    return bilstm_train_backward_plain(gout, gates, cs, out, whh_f, whh_b)


_TRAIN_PARAM_NAMES = tuple(
    name + sfx for sfx in ("", "_reverse")
    for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"))


class _FusedBiLSTMTrain(torch.autograd.Function):
    """x and the eight parameters (in _TRAIN_PARAM_NAMES order) -> out."""

    @staticmethod
    def forward(ctx, x, *weights):
        params = dict(zip(_TRAIN_PARAM_NAMES, weights))
        xp_f, xp_b = input_projections(params, x)
        out, gates, cs = bilstm_train_forward(
            xp_f, xp_b, params["weight_hh_l0"].t(),
            params["weight_hh_l0_reverse"].t())
        ctx.save_for_backward(x, out, gates, cs, *weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        x, out, gates, cs, *weights = ctx.saved_tensors
        params = dict(zip(_TRAIN_PARAM_NAMES, weights))
        dxp, dwhh = bilstm_train_backward(
            gout, gates, cs, out, params["weight_hh_l0"],
            params["weight_hh_l0_reverse"])
        G = dxp.shape[-1]
        x2 = x.reshape(-1, x.shape[-1]).float()
        grads, dx = {}, None
        for d, sfx in enumerate(("", "_reverse")):
            dxp_d = dxp[d].reshape(-1, G)                    # [B*T, 4H] f32
            bias = dxp_d.sum(0)
            grads["weight_ih_l0" + sfx] = dxp_d.t() @ x2
            grads["weight_hh_l0" + sfx] = dwhh[d]
            grads["bias_ih_l0" + sfx] = bias
            grads["bias_hh_l0" + sfx] = bias
            if ctx.needs_input_grad[0]:
                part = dxp_d @ params["weight_ih_l0" + sfx].float()
                dx = part if dx is None else dx + part
        if dx is not None:
            dx = dx.reshape(x.shape).to(x.dtype)
        return (dx,) + tuple(grads[n].to(params[n].dtype)
                             for n in _TRAIN_PARAM_NAMES)


def fused_bilstm_train(params: Dict[str, torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """`fused_bilstm` with a hand-written backward: same contract as
    rnn.lstm (zero initial state, [B,T,F] -> [B,T,2H]), differentiable in
    every parameter and in x."""
    return _FusedBiLSTMTrain.apply(
        x, *(params[name] for name in _TRAIN_PARAM_NAMES))
