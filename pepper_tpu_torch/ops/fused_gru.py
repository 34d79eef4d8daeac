"""Fused bidirectional GRU layer with a carried hidden state (inference).

The polish consensus scan runs 19 overlapping windows per 1000-long
sequence, each a 2-layer biGRU over 100 steps with the hidden carried
across windows; the recurrence is the serial part of the polish device
path. The input projection x @ W_ih^T + b_ih for all timesteps is one
batched `torch.matmul` per direction outside the recurrence, as in the JAX
package (pepper_tpu/ops/fused_gru.py:81-84). Unlike the LSTM
(ops/fused_lstm.py), b_hh is NOT folded into it: torch's GRU keeps b_hn
inside the reset product, n = tanh(x_n + r*(h@W_hn^T + b_hn)), so the
recurrence adds b_hh to h@W_hh^T itself, in f32.

The recurrence is kernel K2, `csrc/fused_gru.cu`, for CUDA tensors: one of
two hand-written kernels that `select_kernel` picks from shape and dtype,
`mma` (bf16, hidden a multiple of 16 up to 128: the step product on tensor
cores with W_hh held in registers, the gates through `tanh.approx`) or
`generic` (f32 and other hidden sizes up to 128: f32 FMAs). Each reads W_hh
in its own order; `pack_bigru` builds that and the f32 b_hh once per layer
and `packed_layer` caches it (`ops/pack_cache.py`, one cache with the
biLSTM's packs). For CPU tensors the recurrence is `bigru_recurrence_plain`
(same rounding points: xp, h0 and h in the input dtype, hp and the gates in
f32). A CUDA tensor always launches a kernel or raises; it never takes the
plain loop, and no failed build or launch selects another kernel.
"""
import ctypes
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from pepper_tpu_torch.ops.fused_lstm import aligned, records_grad
from pepper_tpu_torch.ops.pack_cache import cached_pack

# kernel launches made by this process (reset by callers that count a run),
# and the same launches by the kernel that ran
launches = 0
KERNEL_CODES = {"generic": 0, "mma": 1}
kernel_launches = {name: 0 for name in KERNEL_CODES}
MAX_HIDDEN = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_PARAM_NAMES = ("weight_hh_l0", "weight_hh_l0_reverse", "bias_hh_l0",
                "bias_hh_l0_reverse")


def load_kernel_library(defines=()):
    """K2's library (a variant of it, built with the macros `defines`), with
    its C interface declared."""
    from pepper_tpu_torch.ops.cuda_build import load_library
    lib = load_library("fused_gru", defines)
    lib.pepper_bigru_forward.restype = ctypes.c_int
    lib.pepper_bigru_forward.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    return lib


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_kernel_library()
    return _lib


def bigru_recurrence_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                           whh_t_f: torch.Tensor, whh_t_b: torch.Tensor,
                           bhh_f: torch.Tensor, bhh_b: torch.Tensor,
                           h0_f: torch.Tensor, h0_b: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2. xp_*: [B,T,3H] (gates r,z,n; b_ih
    added, b_hh not); whh_t_*: [H,3H] (W_hh^T); bhh_*: [3H]; h0_*: [B,H].
    Returns (out [B,T,2H], h_final [B,2,H]), both in xp's dtype."""
    B, T, G = xp_f.shape
    H = G // 3
    dtype = xp_f.dtype
    out = torch.empty((B, T, 2 * H), dtype=dtype, device=xp_f.device)
    h_n = torch.empty((B, 2, H), dtype=dtype, device=xp_f.device)
    dirs = ((xp_f, whh_t_f, bhh_f, h0_f), (xp_b, whh_t_b, bhh_b, h0_b))
    for d, (xp, w, bhh, h0) in enumerate(dirs):
        w32, b32 = w.float(), bhh.float()
        h = h0.to(dtype)
        steps = range(T - 1, -1, -1) if d else range(T)
        for t in steps:
            h_prev = h.float()
            hp = h_prev @ w32 + b32
            x = xp[:, t].float()
            r = torch.sigmoid(x[:, :H] + hp[:, :H])
            z = torch.sigmoid(x[:, H:2 * H] + hp[:, H:2 * H])
            n = torch.tanh(x[:, 2 * H:] + r * hp[:, 2 * H:])
            h = ((1.0 - z) * n + z * h_prev).to(dtype)
            out[:, t, d * H:(d + 1) * H] = h
        h_n[:, d] = h
    return out, h_n


def kernel_takes(name: str, H: int, dtype: torch.dtype) -> bool:
    """Whether kernel `name` can run a layer of hidden size H in `dtype`
    (any B and T)."""
    if dtype not in _DTYPE_CODES or not 1 <= H <= MAX_HIDDEN:
        return False
    return name == "generic" or (name == "mma" and dtype == torch.bfloat16
                                 and H % 16 == 0)


def select_kernel(B: int, T: int, H: int, dtype: torch.dtype) -> str:
    """The kernel that runs the recurrence of a [B,T,3H] layer on the card:
    a pure function of shape and dtype. Raises for what no kernel takes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused biGRU kernels take float32 or bfloat16, "
                        f"got {dtype}")
    if B < 1 or T < 1 or not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"fused biGRU kernels: B={B}, T={T} must be "
                         f"positive and the hidden size {H} at most "
                         f"{MAX_HIDDEN}")
    return "mma" if kernel_takes("mma", H, dtype) else "generic"


def _permute_gates(whh_t: torch.Tensor) -> torch.Tensor:
    """[H,3H] -> [H,3H] with column 3j+q = gate q (r, z, n) of hidden unit
    j, so generic kernel thread j finds its unit's three weights side by
    side."""
    H = whh_t.shape[0]
    return whh_t.reshape(H, 3, H).transpose(1, 2).reshape(H, 3 * H)


def mma_row_order(H: int) -> torch.Tensor:
    """Row n of the mma kernel's W_hh holds original row mma_row_order(H)[n]
    = q*H + u: warp w's 48 rows are six n8-blocks, (r, z, n) of its units
    16w..16w+7, then of 16w+8..16w+15, so the accumulator fragment of a
    thread holds r, z and n of the same (row, unit) pairs."""
    n = torch.arange(3 * H)
    block = (n % 48) // 8                 # n8-block of the warp: 3v + q
    return (block % 3) * H + 16 * (n // 48) + 8 * (block // 3) + n % 8


@dataclass
class PackedBiGRU:
    """One layer's recurrent parameters as kernel `name` reads them."""
    name: str
    w_hh: Tuple[torch.Tensor, torch.Tensor]   # generic: [H,3H] W_hh^T with
                                              # _permute_gates' columns; mma:
                                              # [3H,H] W_hh rows in
                                              # mma_row_order, bf16
    bhh: torch.Tensor                         # [2,3H] f32, gates r, z, n

    @property
    def hidden(self) -> int:
        return self.bhh.shape[-1] // 3


def pack_weights(name: str, whh_f: torch.Tensor, whh_b: torch.Tensor,
                 bhh_f: torch.Tensor, bhh_b: torch.Tensor) -> PackedBiGRU:
    """Pack W_hh [3H,H] and b_hh [3H] of both directions for kernel
    `name`."""
    if name not in KERNEL_CODES:
        raise ValueError(f"unknown fused biGRU kernel {name!r}")
    H = whh_f.shape[1]
    if name == "mma":
        if H % 16:
            raise ValueError(f"fused biGRU kernel 'mma' does not take "
                             f"hidden size {H}")
        order = mma_row_order(H).to(whh_f.device)
        w_hh = tuple(w[order].contiguous() for w in (whh_f, whh_b))
    else:
        w_hh = tuple(_permute_gates(w.t()).contiguous() for w in (whh_f, whh_b))
    bhh = torch.stack([bhh_f, bhh_b]).float().contiguous()
    return PackedBiGRU(name, w_hh, bhh)


def pack_bigru(params: Dict[str, torch.Tensor], name: str) -> PackedBiGRU:
    """Pack a layer's recurrent parameters for kernel `name`."""
    return pack_weights(name, *(params[n] for n in _PARAM_NAMES))


pack_builds = 0          # packs built by `packed_layer` (its cache misses)


def packed_layer(params: Dict[str, torch.Tensor], name: str) -> PackedBiGRU:
    """`pack_bigru`, cached per layer (`ops/pack_cache.py`): reused only for
    the same four tensor objects, none updated in place since nor given
    other storage; a layer that holds an inference tensor is packed on
    every call."""
    global pack_builds
    pack, built = cached_pack("bigru:" + name,
                              (params[n] for n in _PARAM_NAMES),
                              lambda: pack_bigru(params, name))
    pack_builds += built
    return pack


def bigru_recurrence_packed(pack: PackedBiGRU, xp_f: torch.Tensor,
                            xp_b: torch.Tensor, h0: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 (the pack's kernel) on the tensors' CUDA device (current
    stream). xp_*: [B,T,3H] (gates r,z,n; b_ih added, b_hh not); h0:
    [B,2,H]. Returns (out [B,T,2H], h_final [B,2,H]) in xp's dtype."""
    global launches
    what = "fused biGRU kernel"
    if xp_f.dim() != 3 or xp_b.shape != xp_f.shape or xp_f.shape[2] % 3:
        raise ValueError(f"{what}: bad shapes xp {tuple(xp_f.shape)}"
                         f"/{tuple(xp_b.shape)}")
    B, T, G = xp_f.shape
    H = G // 3
    dtype, dev = xp_f.dtype, xp_f.device
    tensors = (xp_f, xp_b, h0, pack.w_hh[0], pack.w_hh[1], pack.bhh)
    if any(not t.is_cuda or t.device != dev for t in tensors) \
            or any(t.dtype != dtype for t in (xp_b,) + pack.w_hh):
        raise ValueError(f"{what}: all inputs must be CUDA tensors of one "
                         f"device, xp and W_hh of one dtype")
    select_kernel(B, T, H, dtype)                 # raises for a bad shape
    if pack.hidden != H or h0.shape != (B, 2, H):
        raise ValueError(f"{what}: xp {tuple(xp_f.shape)} and h0 "
                         f"{tuple(h0.shape)} do not fit the packed layer "
                         f"of hidden size {pack.hidden}")
    if not kernel_takes(pack.name, H, dtype):
        raise ValueError(f"{what}: kernel {pack.name!r} does not take "
                         f"H={H}, {dtype}")
    lib = _kernel_lib()
    xp_f, xp_b = aligned(xp_f), aligned(xp_b)
    h0 = aligned(h0.to(dtype))
    out = torch.empty((B, T, 2 * H), dtype=dtype, device=dev)
    h_n = torch.empty((B, 2, H), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pepper_bigru_forward(
            KERNEL_CODES[pack.name], xp_f.data_ptr(), xp_b.data_ptr(),
            pack.w_hh[0].data_ptr(), pack.w_hh[1].data_ptr(),
            pack.bhh.data_ptr(), h0.data_ptr(), out.data_ptr(),
            h_n.data_ptr(), B, T, H, _DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused biGRU kernel {pack.name!r} launch failed: "
                           f"error {err}")
    launches += 1
    kernel_launches[pack.name] += 1
    return out, h_n


def input_projections(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """(xp_f, xp_b): x @ W_ih^T + b_ih per direction, [B,T,3H] (b_hh is
    added inside the recurrence)."""
    xp_f = torch.matmul(x, params["weight_ih_l0"].t()) + params["bias_ih_l0"]
    xp_b = (torch.matmul(x, params["weight_ih_l0_reverse"].t())
            + params["bias_ih_l0_reverse"])
    return xp_f, xp_b


def fused_bigru(params: Dict[str, torch.Tensor], x: torch.Tensor,
                h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional GRU, drop-in for rnn.gru.

    x: [B,T,F]; h0: [B,2,H] (direction-major). Returns (out [B,T,2H] in
    x's dtype, h_final [B,2,H] in h0's dtype). K2 has no backward: on a
    CUDA tensor under grad (`records_grad`) this raises; rnn.gru
    (`polish_forward(..., fused_rnn=False)`) is the differentiable layer."""
    if x.is_cuda and records_grad(params, x, h0):
        raise RuntimeError(
            "fused_bigru: kernel K2 has no backward and its output would "
            "carry no gradient; use rnn.gru (polish_forward(..., "
            "fused_rnn=False)) for a differentiable biGRU, or run under "
            "torch.inference_mode()")
    xp_f, xp_b = input_projections(params, x)
    if x.is_cuda:
        B, T, _ = x.shape
        H = params["weight_hh_l0"].shape[1]
        pack = packed_layer(params, select_kernel(B, T, H, x.dtype))
        out, h_n = bigru_recurrence_packed(pack, xp_f, xp_b, h0)
    else:
        out, h_n = bigru_recurrence_plain(
            xp_f, xp_b, params["weight_hh_l0"].t(),
            params["weight_hh_l0_reverse"].t(), params["bias_hh_l0"],
            params["bias_hh_l0_reverse"], h0[:, 0], h0[:, 1])
    return out, h_n.to(h0.dtype)
