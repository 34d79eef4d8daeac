"""Fused bidirectional LSTM layer (zero initial state): inference and
training.

The recurrent loop of the variant classifier's biLSTM is the serial part of
the device forward: per step a [B,H] @ [H,4H] product plus the gate
nonlinearities. The input projection x @ W_ih^T for all timesteps is one
batched `torch.matmul` per direction outside the recurrence, as in the JAX
package (pepper_tpu/ops/fused_lstm.py:75-80). The two biases are added
inside the recurrence, each sum rounded to the working dtype, which is the
function `(x @ W_ih^T + b_ih) + b_hh` computes: no elementwise pass over
[B,T,4H] runs between the projection and the recurrence.

For CUDA tensors the recurrence is kernel K1 (`csrc/fused_lstm.cu`), one of
three hand-written kernels that `select_kernel` picks from shape and dtype:
`cluster_mma` (bf16, hidden 64/128/256: W_hh resident in a cluster's shared
memory, the step product on tensor cores, the gate activations through
`tanh.approx`), `cluster_fma` (f32 and K3, the
same hidden sizes, batches up to 640 rows: W_hh^T resident in a cluster's
shared memory, f32 FMAs) and `generic` (any hidden size up to 256 and any
batch: W_hh^T streamed from L2 every step).
Each wants W_hh, the columns of xp (so the rows of W_ih) and the biases in
its own order; `pack_bilstm` builds that set once per layer and
`packed_layer` caches it, for those eight tensor objects alone, until one
is updated in place.
For CPU tensors the recurrence is `bilstm_recurrence_plain` (same rounding
points: xp, the bias sums and h in the input dtype, c and the gate sums in
f32). A CUDA tensor always launches a kernel or raises; it never takes the
plain loop, and no failed build or launch selects another kernel.

Training (`fused_bilstm_train`, a `torch.autograd.Function`) follows
pepper_tpu/ops/fused_lstm.py:232-373. Its forward is kernel K3 (the same
recurrence, which also stores the activated gates and the cell state of
every step in f32; `cluster_fma` or `generic`), its backward kernel K4
(reverse-time BPTT with a (dh, dc) carry, emitting dgates as dxp, plus
dW_hh), both in `csrc/fused_lstm_train.cu`; `select_backward_kernel` picks
K4's `cluster_fma` pair (W_hh resident in a cluster's shared memory, read
from the pack the forward used, which the autograd context carries) or its
`generic` pair. The gradients of W_ih, of the four biases and of x are
batched `torch.matmul`s and sums outside the kernel. For CPU tensors the
forward is `bilstm_train_forward_plain` and the backward
`bilstm_train_backward_plain`, an explicit reverse-time loop with K4's
formulas (not autograd through the forward loop), so the CPU tests run the
wiring the card runs.
"""
import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from pepper_tpu_torch.ops.pack_cache import cached_pack

# kernel launches made by this process (reset by callers that count a run):
# K1, K3 (train forward) and K4 (train backward: its kernels count once),
# the forward launches by the kernel that ran, and K4's likewise
launches = 0
train_fwd_launches = 0
train_bwd_launches = 0
KERNEL_CODES = {"generic": 0, "cluster_fma": 1, "cluster_mma": 2}
kernel_launches = {name: 0 for name in KERNEL_CODES}
BACKWARD_CODES = {"generic": 0, "cluster_fma": 1}
bwd_kernel_launches = {name: 0 for name in BACKWARD_CODES}
# forward graphs replayed (runtime/streaming.py::DeviceRunner): a replay
# makes the K1 launches its capture recorded, and `launches` and
# `kernel_launches` count them as the launcher counts its own
graph_replays = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CLUSTER_HIDDEN = (64, 128, 256)
# The FMA cluster kernel runs 16 rows per cluster, 8 clusters per direction
# at a time, ~0.25 ms a tile at T=33; the generic kernel takes ~1.45 ms for
# any batch up to 1056 rows (K3) or 2112 (K1). On the H100 they meet between
# 512 and 1024 rows (1.0 against 1.5 ms, then 2.0 against 1.5 ms).
_CLUSTER_FMA_MAX_BATCH = 640
MAX_HIDDEN = 256
_lib = None
_train_lib = None

# (b_ih, b_hh) of the forward direction, then of the reverse direction
Biases = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _train_kernel_lib():
    global _train_lib
    if _train_lib is None:
        from pepper_tpu_torch.ops.cuda_build import load_library
        lib = load_library("fused_lstm_train")
        lib.pepper_bilstm_train_forward.restype = ctypes.c_int
        lib.pepper_bilstm_train_forward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.pepper_bilstm_train_backward.restype = ctypes.c_int
        lib.pepper_bilstm_train_backward.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.pepper_bilstm_train_backward_scratch.restype = ctypes.c_longlong
        lib.pepper_bilstm_train_backward_scratch.argtypes = [ctypes.c_int] * 4
        _train_lib = lib
    return _train_lib


def load_forward_library(defines=()):
    """K1's library (a variant of it, built with the macros `defines`),
    with its C interface declared."""
    from pepper_tpu_torch.ops.cuda_build import load_library
    lib = load_library("fused_lstm", defines)
    lib.pepper_bilstm_forward.restype = ctypes.c_int
    lib.pepper_bilstm_forward.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
    return lib


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = load_forward_library()
    return _lib


def kernel_takes(name: str, H: int, dtype: torch.dtype,
                 residuals: bool = False) -> bool:
    """Whether kernel `name` can run a layer of hidden size H in `dtype`
    (any B and T), storing the step's residuals or not."""
    if name == "generic":
        return 1 <= H <= MAX_HIDDEN and not (residuals and H % 4)
    if name == "cluster_fma":
        # in bf16 without residuals the tensor-core kernel takes every shape
        # this one would, so that variant is not built
        return H in _CLUSTER_HIDDEN and (residuals or dtype == torch.float32)
    return (name == "cluster_mma" and H in _CLUSTER_HIDDEN
            and dtype == torch.bfloat16 and not residuals)


def select_kernel(B: int, T: int, H: int, dtype: torch.dtype,
                  residuals: bool = False) -> str:
    """The kernel that runs the recurrence of a [B,T,4H] layer on the card:
    a pure function of shape, dtype and whether the step's residuals are
    stored (K3). Raises for what no kernel takes."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused biLSTM kernels take float32 or bfloat16, "
                        f"got {dtype}")
    if B < 1 or T < 1 or H < 1 or H > MAX_HIDDEN or (residuals and H % 4):
        raise ValueError(
            f"fused biLSTM kernels: B={B}, T={T} must be positive and the "
            f"hidden size {H} at most {MAX_HIDDEN}"
            + (" and a multiple of 4" if residuals else ""))
    if kernel_takes("cluster_mma", H, dtype, residuals):
        return "cluster_mma"
    if kernel_takes("cluster_fma", H, dtype, residuals) \
            and B <= _CLUSTER_FMA_MAX_BATCH:
        return "cluster_fma"
    return "generic"


def select_backward_kernel(B: int, T: int, H: int,
                           dtype: torch.dtype) -> str:
    """The pair of kernels that runs K4 for a [B,T,4H] layer on the card: a
    pure function of shape and dtype. Raises for what no kernel takes.

    The cluster pair takes every batch of the hidden sizes it runs: on the
    H100 at T=33, H=256 it measured faster than the generic pair at every
    batch `chip_smoke.py` times, 64 to 4096 rows (its recurrence costs
    about as much per row as the generic one's once the generic one fills
    the card, and its dW_hh half as much)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"fused biLSTM training kernels take float32 or "
                        f"bfloat16, got {dtype}")
    if B < 1 or T < 1 or H < 1 or H > MAX_HIDDEN or H % 4:
        raise ValueError(
            f"fused biLSTM training kernels: B={B}, T={T} must be positive "
            f"and the hidden size {H} a multiple of 4, at most {MAX_HIDDEN}")
    return "cluster_fma" if H in _CLUSTER_HIDDEN else "generic"


def _add_biases(xp_f, xp_b, biases: Optional[Biases]):
    """(xp + b_ih) + b_hh per direction, each sum rounded to xp's dtype."""
    if biases is None:
        return xp_f, xp_b
    return xp_f + biases[0] + biases[1], xp_b + biases[2] + biases[3]


def bilstm_recurrence_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                            whh_t_f: torch.Tensor, whh_t_b: torch.Tensor,
                            biases: Optional[Biases] = None) -> torch.Tensor:
    """Plain PyTorch version of K1. xp_*: [B,T,4H] raw input projections
    (gates i,f,g,o); whh_t_*: [H,4H] (W_hh^T); biases: (b_ih, b_hh) of each
    direction, added here (None: xp has them already). Returns [B,T,2H] in
    xp's dtype."""
    xp_f, xp_b = _add_biases(xp_f, xp_b, biases)
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


# ----------------------------------------------------------------- packing
def gate_permutations(name: str, H: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(xp_order, w_order) of kernel `name`: position p of the kernel's xp
    columns (so of W_ih's rows and of the biases) holds original gate column
    xp_order[p] = q*H + u (gate q of i,f,g,o, hidden unit u); row n of the
    kernel's W_hh holds original row w_order[n].

    `generic` and `cluster_fma`: both 4u + q, so a thread reads its unit's
    four gates as one vector and a block's 32 units are contiguous.
    `cluster_mma`: W_hh rows 32*(u//8) + 8q + u%8, so the four 8-column
    n-blocks of a warp's mma are the four gates of its 8 units and a
    thread's accumulator fragment holds all four gates of its (row, unit)
    pairs; xp columns 8*(u//2) + 2q + u%2, the 16 bytes one thread needs per
    row. Either way block r of a cluster owns a contiguous slice."""
    if name not in KERNEL_CODES:
        raise ValueError(f"unknown fused biLSTM kernel {name!r}")
    p = torch.arange(4 * H)
    if name != "cluster_mma":
        order = (p % 4) * H + p // 4
        return order, order
    xp_order = ((p % 8) // 2) * H + 2 * (p // 8) + p % 2
    w_order = ((p % 32) // 8) * H + 8 * (p // 32) + p % 8
    return xp_order, w_order


@dataclass
class PackedBiLSTM:
    """One layer's parameters as kernel `name` reads them."""
    name: str
    w_ih: Tuple[torch.Tensor, torch.Tensor]   # [4H,F] per direction, rows in
                                              # xp_order (None if not given)
    w_hh: Tuple[torch.Tensor, torch.Tensor]   # generic, cluster_fma: [H,4H]
                                              # W_hh^T; cluster_mma: [4H,H]
    bias: torch.Tensor                        # [2,2,4H]: direction, (ih, hh)
    xp_order: torch.Tensor                    # [4H] on the layer's device

    @property
    def hidden(self) -> int:
        return self.bias.shape[-1] // 4


def pack_weights(name: str, whh_f: torch.Tensor, whh_b: torch.Tensor,
                 biases: Optional[Biases], w_ih=None) -> PackedBiLSTM:
    """Pack W_hh [4H,H] of both directions, the four biases (None: zeros)
    and, where given, W_ih [4H,F] of both directions for kernel `name`."""
    G, H = whh_f.shape
    dev, dtype = whh_f.device, whh_f.dtype
    xp_order, w_order = (o.to(dev) for o in gate_permutations(name, H))
    if name == "cluster_mma":
        w_hh = tuple(w[w_order].contiguous() for w in (whh_f, whh_b))
    else:
        w_hh = tuple(w[w_order].t().contiguous() for w in (whh_f, whh_b))
    if biases is None:
        bias = torch.zeros((2, 2, G), dtype=dtype, device=dev)
    else:
        bias = torch.stack([b.to(dtype)[xp_order] for b in biases]).reshape(
            2, 2, G)
    if w_ih is not None:
        w_ih = tuple(w[xp_order].contiguous() for w in w_ih)
    return PackedBiLSTM(name, w_ih, w_hh, bias, xp_order)


def layer_biases(params: Dict[str, torch.Tensor]) -> Biases:
    return (params["bias_ih_l0"], params["bias_hh_l0"],
            params["bias_ih_l0_reverse"], params["bias_hh_l0_reverse"])


def pack_bilstm(params: Dict[str, torch.Tensor], name: str) -> PackedBiLSTM:
    """Pack a layer's eight parameter tensors for kernel `name`."""
    return pack_weights(
        name, params["weight_hh_l0"], params["weight_hh_l0_reverse"],
        layer_biases(params),
        (params["weight_ih_l0"], params["weight_ih_l0_reverse"]))


_PARAM_NAMES = tuple(
    name + sfx for sfx in ("", "_reverse")
    for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"))
pack_builds = 0          # packs built by `packed_layer` (its cache misses)


def packed_layer(params: Dict[str, torch.Tensor], name: str) -> PackedBiLSTM:
    """`pack_bilstm`, cached per layer (`ops/pack_cache.py`): reused only
    for the same eight tensor objects, none updated in place since nor
    given other storage; a layer that holds an inference tensor is packed
    on every call."""
    global pack_builds
    pack, built = cached_pack(
        "bilstm:" + name, (params[n] for n in _PARAM_NAMES),
        lambda: pack_bilstm(params, name))
    pack_builds += built
    return pack


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels' vector loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def records_grad(params: Dict[str, torch.Tensor], *tensors) -> bool:
    """Whether autograd would record a graph through a call on these
    tensors: grad mode is on and one of them or of the layer's parameters
    requires grad. The inference kernels (K1, K2) write their output
    through ctypes, which autograd cannot see, so their wrappers raise
    when this holds instead of returning a result with no gradient."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (*tensors, *params.values()))


def _check_packed_inputs(what: str, pack: PackedBiLSTM, xp_f, xp_b,
                         residuals: bool) -> Tuple[int, int, int]:
    """The checks K1 and K3 share: type, device and shapes of xp [B,T,4H]
    against the pack, and that the pack's kernel takes them."""
    if xp_f.dim() != 3 or xp_b.shape != xp_f.shape or xp_f.shape[2] % 4:
        raise ValueError(f"{what}: bad shapes xp {tuple(xp_f.shape)}"
                         f"/{tuple(xp_b.shape)}")
    B, T, G = xp_f.shape
    H = G // 4
    dtype = xp_f.dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {dtype}")
    tensors = (xp_f, xp_b, pack.w_hh[0], pack.w_hh[1], pack.bias)
    if any(not t.is_cuda or t.device != xp_f.device or t.dtype != dtype
           for t in tensors):
        raise ValueError(f"{what}: all inputs must be CUDA tensors of one "
                         f"device and dtype")
    if pack.hidden != H or pack.w_hh[0].numel() != H * G:
        raise ValueError(f"{what}: xp {tuple(xp_f.shape)} does not fit the "
                         f"packed layer of hidden size {pack.hidden}")
    select_kernel(B, T, H, dtype, residuals)      # raises for a bad shape
    if not kernel_takes(pack.name, H, dtype, residuals):
        raise ValueError(f"{what}: kernel {pack.name!r} does not take "
                         f"B={B}, T={T}, H={H}, {dtype}")
    return B, T, H


def bilstm_recurrence_packed(pack: PackedBiLSTM, xp_f: torch.Tensor,
                             xp_b: torch.Tensor) -> torch.Tensor:
    """Launch K1 (the pack's kernel) on the tensors' CUDA device (current
    stream). xp_*: [B,T,4H] raw projections in the pack's column order."""
    global launches
    B, T, H = _check_packed_inputs("fused biLSTM kernel", pack, xp_f, xp_b,
                                   residuals=False)
    lib = _kernel_lib()
    xp_f, xp_b = aligned(xp_f), aligned(xp_b)
    out = torch.empty((B, T, 2 * H), dtype=xp_f.dtype, device=xp_f.device)
    with torch.cuda.device(xp_f.device):
        stream = torch.cuda.current_stream(xp_f.device).cuda_stream
        err = lib.pepper_bilstm_forward(
            KERNEL_CODES[pack.name], xp_f.data_ptr(), xp_b.data_ptr(),
            pack.w_hh[0].data_ptr(), pack.w_hh[1].data_ptr(),
            pack.bias.data_ptr(), out.data_ptr(), B, T, H,
            _DTYPE_CODES[xp_f.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused biLSTM kernel {pack.name!r} launch "
                           f"failed: error {err}")
    launches += 1
    kernel_launches[pack.name] += 1
    return out


def launch_counts() -> Tuple[int, Dict[str, int]]:
    """K1's counters as they stand: (launches, launches by kernel)."""
    return launches, dict(kernel_launches)


def captured_launches(before: Tuple[int, Dict[str, int]]) -> Dict[str, int]:
    """The K1 launches made since `before` (a `launch_counts()`) by kernel,
    taken back out of the counters: a graph's capture records launches
    and runs none. `count_replay` counts them each time the graph runs."""
    global launches
    made = {name: kernel_launches[name] - before[1][name]
            for name in kernel_launches}
    launches = before[0]
    kernel_launches.update(before[1])
    return made


def count_replay(made: Dict[str, int]) -> None:
    """Count one replay of a graph that captured the K1 launches `made`."""
    global launches, graph_replays
    for name, k in made.items():
        kernel_launches[name] += k
        launches += k
    graph_replays += 1


def raw_projections(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """(xp_f, xp_b): x @ W_ih^T per direction, [B,T,4H], no bias."""
    return (torch.matmul(x, params["weight_ih_l0"].t()),
            torch.matmul(x, params["weight_ih_l0_reverse"].t()))


def packed_projections(pack: PackedBiLSTM, x: torch.Tensor):
    """`raw_projections` in the pack's column order."""
    return (torch.matmul(x, pack.w_ih[0].t()),
            torch.matmul(x, pack.w_ih[1].t()))


def fused_bilstm(params: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM with zero initial state, drop-in for rnn.lstm.

    x: [B, T, F] -> [B, T, 2H] (forward || backward), in x's dtype. K1 has
    no backward: on a CUDA tensor under grad (`records_grad`) this raises;
    `fused_bilstm_train` is the differentiable layer."""
    if x.is_cuda:
        if records_grad(params, x):
            raise RuntimeError(
                "fused_bilstm: kernel K1 has no backward and its output "
                "would carry no gradient; use fused_bilstm_train for a "
                "differentiable biLSTM, or run under torch.inference_mode()")
        B, T, _ = x.shape
        H = params["weight_hh_l0"].shape[1]
        pack = packed_layer(params, select_kernel(B, T, H, x.dtype))
        return bilstm_recurrence_packed(pack, *packed_projections(pack, x))
    xp_f, xp_b = raw_projections(params, x)
    return bilstm_recurrence_plain(
        xp_f, xp_b, params["weight_hh_l0"].t(),
        params["weight_hh_l0_reverse"].t(), layer_biases(params))


# ---------------------------------------------------------------- training
def bilstm_train_forward_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                               whh_t_f: torch.Tensor, whh_t_b: torch.Tensor,
                               biases: Optional[Biases] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch version of K3: K1's recurrence (same arguments), which
    also keeps every step's residuals at the original time index. Returns
    (out [B,T,2H] in xp's dtype, gates [2,B,T,4H] f32: activated i,f,g,o per
    direction, cs [2,B,T,H] f32: the updated cell state)."""
    xp_f, xp_b = _add_biases(xp_f, xp_b, biases)
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


def bilstm_train_forward_packed(pack: PackedBiLSTM, xp_f: torch.Tensor,
                                xp_b: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Launch K3 (the pack's kernel) on the tensors' CUDA device (current
    stream). xp_*: [B,T,4H] raw projections in the pack's column order; the
    residuals come back in the original gate order."""
    global train_fwd_launches
    what = "fused biLSTM training kernel"
    B, T, H = _check_packed_inputs(what, pack, xp_f, xp_b, residuals=True)
    dtype, dev = xp_f.dtype, xp_f.device
    lib = _train_kernel_lib()
    xp_f, xp_b = aligned(xp_f), aligned(xp_b)
    out = torch.empty((B, T, 2 * H), dtype=dtype, device=dev)
    gates = torch.empty((2, B, T, 4 * H), dtype=torch.float32, device=dev)
    cs = torch.empty((2, B, T, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pepper_bilstm_train_forward(
            KERNEL_CODES[pack.name], xp_f.data_ptr(), xp_b.data_ptr(),
            pack.w_hh[0].data_ptr(), pack.w_hh[1].data_ptr(),
            pack.bias.data_ptr(), out.data_ptr(), gates.data_ptr(),
            cs.data_ptr(), B, T, H, _DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused biLSTM training forward {pack.name!r} "
                           f"launch failed: error {err}")
    train_fwd_launches += 1
    kernel_launches[pack.name] += 1
    return out, gates, cs


def _torch_layout_whh(pack: PackedBiLSTM) -> Tuple[torch.Tensor, ...]:
    """W_hh [4H,H] of both directions in f32, torch's row order, from a
    pack in the 4u+q column order (what the generic K4 reads)."""
    H = pack.hidden
    g = torch.arange(4 * H, device=pack.bias.device)
    rows = (g % H) * 4 + g // H           # original row q*H+u is pack 4u+q
    return tuple(w.t()[rows].float().contiguous() for w in pack.w_hh)


def bilstm_train_backward_kernel(pack: PackedBiLSTM, gout: torch.Tensor,
                                 gates: torch.Tensor, cs: torch.Tensor,
                                 out: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 (the reverse-time recurrence, then dW_hh), the pair
    `select_backward_kernel` picks, on the tensors' CUDA device (current
    stream). `pack` is the forward's (`generic` or `cluster_fma`: one
    layout). Returns (dxp [2,B,T,4H] f32, dW_hh [2,4H,H] f32)."""
    B, T, H2 = gout.shape
    return launch_backward(select_backward_kernel(B, T, H2 // 2, out.dtype),
                           pack, gout, gates, cs, out)


def launch_backward(name: str, pack: PackedBiLSTM, gout: torch.Tensor,
                    gates: torch.Tensor, cs: torch.Tensor, out: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 by its pair `name`: `cluster_fma` reads the pack's W_hh^T as it
    is, `generic` reads W_hh in torch's row order, gathered from it."""
    global train_bwd_launches
    B, T, H2 = gout.shape
    H = H2 // 2
    dtype, dev = out.dtype, out.device
    tensors = (gout, gates, cs, out, pack.w_hh[0], pack.w_hh[1])
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError("fused biLSTM training kernel: all inputs must be "
                         "CUDA tensors of one device")
    select_backward_kernel(B, T, H, dtype)           # raises for a bad shape
    if H2 != 2 * H or out.shape != gout.shape \
            or gates.shape != (2, B, T, 4 * H) or cs.shape != (2, B, T, H) \
            or gates.dtype != torch.float32 or cs.dtype != torch.float32:
        raise ValueError(f"fused biLSTM training kernel: bad residuals gout "
                         f"{tuple(gout.shape)}, out {tuple(out.shape)}, gates "
                         f"{tuple(gates.shape)} {gates.dtype}, cs "
                         f"{tuple(cs.shape)} {cs.dtype}")
    if pack.name not in BACKWARD_CODES or pack.hidden != H \
            or pack.w_hh[0].dtype != dtype:
        raise ValueError(f"fused biLSTM training kernel: a {pack.name!r} "
                         f"pack of hidden size {pack.hidden} does not fit "
                         f"H={H}, {dtype}")
    if name not in BACKWARD_CODES \
            or (name == "cluster_fma" and H not in _CLUSTER_HIDDEN):
        raise ValueError(f"fused biLSTM training kernel: {name!r} does not "
                         f"take H={H}")
    lib = _train_kernel_lib()
    gout, out = aligned(gout.to(dtype)), aligned(out)
    gates, cs = aligned(gates), aligned(cs)
    w = pack.w_hh if name == "cluster_fma" else _torch_layout_whh(pack)
    code = BACKWARD_CODES[name]
    dxp = torch.empty((2, B, T, 4 * H), dtype=torch.float32, device=dev)
    dwhh = torch.empty((2, 4 * H, H), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (lib.pepper_bilstm_train_backward_scratch(code, B, T, H),),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pepper_bilstm_train_backward(
            code, gout.data_ptr(), gates.data_ptr(), cs.data_ptr(),
            out.data_ptr(), w[0].data_ptr(), w[1].data_ptr(), dxp.data_ptr(),
            dwhh.data_ptr(), scratch.data_ptr(), B, T, H,
            _DTYPE_CODES[dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused biLSTM training backward {name!r} launch "
                           f"failed: error {err}")
    train_bwd_launches += 1
    bwd_kernel_launches[name] += 1
    return dxp, dwhh


class _FusedBiLSTMTrain(torch.autograd.Function):
    """x and the eight parameters (in _PARAM_NAMES order) -> out."""

    @staticmethod
    def forward(ctx, x, *weights):
        params = dict(zip(_PARAM_NAMES, weights))
        if x.is_cuda:
            B, T, _ = x.shape
            H = params["weight_hh_l0"].shape[1]
            pack = packed_layer(params, select_kernel(B, T, H, x.dtype,
                                                      residuals=True))
            out, gates, cs = bilstm_train_forward_packed(
                pack, *packed_projections(pack, x))
            ctx.pack = pack              # K4 reads the forward's pack
        else:
            out, gates, cs = bilstm_train_forward_plain(
                *raw_projections(params, x), params["weight_hh_l0"].t(),
                params["weight_hh_l0_reverse"].t(), layer_biases(params))
        ctx.save_for_backward(x, out, gates, cs, *weights)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, gout):
        x, out, gates, cs, *weights = ctx.saved_tensors
        params = dict(zip(_PARAM_NAMES, weights))
        if out.is_cuda:
            dxp, dwhh = bilstm_train_backward_kernel(ctx.pack, gout, gates,
                                                     cs, out)
        else:
            dxp, dwhh = bilstm_train_backward_plain(
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
                             for n in _PARAM_NAMES)


def fused_bilstm_train(params: Dict[str, torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """`fused_bilstm` with a hand-written backward: same contract as
    rnn.lstm (zero initial state, [B,T,F] -> [B,T,2H]), differentiable in
    every parameter and in x."""
    return _FusedBiLSTMTrain.apply(
        x, *(params[name] for name in _PARAM_NAMES))
