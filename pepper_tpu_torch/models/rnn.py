"""Functional RNN layers with torch parameter layout (plain PyTorch).

Parameter names/shapes mirror torch.nn.LSTM/GRU exactly (weight_ih_l0
[G*H,F], weight_hh_l0 [G*H,H], bias_ih_l0, bias_hh_l0, and *_reverse for the
backward direction; LSTM gate order i,f,g,o, GRU r,z,n), as in the JAX
package (pepper_tpu/models/rnn.py), so reference checkpoints and the JAX
package's .npz files load unchanged. The device paths run the fused kernels
(ops/fused_lstm.py, ops/fused_gru.py); `lstm` and `gru` here are the plain
step loops they are held to.
"""
import math
from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) \
        * bound


def init_rnn_params(gen: torch.Generator, input_size: int, hidden_size: int,
                    gates: int, bidirectional: bool = True) -> Params:
    """torch default init: U(-1/sqrt(H), 1/sqrt(H)) for every tensor."""
    bound = 1.0 / math.sqrt(hidden_size)
    G = gates * hidden_size
    names = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]
    shapes = [(G, input_size), (G, hidden_size), (G,), (G,)]
    if bidirectional:
        names += [n + "_reverse" for n in names[:4]]
        shapes += shapes[:4]
    return {n: _uniform(gen, s, bound) for n, s in zip(names, shapes)}


def init_linear_params(gen: torch.Generator, in_size: int,
                       out_size: int) -> Params:
    bound = 1.0 / math.sqrt(in_size)
    return {"weight": _uniform(gen, (out_size, in_size), bound),
            "bias": _uniform(gen, (out_size,), bound)}


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["weight"].t()) + p["bias"]


def _lstm_direction(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    b_hh: torch.Tensor, reverse: bool,
                    h0: Optional[torch.Tensor] = None,
                    c0: Optional[torch.Tensor] = None):
    """x_proj: [B,T,4H] (input projection applied); h0, c0: [B,H] initial
    state, zeros when None. Returns (out [B,T,H], h_final, c_final)."""
    B, T, _ = x_proj.shape
    H = w_hh.shape[1]
    h = x_proj.new_zeros((B, H)) if h0 is None else h0
    c = x_proj.new_zeros((B, H)) if c0 is None else c0
    out = x_proj.new_empty((B, T, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[:, t] + torch.matmul(h, w_hh.t()) + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out, h, c


def _projection(p: Params, x: torch.Tensor, suffix: str) -> torch.Tensor:
    return linear({"weight": p["weight_ih_l0" + suffix],
                   "bias": p["bias_ih_l0" + suffix]}, x)


def lstm(p: Params, x: torch.Tensor, bidirectional: bool = True
         ) -> torch.Tensor:
    """Bidirectional LSTM, zero initial state (torch default when h0 absent).

    x: [B,T,F] -> [B,T,2H] (fwd||bwd concat, matching torch output layout).
    """
    out_f = _lstm_direction(_projection(p, x, ""), p["weight_hh_l0"],
                            p["bias_hh_l0"], False)[0]
    if not bidirectional:
        return out_f
    out_b = _lstm_direction(_projection(p, x, "_reverse"),
                            p["weight_hh_l0_reverse"],
                            p["bias_hh_l0_reverse"], True)[0]
    return torch.cat([out_f, out_b], dim=-1)


def lstm_with_state(p: Params, x: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor):
    """Bidirectional LSTM with an explicit initial state, as the JAX
    package's (pepper_tpu/models/rnn.py:102-116).

    x: [B,T,F]; h0, c0: [B,2,H] (direction-major). Returns (out [B,T,2H],
    h_final [B,2,H], c_final [B,2,H]). Kernel K1 takes a zero initial state
    and returns no final state, so this is the step loop on every device,
    as the JAX package's scan is."""
    out_f, hf, cf = _lstm_direction(_projection(p, x, ""), p["weight_hh_l0"],
                                    p["bias_hh_l0"], False, h0[:, 0],
                                    c0[:, 0])
    out_b, hb, cb = _lstm_direction(_projection(p, x, "_reverse"),
                                    p["weight_hh_l0_reverse"],
                                    p["bias_hh_l0_reverse"], True, h0[:, 1],
                                    c0[:, 1])
    return (torch.cat([out_f, out_b], dim=-1), torch.stack([hf, hb], dim=1),
            torch.stack([cf, cb], dim=1))


def _gru_direction(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor, h0: torch.Tensor, reverse: bool):
    """x_proj: [B,T,3H] (input projection applied); h0: [B,H]. torch GRU
    semantics: b_hn sits INSIDE the reset product,
    n = tanh(x_n + r*(h@W_hn^T + b_hn)). Returns (h_final, out [B,T,H])."""
    B, T, _ = x_proj.shape
    h = h0
    out = x_proj.new_empty((B, T, h0.shape[-1]))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        hp = torch.matmul(h, w_hh.t()) + b_hh
        x_r, x_z, x_n = x_proj[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = hp.chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        n = torch.tanh(x_n + r * h_n)
        h = (1.0 - z) * n + z * h
        out[:, t] = h
    return h, out


def gru(p: Params, x: torch.Tensor, h0: torch.Tensor):
    """Bidirectional GRU with explicit initial hidden.

    x: [B,T,F]; h0: [B,2,H] (direction-major, the JAX package's layout;
    torch.nn.GRU's is [2,B,H]). Returns (out [B,T,2H], h_final [B,2,H])."""
    hf, out_f = _gru_direction(_projection(p, x, ""), p["weight_hh_l0"],
                               p["bias_hh_l0"], h0[:, 0], False)
    hb, out_b = _gru_direction(_projection(p, x, "_reverse"),
                               p["weight_hh_l0_reverse"],
                               p["bias_hh_l0_reverse"], h0[:, 1], True)
    return torch.cat([out_f, out_b], dim=-1), torch.stack([hf, hb], dim=1)
