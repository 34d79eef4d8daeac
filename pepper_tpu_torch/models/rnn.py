"""Functional RNN layers with torch parameter layout (plain PyTorch).

Parameter names/shapes mirror torch.nn.LSTM exactly (weight_ih_l0 [4H,F],
weight_hh_l0 [4H,H], bias_ih_l0, bias_hh_l0, and *_reverse for the backward
direction; gate order i,f,g,o), as in the JAX package (pepper_tpu/models/
rnn.py), so reference checkpoints and the JAX package's .npz files load
unchanged. The device path of the classifier runs the fused kernel
(ops/fused_lstm.py); `lstm` here is the plain step loop it is held to.
"""
import math
from typing import Dict

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
                    b_hh: torch.Tensor, reverse: bool) -> torch.Tensor:
    """x_proj: [B,T,4H] (input projection applied). Returns [B,T,H]."""
    B, T, _ = x_proj.shape
    H = w_hh.shape[1]
    h = x_proj.new_zeros((B, H))
    c = x_proj.new_zeros((B, H))
    out = x_proj.new_empty((B, T, H))
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[:, t] + torch.matmul(h, w_hh.t()) + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out


def lstm(p: Params, x: torch.Tensor, bidirectional: bool = True
         ) -> torch.Tensor:
    """Bidirectional LSTM, zero initial state (torch default when h0 absent).

    x: [B,T,F] -> [B,T,2H] (fwd||bwd concat, matching torch output layout).
    """
    out_f = _lstm_direction(linear({"weight": p["weight_ih_l0"],
                                    "bias": p["bias_ih_l0"]}, x),
                            p["weight_hh_l0"], p["bias_hh_l0"], False)
    if not bidirectional:
        return out_f
    out_b = _lstm_direction(linear({"weight": p["weight_ih_l0_reverse"],
                                    "bias": p["bias_ih_l0_reverse"]}, x),
                            p["weight_hh_l0_reverse"],
                            p["bias_hh_l0_reverse"], True)
    return torch.cat([out_f, out_b], dim=-1)
