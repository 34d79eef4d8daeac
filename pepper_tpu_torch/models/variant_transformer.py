"""Alternate variant classifier: residual CNN + encoder-only transformer
(PyTorch).

Architecture parity with the reference alternate model
(pepper_variant/modules/python/models/simple_model_transformers.py:5-97)
and the JAX package's models/variant_transformer.py:
  reshape [B,1,T,F] -> residual conv block (1->4ch 3x3, BatchNorm, ReLU,
  broadcast residual add) -> reshape [B,T,4F] -> TransformerEncoder(d=4F,
  8 heads, 6 layers, torch defaults: dff 2048, ReLU, post-LayerNorm) ->
  flatten -> MLP 128/64/32/16/8 (ReLU; dropout is off at inference) ->
  num_classes softmax.

Parameter names/shapes mirror the torch module so checkpoints import 1:1
through models/checkpoint.py. BatchNorm runs in inference mode (running
stats). The attention is written out as the JAX package writes it (input
projection, split, softmax(QK^T/sqrt(head width))V, output projection):
no kernel serves this model in either package.
"""
import math
from typing import Dict

import torch
import torch.nn.functional as F

from pepper_tpu_torch.models.rnn import _uniform, init_linear_params, linear
from pepper_tpu_torch.options import ImageOptions

Params = Dict
_MLP = ("linear_1", "linear_2", "linear_3", "linear_4", "linear_5")


def _attn_init(gen: torch.Generator, d: int) -> Params:
    return {
        "in_proj_weight": _uniform(gen, (3 * d, d), math.sqrt(1.0 / d)),
        "in_proj_bias": torch.zeros((3 * d,)),
        "out_proj": init_linear_params(gen, d, d),
    }


def _norm_init(d: int) -> Params:
    return {"weight": torch.ones((d,)), "bias": torch.zeros((d,))}


def _encoder_layer_init(gen: torch.Generator, d: int, dff: int = 2048
                        ) -> Params:
    return {
        "self_attn": _attn_init(gen, d),
        "linear1": init_linear_params(gen, d, dff),
        "linear2": init_linear_params(gen, dff, d),
        "norm1": _norm_init(d),
        "norm2": _norm_init(d),
    }


def _bn_init(c: int) -> Params:
    return {"weight": torch.ones((c,)), "bias": torch.zeros((c,)),
            "running_mean": torch.zeros((c,)), "running_var": torch.ones((c,))}


def init_transformer_params(gen: torch.Generator,
                            image_features: int = ImageOptions.IMAGE_HEIGHT,
                            window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1,
                            num_classes: int = ImageOptions.TOTAL_TYPE_LABELS,
                            out_channel: int = 4, n_layers: int = 6) -> Params:
    d = out_channel * image_features
    return {
        "conv1": {"weight": _uniform(gen, (out_channel, 1, 3, 3),
                                     math.sqrt(1.0 / 9))},
        "bn1": _bn_init(out_channel),
        "conv2": {"weight": _uniform(gen, (out_channel, out_channel, 3, 3),
                                     math.sqrt(1.0 / (9 * out_channel)))},
        "bn2": _bn_init(out_channel),
        "encoder": {"layers": {str(i): _encoder_layer_init(gen, d)
                               for i in range(n_layers)}},
        "linear_1": init_linear_params(gen, d * window, 128),
        "linear_2": init_linear_params(gen, 128, 64),
        "linear_3": init_linear_params(gen, 64, 32),
        "linear_4": init_linear_params(gen, 32, 16),
        "linear_5": init_linear_params(gen, 16, 8),
        "output_layer": init_linear_params(gen, 8, num_classes),
    }


def _batchnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm2d over channel axis 1."""
    shape = (1, -1, 1, 1)
    return ((x - p["running_mean"].reshape(shape))
            / torch.sqrt(p["running_var"].reshape(shape) + eps)
            * p["weight"].reshape(shape) + p["bias"].reshape(shape))


def _layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * p["weight"] + p["bias"]


def _mha(p: Params, x: torch.Tensor, n_heads: int = 8) -> torch.Tensor:
    """torch MultiheadAttention (batch_first, self-attention, no mask)."""
    B, T, d = x.shape
    qkv = torch.matmul(x, p["in_proj_weight"].t()) + p["in_proj_bias"]
    q, k, v = qkv.chunk(3, dim=-1)
    hd = d // n_heads

    def heads(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = torch.matmul(q, k.transpose(2, 3)) / math.sqrt(hd)
    attn = torch.softmax(scores, dim=-1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, T, d)
    return linear(p["out_proj"], out)


def _encoder_layer(p: Params, x: torch.Tensor) -> torch.Tensor:
    """torch TransformerEncoderLayer, post-norm (norm_first=False), ReLU."""
    x = _layernorm(p["norm1"], x + _mha(p["self_attn"], x))
    ff = linear(p["linear2"], torch.relu(linear(p["linear1"], x)))
    return _layernorm(p["norm2"], x + ff)


def transformer_forward(params: Params, x: torch.Tensor,
                        train_mode: bool = False) -> torch.Tensor:
    """x: [B, T, F] -> class probabilities (log-probs when train_mode,
    matching the reference's LogSoftmax train output)."""
    B, T, _ = x.shape
    h = x[:, None]                              # [B,1,T,F]
    out = torch.relu(_batchnorm(params["bn1"], F.conv2d(
        h, params["conv1"]["weight"], padding=1)))
    out = _batchnorm(params["bn2"], F.conv2d(
        out, params["conv2"]["weight"], padding=1))
    out = torch.relu(out + h)                   # broadcast residual add
    # reference quirk: a raw reshape [B,C,T,F] -> [B,T,C*F] (memory
    # reinterpretation, NOT a channel-last permute) —
    # simple_model_transformers.py:57
    out = out.reshape(B, T, -1)
    layers = params["encoder"]["layers"]
    for i in range(len(layers)):
        out = _encoder_layer(layers[str(i)], out)
    out = out.reshape(B, -1)
    for name in _MLP:
        out = torch.relu(linear(params[name], out))
    logits = linear(params["output_layer"], out)
    if train_mode:
        return torch.log_softmax(logits, dim=-1)
    return torch.softmax(logits, dim=-1)
