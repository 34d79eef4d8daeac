"""Variant-calling genotype classifier, inference forward (PyTorch).

Architecture parity with the reference's live model
(pepper_variant/modules/python/models/simple_model.py:6-82) and with
pepper_tpu/models/variant_model.py:
  biLSTM(F->256) -> biLSTM(512->256) -> flatten [B, 33*512]
  -> 5 x (Linear 512 + SELU) -> Linear(512 -> 3) type head -> softmax.

Functional: params are the nested dict of tensors whose names/shapes mirror
the torch module attributes (models/checkpoint.py). Both biLSTM layers run
through ops/fused_lstm.py: kernel K1 for CUDA tensors, its plain version
for CPU tensors. The softmax runs in the working dtype, as the JAX forward
does; callers cast the probabilities to float32 afterwards. Training mode
and dropout are not ported yet (ROADMAP M5).
"""
from typing import Dict

import torch
import torch.nn.functional as F

from pepper_tpu_torch.models.rnn import init_linear_params, init_rnn_params, linear
from pepper_tpu_torch.ops.fused_lstm import fused_bilstm
from pepper_tpu_torch.options import ImageOptions

Params = Dict


def init_variant_params(gen: torch.Generator,
                        image_features: int = ImageOptions.IMAGE_HEIGHT,
                        num_classes_type: int = ImageOptions.TOTAL_TYPE_LABELS,
                        window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1,
                        hidden: int = 256) -> Params:
    flat = 2 * hidden * window
    return {
        "encoder": init_rnn_params(gen, image_features, hidden, gates=4),
        "decoder": init_rnn_params(gen, 2 * hidden, hidden, gates=4),
        "linear_1": init_linear_params(gen, flat, 512),
        "linear_2": init_linear_params(gen, 512, 512),
        "linear_3": init_linear_params(gen, 512, 512),
        "linear_4": init_linear_params(gen, 512, 512),
        "linear_5": init_linear_params(gen, 512, 512),
        "output_layer_type": init_linear_params(gen, 512, num_classes_type),
    }


def variant_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [B, 33, F] in the params' dtype. Returns softmax probs [B, 3]."""
    h = fused_bilstm(params["encoder"], x)
    h = fused_bilstm(params["decoder"], h)
    h = h.reshape(h.shape[0], -1)
    for name in ("linear_1", "linear_2", "linear_3", "linear_4", "linear_5"):
        h = F.selu(linear(params[name], h))
    logits = linear(params["output_layer_type"], h)
    return torch.softmax(logits, dim=-1)
