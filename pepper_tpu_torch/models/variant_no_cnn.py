"""Alternate variant classifier: the "no-CNN" stateful biLSTM MLP (PyTorch).

Architecture parity with the reference alternate
(pepper_variant/modules/python/models/simple_model_no_cnn.py:5-103) and the
JAX package's models/variant_no_cnn.py:
  encoder biLSTM(F->128) consumes x with the caller's (hidden, cell) as
  initial state; its FINAL state seeds the decoder biLSTM(F->128), which
  reads x AGAIN (not the encoder outputs — a reference quirk); flatten
  decoder outputs -> MLP 256/128/64/32/16 (ReLU) -> num_classes softmax
  (log-softmax in train mode). Hidden/cell use the [B, dirs, H] layout.
Parameter names mirror the torch module for 1:1 checkpoint import. No
kernel serves it: both layers need a carried initial state and the final
cell, which K1 lacks, so they are the step loop (`rnn.lstm_with_state`) on
every device, as in the JAX package.
"""
from typing import Dict

import torch

from pepper_tpu_torch.models.rnn import (init_linear_params, init_rnn_params,
                                         linear, lstm_with_state)
from pepper_tpu_torch.options import ImageOptions

Params = Dict
_MLP = ("linear_1", "linear_2", "linear_3", "linear_4", "linear_5")


def init_no_cnn_params(gen: torch.Generator,
                       image_features: int = ImageOptions.IMAGE_HEIGHT,
                       window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1,
                       num_classes: int = ImageOptions.TOTAL_TYPE_LABELS,
                       hidden: int = 128) -> Params:
    return {
        "encoder": init_rnn_params(gen, image_features, hidden, gates=4),
        "decoder": init_rnn_params(gen, image_features, hidden, gates=4),
        "linear_1": init_linear_params(gen, 2 * hidden * window, 256),
        "linear_2": init_linear_params(gen, 256, 128),
        "linear_3": init_linear_params(gen, 128, 64),
        "linear_4": init_linear_params(gen, 64, 32),
        "linear_5": init_linear_params(gen, 32, 16),
        "output_layer": init_linear_params(gen, 16, num_classes),
    }


def init_state(batch_size: int, hidden: int = 128, dtype=torch.float32,
               device="cpu"):
    return (torch.zeros((batch_size, 2, hidden), dtype=dtype, device=device),
            torch.zeros((batch_size, 2, hidden), dtype=dtype, device=device))


def no_cnn_forward(params: Params, x: torch.Tensor, hidden: torch.Tensor,
                   cell_state: torch.Tensor,
                   train_mode: bool = False) -> torch.Tensor:
    """x: [B,T,F]; hidden/cell: [B,2,H] -> class probabilities."""
    _, h, c = lstm_with_state(params["encoder"], x, hidden, cell_state)
    out, _, _ = lstm_with_state(params["decoder"], x, h, c)
    out = out.reshape(out.shape[0], -1)
    for name in _MLP:
        out = torch.relu(linear(params[name], out))
    logits = linear(params["output_layer"], out)
    if train_mode:
        return torch.log_softmax(logits, dim=-1)
    return torch.softmax(logits, dim=-1)
