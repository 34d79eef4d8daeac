"""Variant-calling genotype classifier (PyTorch): inference and training
forward.

Architecture parity with the reference's live model
(pepper_variant/modules/python/models/simple_model.py:6-82) and with
pepper_tpu/models/variant_model.py:
  biLSTM(F->256) -> biLSTM(512->256) -> dropout .2 -> flatten [B, 33*512]
  -> 5 x (Linear 512 + SELU + dropout .2, last without dropout)
  -> Linear(512 -> 3) type head -> softmax (inference).

Functional: params are the nested dict of tensors whose names/shapes mirror
the torch module attributes (models/checkpoint.py). Both biLSTM layers run
through ops/fused_lstm.py: kernel K1 for CUDA tensors, its plain version
for CPU tensors. The softmax runs in the working dtype, as the JAX forward
does; callers cast the probabilities to float32 afterwards. In training
mode the layers run `fused_bilstm_train` (kernels K3 and K4 for CUDA
tensors), dropout is active when a generator is given, and the logits are
returned.
"""
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pepper_tpu_torch.models.rnn import init_linear_params, init_rnn_params, linear
from pepper_tpu_torch.ops.fused_lstm import fused_bilstm, fused_bilstm_train
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


def numpy_variant_params(seed: int,
                         image_features: int = ImageOptions.IMAGE_HEIGHT,
                         window: int = ImageOptions.CANDIDATE_WINDOW_SIZE + 1,
                         hidden: int = 256) -> Params:
    """The classifier's torch-default init (U(+-1/sqrt(fan))) drawn from a
    numpy seed: float32 numpy arrays with the checkpoint's torch-layout
    names, the same on every machine and in both packages' loaders."""
    rng = np.random.default_rng(seed)

    def u(shape, fan):
        b = 1.0 / np.sqrt(fan)
        return rng.uniform(-b, b, shape).astype(np.float32)

    def rnn(f):
        out = {}
        for sfx in ("", "_reverse"):
            out["weight_ih_l0" + sfx] = u((4 * hidden, f), hidden)
            out["weight_hh_l0" + sfx] = u((4 * hidden, hidden), hidden)
            out["bias_ih_l0" + sfx] = u((4 * hidden,), hidden)
            out["bias_hh_l0" + sfx] = u((4 * hidden,), hidden)
        return out

    def lin(i, o):
        return {"weight": u((o, i), i), "bias": u((o,), i)}

    tree = {"encoder": rnn(image_features), "decoder": rnn(2 * hidden),
            "linear_1": lin(2 * hidden * window, 512)}
    for k in range(2, 6):
        tree[f"linear_{k}"] = lin(512, 512)
    tree["output_layer_type"] = lin(512, ImageOptions.TOTAL_TYPE_LABELS)
    return tree


def _dropout(x: torch.Tensor, rate: float, gen: torch.Generator,
             block: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout: keep with probability 1-rate, rescale the kept.
    block (first row, global rows): x holds rows [first, first + len(x))
    of a global batch; the mask is drawn for the whole global batch and
    these rows are kept, so every rank of a data-parallel group draws
    what one process would."""
    keep = 1.0 - rate
    shape, lo = x.shape, 0
    if block is not None:
        lo, shape = block[0], (block[1],) + tuple(x.shape[1:])
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    mask = mask[lo:lo + x.shape[0]]
    return torch.where(mask, x / keep, torch.zeros_like(x))


def variant_forward(params: Params, x: torch.Tensor, train_mode: bool = False,
                    dropout_gen: Optional[torch.Generator] = None,
                    dropout_block: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """x: [B, T, F] in the params' dtype (33x26, or 21x48 in the HP pass).
    Returns softmax probs [B, 3], or the logits when train_mode (the
    reference's train-time contract).

    dropout_gen: a generator on x's device; dropout 0.2 is applied in
    train mode after the LSTM stack and after linear_1..4, drawing from it
    in that order. None skips dropout. dropout_block (first row, global
    rows): x is that block of a global batch and each mask is drawn for
    the global batch (a data-parallel rank's step)."""
    layer = fused_bilstm_train if train_mode else fused_bilstm
    h = layer(params["encoder"], x)
    h = layer(params["decoder"], h)
    drop = train_mode and dropout_gen is not None
    if drop:
        h = _dropout(h, 0.2, dropout_gen, dropout_block)
    h = h.reshape(h.shape[0], -1)
    for name in ("linear_1", "linear_2", "linear_3", "linear_4"):
        h = F.selu(linear(params[name], h))
        if drop:
            h = _dropout(h, 0.2, dropout_gen, dropout_block)
    h = F.selu(linear(params["linear_5"], h))
    logits = linear(params["output_layer_type"], h)
    if train_mode:
        return logits
    return torch.softmax(logits, dim=-1)
