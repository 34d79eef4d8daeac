"""Assembly-polishing per-position base caller (PyTorch).

Architecture parity with the reference's live polish model
(pepper/modules/python/models/simple_model.py:5-48) and the JAX package's
models/polish_model.py:
  biGRU(10->128, h0 in) -> biGRU(256->128, h0 carried from the encoder)
  -> Linear(256 -> 5) per position; the hidden is returned for the window
  carry (polish/consensus.py).

`polish_forward(..., fused_rnn=)` picks the biGRU layer as the JAX
package's does: True goes through ops/fused_gru.py (kernel K2 on CUDA
tensors, its plain version on the CPU; inference only), False through
models/rnn.py::gru, the differentiable step loop the trainer takes.
"""
from typing import Dict, Tuple

import numpy as np
import torch

from pepper_tpu_torch.models.rnn import (gru, init_linear_params,
                                         init_rnn_params, linear)
from pepper_tpu_torch.ops.fused_gru import fused_bigru
from pepper_tpu_torch.options import PolishImageOptions, PolishTrainOptions

Params = Dict


def init_polish_params(gen: torch.Generator,
                       image_features: int = PolishImageOptions.IMAGE_HEIGHT,
                       hidden: int = PolishTrainOptions.HIDDEN_SIZE,
                       num_classes: int = PolishImageOptions.TOTAL_LABELS
                       ) -> Params:
    return {
        "gru_encoder": init_rnn_params(gen, image_features, hidden, gates=3),
        "gru_decoder": init_rnn_params(gen, 2 * hidden, hidden, gates=3),
        "dense1": init_linear_params(gen, 2 * hidden, num_classes),
    }


def numpy_polish_params(seed: int,
                        hidden: int = PolishTrainOptions.HIDDEN_SIZE,
                        features: int = PolishImageOptions.IMAGE_HEIGHT
                        ) -> Params:
    """The polish model's torch-default init (U(+-1/sqrt(fan))) drawn from
    a numpy seed: biGRU features->hidden, biGRU 2*hidden->hidden, Linear
    2*hidden->5, as float32 numpy arrays with the checkpoint's torch-layout
    names, the same on every machine and in both packages' loaders."""
    rng = np.random.default_rng(seed)

    def u(shape, fan):
        b = 1.0 / np.sqrt(fan)
        return rng.uniform(-b, b, shape).astype(np.float32)

    def rnn(f):
        out = {}
        for sfx in ("", "_reverse"):
            out["weight_ih_l0" + sfx] = u((3 * hidden, f), hidden)
            out["weight_hh_l0" + sfx] = u((3 * hidden, hidden), hidden)
            out["bias_ih_l0" + sfx] = u((3 * hidden,), hidden)
            out["bias_hh_l0" + sfx] = u((3 * hidden,), hidden)
        return out

    return {"gru_encoder": rnn(features), "gru_decoder": rnn(2 * hidden),
            "dense1": {"weight": u((5, 2 * hidden), 2 * hidden),
                       "bias": u((5,), 2 * hidden)}}


def hidden_size(params: Params) -> int:
    """The biGRU width H of a parameter tree (its encoder's W_hh columns):
    the trainer, its eval and the consensus take it from the checkpoint."""
    return params["gru_encoder"]["weight_hh_l0"].shape[1]


def init_hidden(batch_size: int, hidden: int = PolishTrainOptions.HIDDEN_SIZE,
                dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[B, 2, H] — the reference's batch-major hidden layout."""
    return torch.zeros((batch_size, 2, hidden), dtype=dtype, device=device)


def polish_forward(params: Params, x: torch.Tensor, hidden: torch.Tensor,
                   fused_rnn: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,T,F]; hidden: [B,2,H]. Returns (logits [B,T,C], hidden [B,2,H]).

    The encoder consumes the incoming hidden; its final hidden seeds the
    decoder, and the decoder's final hidden is returned — the reference's
    forward (simple_model.py:27-42).

    fused_rnn=True runs both biGRU layers through `fused_bigru` (kernel K2
    on a CUDA tensor; it raises there under grad), False through `rnn.gru`,
    which autograd differentiates. The default is False, as in the JAX
    package (pepper_tpu/models/polish_model.py:45); the serving and eval
    paths (polish/consensus.py, train/polish_train.py::polish_accuracy)
    pass True."""
    layer = fused_bigru if fused_rnn else gru
    enc_out, enc_hidden = layer(params["gru_encoder"], x, hidden)
    dec_out, dec_hidden = layer(params["gru_decoder"], enc_out, enc_hidden)
    return linear(params["dense1"], dec_out), dec_hidden
