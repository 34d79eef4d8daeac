"""Legacy polish Seq2Seq-attention model (CNN encoder + GRU + Luong
attention), PyTorch.

Port of the reference's alternate consensus architecture
(pepper/modules/python/models/Seq2Seq_atn.py:14-135 and resnet.py:5-94) and
of the JAX package's models/polish_seq2seq.py: `EncoderCRNN` = custom
mini-resnet over the [B,1,T,W] pileup image followed by a multi-layer
bidirectional GRU whose directions are SUMMED (not concatenated,
Seq2Seq_atn.py:82-85); `AttnDecoderRNN` = one-step GRU over a position
one-hot (input size == seq_len, Seq2Seq_atn.py:107) + Luong dot attention
over the encoder context (Seq2Seq_atn.py:28-46) + linear class head.

Reference quirks preserved deliberately (they shape the checkpoint format):
- `BasicBlock.__init__` receives a downsample module but never assigns it, so
  the residual add is always identity and the block carries only
  conv1/bn1/conv2/bn2 parameters (resnet.py:26-46).
- The decoder defines an embedding table and a dropout layer that its forward
  never touches (Seq2Seq_atn.py:103-105); the embedding parameters are kept in
  the tree so reference checkpoints round-trip byte-complete.
- BatchNorm eps differs between the stem convs (1e-3, resnet.py:15) and the
  residual block (torch default 1e-5).

All parameter names/shapes mirror the torch modules 1:1. Inference-mode
semantics (BN running stats, no dropout). The biGRU layers are the step
loop (`rnn._gru_direction`) on every device, as the JAX package's scan is;
the live polish model is models/polish_model.py.
"""
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from pepper_tpu_torch.models.rnn import (_gru_direction, init_linear_params,
                                         init_rnn_params, linear)

Params = Dict


# ------------------------------------------------------------------ helpers
def reverse_onehot(one_hot_vector: torch.Tensor) -> torch.Tensor:
    """0 -> 1, nonzero -> 0 (Seq2Seq_atn.py:7-11)."""
    return (one_hot_vector == 0).to(one_hot_vector.dtype)


def _batchnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Inference-mode BatchNorm2d over the channel axis of NCHW."""
    shape = (1, -1, 1, 1)
    inv = torch.rsqrt(p["running_var"].reshape(shape) + eps)
    return ((x - p["running_mean"].reshape(shape)) * inv
            * p["weight"].reshape(shape) + p["bias"].reshape(shape))


def _basic_conv(p: Params, x: torch.Tensor, stride) -> torch.Tensor:
    """BasicConv2d: conv (VALID) -> BN(eps=1e-3) -> relu (resnet.py:10-20)."""
    x = F.conv2d(x, p["conv"]["weight"], stride=stride)
    return torch.relu(_batchnorm(p["bn"], x, 1e-3))


def _basic_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Residual block; identity skip only (downsample quirk,
    resnet.py:35-46)."""
    out = F.conv2d(x, p["conv1"]["weight"], padding=1)
    out = torch.relu(_batchnorm(p["bn1"], out, 1e-5))
    out = F.conv2d(out, p["conv2"]["weight"], padding=1)
    out = _batchnorm(p["bn2"], out, 1e-5)
    return torch.relu(out + x)


def _resnet_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """resnet18_custom: (1,4)-stride stem -> 1x1 conv -> one block."""
    x = _basic_conv(p["Context_Conv2d_0a"], x, stride=(1, 4))
    x = _basic_conv(p["Context_Conv2d_1a"], x, stride=(1, 1))
    return _basic_block(p["layer1"]["0"], x)


# -------------------------------------------------------- multi-layer biGRU
def _gru_stack(p: Params, x: torch.Tensor, h0_torch: torch.Tensor,
               num_layers: int):
    """Multi-layer bidirectional GRU, torch layouts.

    x: [B,T,F]; h0_torch: [L*2, B, H] (layer-major, fwd before bwd).
    Returns (out [B,T,2H], h_final [L*2, B, H]).
    """
    out = x
    finals = []
    for layer in range(num_layers):
        sfx = f"_l{layer}"
        xf = torch.matmul(out, p[f"weight_ih{sfx}"].t()) + p[f"bias_ih{sfx}"]
        hf, of = _gru_direction(xf, p[f"weight_hh{sfx}"], p[f"bias_hh{sfx}"],
                                h0_torch[2 * layer], False)
        xb = (torch.matmul(out, p[f"weight_ih{sfx}_reverse"].t())
              + p[f"bias_ih{sfx}_reverse"])
        hb, ob = _gru_direction(xb, p[f"weight_hh{sfx}_reverse"],
                                p[f"bias_hh{sfx}_reverse"],
                                h0_torch[2 * layer + 1], True)
        out = torch.cat([of, ob], dim=-1)
        finals += [hf, hb]
    return out, torch.stack(finals, dim=0)


def _init_gru_stack(gen: torch.Generator, input_size: int, hidden_size: int,
                    num_layers: int) -> Params:
    p = {}
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else 2 * hidden_size
        lp = init_rnn_params(gen, in_sz, hidden_size, gates=3,
                             bidirectional=True)
        for name, v in lp.items():
            p[name.replace("_l0", f"_l{layer}")] = v
    return p


def _sum_directions(out: torch.Tensor) -> torch.Tensor:
    """[B,T,2H] -> [B,T,H]: the forward and backward outputs added."""
    B, T, H2 = out.shape
    return out.reshape(B, T, 2, H2 // 2).sum(dim=2)


# ---------------------------------------------------------------- attention
def attention_forward(p: Params, output: torch.Tensor, context: torch.Tensor):
    """Luong dot attention (Seq2Seq_atn.py:28-46).

    output: [B,O,H] decoder states; context: [B,T,H] encoder states.
    Returns (attended [B,O,H], attn [B,O,T])."""
    attn = torch.softmax(torch.matmul(output, context.transpose(1, 2)),
                         dim=-1)
    mix = torch.matmul(attn, context)
    combined = torch.cat([mix, output], dim=-1)
    return torch.tanh(linear(p["linear_out"], combined)), attn


# ------------------------------------------------------------------ encoder
def init_encoder_params(gen: torch.Generator, image_channels: int = 1,
                        gru_layers: int = 3, hidden_size: int = 128
                        ) -> Params:
    """EncoderCRNN parameters (torch names; Seq2Seq_atn.py:62-70)."""
    del image_channels  # the custom resnet is hardwired to 1 channel

    def conv_w(shape):
        fan_out = shape[0] * shape[2] * shape[3]
        return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_out)

    def bn():
        return {"weight": torch.ones((1,)), "bias": torch.zeros((1,)),
                "running_mean": torch.zeros((1,)),
                "running_var": torch.ones((1,))}

    cnn = {
        "Context_Conv2d_0a": {"conv": {"weight": conv_w((1, 1, 1, 4))},
                              "bn": bn()},
        "Context_Conv2d_1a": {"conv": {"weight": conv_w((1, 1, 1, 1))},
                              "bn": bn()},
        "layer1": {"0": {"conv1": {"weight": conv_w((1, 1, 3, 3))},
                         "bn1": bn(),
                         "conv2": {"weight": conv_w((1, 1, 3, 3))},
                         "bn2": bn()}},
    }
    return {"cnn_encoder": {"cnn": cnn},
            "gru": _init_gru_stack(gen, 5, hidden_size, gru_layers)}


def encoder_forward(p: Params, x: torch.Tensor, hidden: torch.Tensor,
                    gru_layers: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """EncoderCRNN.forward (Seq2Seq_atn.py:72-89).

    x: [B,1,T,W] image; hidden: [B, 2*L, H] (the reference's transposed
    batch-first hidden). Returns (context [B,T,H], hidden [B,2*L,H]) — the
    bidirectional outputs are summed across directions."""
    feats = _resnet_forward(p["cnn_encoder"]["cnn"], x)
    B, _, T = feats.shape[:3]
    feats = feats.permute(0, 2, 1, 3).reshape(B, T, -1)
    out, h_final = _gru_stack(p["gru"], feats, hidden.transpose(0, 1),
                              gru_layers)
    return _sum_directions(out), h_final.transpose(0, 1)


def encoder_init_hidden(batch_size: int, num_layers: int = 3,
                        num_directions: int = 2, hidden_size: int = 128,
                        device="cpu") -> torch.Tensor:
    return torch.zeros((batch_size, num_directions * num_layers,
                        hidden_size), device=device)


# ------------------------------------------------------------------ decoder
def init_decoder_params(gen: torch.Generator, hidden_size: int,
                        gru_layers: int, num_classes: int, seq_len: int
                        ) -> Params:
    """AttnDecoderRNN parameters (Seq2Seq_atn.py:96-110); the embedding table
    is unused by forward but kept for checkpoint parity."""
    return {
        "embedding": {"weight": torch.randn((num_classes, hidden_size),
                                            generator=gen)},
        "attention": {"linear_out": init_linear_params(
            gen, 2 * hidden_size, hidden_size)},
        "gru": _init_gru_stack(gen, seq_len, hidden_size, gru_layers),
        "out": init_linear_params(gen, hidden_size, num_classes),
    }


def decoder_forward(p: Params, attention_index_onehot: torch.Tensor,
                    context_vector: torch.Tensor,
                    encoder_hidden: torch.Tensor, gru_layers: int = 3):
    """AttnDecoderRNN.forward (Seq2Seq_atn.py:112-135).

    attention_index_onehot: [B, seq_len] position one-hot (the decoder GRU's
    input size is seq_len); context_vector: [B,T,H]; encoder_hidden:
    [B, 2*L, H]. Returns (class_logits [B,C], hidden [B,2*L,H], attn
    [B,1,T]).
    """
    x = attention_index_onehot[:, None, :]  # [B,1,seq_len]
    out, h_final = _gru_stack(p["gru"], x, encoder_hidden.transpose(0, 1),
                              gru_layers)
    out = _sum_directions(out)
    attended, attn = attention_forward(p["attention"], out, context_vector)
    logits = linear(p["out"], attended.reshape(-1, out.shape[-1]))
    return logits, h_final.transpose(0, 1), attn
