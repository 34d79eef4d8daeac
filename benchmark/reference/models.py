"""Plain PyTorch reference of the classifier, its initialisation and its
training step, written from PEPPER r0.8's `simple_model.py` and
`train_distributed.py`. No kernel, no cache, no batching tricks: step
loops over positions in float32 with TF32 off, or with every product's
inputs rounded to a lower precision (`Precision`) for the controls.

The classifier (pepper_variant/modules/python/models/simple_model.py:6-82):
biLSTM(F->H) -> biLSTM(2H->H) -> dropout .2 -> flatten -> 5 x (Linear +
SELU, dropout .2 after the first four) -> Linear(-> 3); softmax when
serving.

Parameters are nested dicts {layer: {name: tensor}} with torch.nn's names
(weight_ih_l0, weight_hh_l0, bias_ih_l0, bias_hh_l0, *_reverse; gates
i,f,g,o).
"""
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


class Precision:
    """How the products of a forward pass are computed: float32 (None), or
    with both inputs of every product rounded to `dtype` with one scale per
    tensor (amax mapped to the format's largest value) and the sum taken in
    float32, as a per-tensor-scaled fp8 path computes it."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        self.dtype = dtype

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return t
        top = torch.finfo(self.dtype).max
        scale = t.abs().amax().clamp_min(1e-30) / top
        return (t / scale).to(self.dtype).float() * scale

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a @ w^T."""
        return torch.matmul(self.round(a), self.round(w).t())


F32 = Precision()


def _linear(p, x, prec: Precision):
    return prec.mm(x, p["weight"]) + p["bias"]


def _lstm_dir(xp, w_hh, b_hh, reverse: bool, prec: Precision):
    B, T, _ = xp.shape
    H = w_hh.shape[1]
    h = xp.new_zeros((B, H))
    c = xp.new_zeros((B, H))
    out = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xp[:, t] + prec.mm(h, w_hh) + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h
    return torch.stack(out, dim=1)


def bilstm(p, x, prec: Precision = F32):
    """[B,T,F] -> [B,T,2H], zero initial state."""
    outs = []
    for sfx, rev in (("", False), ("_reverse", True)):
        xp = prec.mm(x, p["weight_ih_l0" + sfx]) + p["bias_ih_l0" + sfx]
        outs.append(_lstm_dir(xp, p["weight_hh_l0" + sfx],
                              p["bias_hh_l0" + sfx], rev, prec))
    return torch.cat(outs, dim=-1)


def _dropout(x, gen, rate: float = 0.2):
    """Inverted dropout; the mask is torch.rand(x.shape, generator=gen) <
    1 - rate, drawn in the forward's order on x's device."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def classifier_forward(params: Dict, x: torch.Tensor, train: bool = False,
                       dropout_gen=None, prec: Precision = F32):
    """x [B,T,F] float -> softmax probabilities [B,3], or the logits when
    `train` (dropout drawn from `dropout_gen` when one is given)."""
    h = bilstm(params["encoder"], x, prec)
    h = bilstm(params["decoder"], h, prec)
    drop = train and dropout_gen is not None
    if drop:
        h = _dropout(h, dropout_gen)
    h = h.reshape(h.shape[0], -1)
    for k in range(1, 5):
        h = F.selu(_linear(params[f"linear_{k}"], h, prec))
        if drop:
            h = _dropout(h, dropout_gen)
    h = F.selu(_linear(params["linear_5"], h, prec))
    logits = _linear(params["output_layer_type"], h, prec)
    return logits if train else torch.softmax(logits, dim=-1)


# ---- initialisation: torch's default U(-1/sqrt(fan), 1/sqrt(fan)), drawn
# from a CPU torch.Generator in the order the layers are declared

def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) \
        * bound


def _rnn(gen, f, hidden, gates):
    bound = 1.0 / math.sqrt(hidden)
    g = gates * hidden
    names = ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"]
    shapes = [(g, f), (g, hidden), (g,), (g,)]
    names += [n + "_reverse" for n in names]
    shapes += shapes
    return {n: _uniform(gen, s, bound) for n, s in zip(names, shapes)}


def _lin(gen, i, o):
    bound = 1.0 / math.sqrt(i)
    return {"weight": _uniform(gen, (o, i), bound),
            "bias": _uniform(gen, (o,), bound)}


def init_classifier(seed: int, features: int, window: int, hidden: int,
                    width: int, n_linear: int, classes: int) -> Dict:
    gen = torch.Generator().manual_seed(seed)
    tree = {"encoder": _rnn(gen, features, hidden, 4),
            "decoder": _rnn(gen, 2 * hidden, hidden, 4),
            "linear_1": _lin(gen, 2 * hidden * window, width)}
    for k in range(2, n_linear + 1):
        tree[f"linear_{k}"] = _lin(gen, width, width)
    tree["output_layer_type"] = _lin(gen, width, classes)
    return tree


# ---- training: Adam(lr, betas (0.9, 0.999), eps 1e-8) with L2 weight
# decay added to the gradient before the moments (torch.optim.Adam's
# weight_decay), parameters updated in place

def leaves(tree: Dict, prefix: str = ""):
    """(path, leaf) in sorted-key order, depth first."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from leaves(tree[key], path)
        else:
            yield path, tree[key]


class Adam:
    def __init__(self, tree: Dict, lr: float, weight_decay: float):
        self.tree = tree
        self.lr, self.wd = lr, weight_decay
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.t = 0
        self.m = {k: torch.zeros_like(p) for k, p in leaves(tree)}
        self.v = {k: torch.zeros_like(p) for k, p in leaves(tree)}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients as the moments took them."""
        self.t += 1
        taken = {}
        for k, p in leaves(self.tree):
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[k] / (1 - self.b1 ** self.t)
            v_hat = self.v[k] / (1 - self.b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))
        return taken


def cross_entropy_sum(logits, labels):
    return -torch.log_softmax(logits, -1).gather(
        -1, labels[:, None].long()).sum()


def grads_of(tree: Dict, loss: torch.Tensor) -> Dict[str, torch.Tensor]:
    names = [k for k, _ in leaves(tree)]
    params = [p for _, p in leaves(tree)]
    return dict(zip(names, torch.autograd.grad(loss, params)))


def requires_grad(tree: Dict) -> Dict:
    return {k: requires_grad(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_() for k, v in tree.items()}
