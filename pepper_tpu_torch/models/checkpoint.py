"""Model checkpoints: native .npz save/load, torch import, device placement.

The on-disk format is the JAX package's: a flat .npz (key = '/'.join(path))
plus a JSON meta blob, so either package loads the other's weights. The
loaders return the nested parameter tree as numpy arrays, with the torch
module names (rnn.py); `params_from_jax` places such a tree on a torch
device in one dtype. Reference .pkl checkpoints import through
`load_torch_checkpoint`, including the DataParallel 'module.' prefix strip
(ModelHander.py:35-39).

The optimizer state travels in the same file as ordered leaves
('__opt__/<i>'), in the order the JAX package writes them (the leaves of
its optimizer state: step count, learning rate, Adam count, first moments,
second moments, each moment tree in sorted-key order), so a checkpoint of
either package resumes in the other. This module only stores and returns
the list; train/variant_train.py maps it onto torch.optim.Adam.
"""
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Meta = Dict[str, Any]


def _flatten(tree: Dict, prefix=()) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        elif isinstance(v, torch.Tensor):
            out["/".join(prefix + (k,))] = v.detach().cpu().float().numpy()
        else:
            out["/".join(prefix + (k,))] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, params: Dict, meta: Meta = None,
                    opt_state: Optional[Sequence[np.ndarray]] = None) -> None:
    """Params (numpy arrays or tensors), and optionally the optimizer
    state's ordered leaves, to one flat .npz. The optimizer state plays the
    reference's 'model_optimizer' role (ModelHander.py:5-16): saved per
    checkpoint so --retrain_model_path resumes the Adam moments."""
    flat = _flatten(params)
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    for i, leaf in enumerate(opt_state or ()):
        flat[f"__opt__/{i}"] = np.asarray(leaf)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def load_checkpoint(path: str) -> Tuple[Dict, Meta]:
    """(numpy parameter tree, meta); optimizer state, if any, is skipped."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files
                if k != "__meta__" and not k.startswith("__opt__/")}
        meta = (json.loads(bytes(z["__meta__"]).decode())
                if "__meta__" in z.files else {})
    return _unflatten(flat), meta


def load_opt_state(path: str) -> Optional[List[np.ndarray]]:
    """The optimizer state's leaves, in saved order; None when the
    checkpoint carries no optimizer state."""
    with np.load(path) as z:
        keys = sorted((k for k in z.files if k.startswith("__opt__/")),
                      key=lambda k: int(k.split("/")[1]))
        return [z[k] for k in keys] or None


def from_torch_state_dict(state_dict: Dict[str, Any]) -> Dict:
    """torch state_dict -> nested parameter tree (numpy float32).

    Accepts tensors or arrays; strips the DataParallel 'module.' prefix."""
    flat = {}
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        arr = np.asarray(value.detach().cpu().numpy()
                         if hasattr(value, "detach") else value,
                         dtype=np.float32)
        flat[key.replace(".", "/")] = arr
    return _unflatten(flat)


def load_torch_checkpoint(path: str) -> Tuple[Dict, Meta]:
    """Import a reference torch .pkl checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("model_state_dict", ckpt)
    meta = {k: v for k, v in ckpt.items()
            if k in ("hidden_size", "gru_layers", "epochs", "num_classes")}
    return from_torch_state_dict(state), meta


def params_from_jax(tree: Dict, device="cpu",
                    dtype: torch.dtype = torch.float32) -> Dict:
    """The JAX package's parameter tree (numpy arrays, torch-layout names)
    -> the same tree of torch tensors on `device` in `dtype`."""
    return {k: params_from_jax(v, device, dtype) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32)).to(device, dtype)
            for k, v in tree.items()}
