# Frozen copies of chip_smoke.py::k1_bound_ms and of
# pepper_tpu_torch/utils/bench.py::forward_flops_per_window and its peaks at
# commit d27cce3, kept with the benchmark so that a later
# change to the program cannot move the yardstick.
"""Peaks of one NVIDIA H100 SXM and the least time each kernel could take.

A bound counts each input byte read once and each output byte written once
and the operations the recurrence needs (2 per multiply-add); the bound is
the larger of bytes over the HBM rate and operations over the peak. A
kernel's roofline share is bound / measured device time per launch.
"""
import numpy as np

# NVIDIA's data sheet, SXM part, dense rates, at the full 700 W limit
PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12

H = 256                    # classifier biLSTM hidden size


def _bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_bound_ms(B: int, T: int, elem: int, peak_ops: float, hidden: int = H):
    """K1, the biLSTM inference forward: (bound ms, bound_by). xp (both
    directions) read once, out written once, W_hh^T read once;
    2*2*T*B*H*4H operations."""
    nbytes = (2 * B * T * 4 * hidden + B * T * 2 * hidden
              + 2 * hidden * 4 * hidden) * elem
    ops = 2 * 2 * T * B * hidden * 4 * hidden
    return _bound(nbytes, ops, peak_ops)


def forward_flops_per_window(shapes: dict, window: int) -> int:
    """Operations (2 per multiply-add) of a forward pass over one window of
    `window` positions, from the weight shapes of a parameter tree given
    as {layer: {name: shape}}: each recurrent weight (W_ih and W_hh of both
    directions) is applied at each position, a Linear once. Elementwise
    work is not counted."""
    flops = 0
    for layer in shapes.values():
        for name, shape in layer.items():
            if name.startswith("weight"):
                uses = window if name.startswith(("weight_ih", "weight_hh")) \
                    else 1
                flops += 2 * int(np.prod(shape)) * uses
    return flops


def classifier_shapes(features: int, window: int, hidden: int,
                      linear_width: int, n_linear: int, classes: int) -> dict:
    """{layer: {weight name: shape}} of the variant classifier."""
    def rnn(f):
        return {f"weight_{k}_l0{s}": (4 * hidden, f if k == "ih" else hidden)
                for k in ("ih", "hh") for s in ("", "_reverse")}
    shapes = {"encoder": rnn(features), "decoder": rnn(2 * hidden),
              "linear_1": {"weight": (linear_width, 2 * hidden * window)}}
    for k in range(2, n_linear + 1):
        shapes[f"linear_{k}"] = {"weight": (linear_width, linear_width)}
    shapes["output_layer_type"] = {"weight": (classes, linear_width)}
    return shapes
