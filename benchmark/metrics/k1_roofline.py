"""Kernel K1's share of its roofline in the traced job: the least time of
one launch at the runner's batch (`roofline.k1_bound_ms`, bf16) over the
mean device time per K1 launch in the profiler's trace, in %."""
from benchmark import harness, roofline

LAYER = "kernel K1 (ops/fused_lstm.py, csrc/fused_lstm.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]
KERNELS = ("bilstm_mma_kernel", "bilstm_cluster_fma_kernel", "bilstm_kernel")


def read(obs):
    trace = obs.get("trace")
    if not trace:
        return None
    secs, n = harness.kernel_time(trace["kernels"], KERNELS)
    if not n:
        return None
    c = obs["conf"]
    bound_ms, _ = roofline.k1_bound_ms(obs["batch_rows"], c["image_window"],
                                       2, roofline.PEAK_BF16,
                                       c["hidden_size"])
    return 100.0 * bound_ms / (1e3 * secs / n)
