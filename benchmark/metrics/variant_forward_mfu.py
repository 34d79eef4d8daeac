"""The classifier's share of the card's dense bf16 peak while it runs: the
operations of every row the runner computed (its fixed batches, padding
included; two K1 launches a batch) over the runner's summed batch spans
(StreamStats `(device)`), against 989 TFLOP/s, in %."""
from benchmark import roofline

LAYER = "model (models/variant_model.py)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]


def read(obs):
    jobs = obs.get("jobs") or []
    busy = sum(j["stats"].get("(device)", 0.0) for j in jobs)
    if not jobs or busy <= 0:
        return None
    c = obs["conf"]
    per_window = roofline.forward_flops_per_window(roofline.classifier_shapes(
        c["image_features"], c["image_window"], c["hidden_size"],
        c["linear_width"], c["linear_layers"], c["num_classes"]),
        c["image_window"])
    rows = sum(j["k1"] for j in jobs) / 2 * obs["batch_rows"]
    return 100.0 * per_window * rows / busy / roofline.PEAK_BF16
