"""The card's idle share over the untraced jobs: 1 - the runner's summed
batch spans (StreamStats `(device)`, CUDA events from before each batch's
copy up to its last result) over the jobs' wall time, in %."""
LAYER = "device runner (runtime/streaming.py::DeviceRunner)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]


def read(obs):
    jobs = obs.get("jobs") or []
    busy = sum(j["stats"].get("(device)", 0.0) for j in jobs)
    if not jobs or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / sum(j["wall"] for j in jobs))
