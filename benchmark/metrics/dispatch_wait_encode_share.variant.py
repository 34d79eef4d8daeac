"""The share of the untraced jobs' wall time that the dispatching thread
spent waiting for the encode threads' next region (the program's state
`main.wait_encode`, `runtime/streaming.py::stream_inference`), in %."""
LAYER = "host encode as the runner sees it (runtime/streaming.py::stream_inference)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]


def read(obs):
    # a program without the dispatching thread's states reads nothing
    jobs = [j for j in obs.get("jobs") or [] if "main.job_head" in j["stats"]]
    if not jobs:
        return None
    return 100.0 * sum(j["stats"].get("main.wait_encode", 0.0)
                       for j in jobs) / sum(j["wall"] for j in jobs)
