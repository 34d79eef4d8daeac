"""The share of the untraced jobs' wall time that the dispatching thread
spent handing batches to the full flush queue (the program's state
`main.wait_flush`: back-pressure from the flusher and stage 3), in %."""
LAYER = "flusher and stage-3 back-pressure (runtime/streaming.py, pipelines/find_candidates.py)"
UNIT = "%"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]


def read(obs):
    # a program without the dispatching thread's states reads nothing
    jobs = [j for j in obs.get("jobs") or [] if "main.job_head" in j["stats"]]
    if not jobs:
        return None
    return 100.0 * sum(j["stats"].get("main.wait_flush", 0.0)
                       for j in jobs) / sum(j["wall"] for j in jobs)
