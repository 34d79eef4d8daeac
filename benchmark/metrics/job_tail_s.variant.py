"""Seconds a job spends after its last region is encoded (the program's
states `main.wait_producers`, `main.stage3_drain`, `main.vcf_close` and
`main.job_rest`), the mean over the untraced jobs."""
LAYER = "pipeline driver after the stream (pipelines/call_variant.py, find_candidates.py::_OrderedEmitter)"
UNIT = "s/job"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]
STATES = ("main.wait_producers", "main.stage3_drain", "main.vcf_close",
          "main.job_rest")


def read(obs):
    # a program without the dispatching thread's states reads nothing
    jobs = [j for j in obs.get("jobs") or [] if "main.job_head" in j["stats"]]
    if not jobs:
        return None
    return sum(j["stats"].get(k, 0.0) for j in jobs
               for k in STATES) / len(jobs)
