"""Seconds a job spends before its stream hands regions to the encode
threads (the program's state `main.job_head`: validation, intervals, the
runner, the journal, opening the VCFs), the mean over the untraced jobs."""
LAYER = "pipeline driver before the stream (pipelines/call_variant.py)"
UNIT = "s/job"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]


def read(obs):
    # a program without the dispatching thread's states reads nothing
    jobs = [j for j in obs.get("jobs") or [] if "main.job_head" in j["stats"]]
    if not jobs:
        return None
    return sum(j["stats"]["main.job_head"] for j in jobs) / len(jobs)
