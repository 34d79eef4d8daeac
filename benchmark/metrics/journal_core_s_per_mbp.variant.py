"""Resume-journal core-seconds per Mbp called: the `journal` span
(StreamStats) over the untraced jobs."""
LAYER = "resume journal (runtime/resume.py)"
UNIT = "s/Mbp"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]


def read(obs):
    jobs = obs.get("jobs") or []
    if not jobs:
        return None
    return sum(j["stats"].get("journal", 0.0) for j in jobs) / (
        obs["mbp"] * len(jobs))
