"""Stage-3 core-seconds per Mbp called: the gates, the collector's put and
the VCF emission spans (StreamStats) over the untraced jobs."""
LAYER = "stage 3 (pipelines/find_candidates.py)"
UNIT = "s/Mbp"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]
SPANS = ("gates", "collector_put", "vcf_emit")


def read(obs):
    jobs = obs.get("jobs") or []
    if not jobs:
        return None
    return sum(j["stats"].get(k, 0.0) for j in jobs for k in SPANS) / (
        obs["mbp"] * len(jobs))
