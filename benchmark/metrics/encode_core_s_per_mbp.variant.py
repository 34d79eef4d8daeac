"""Host encode core-seconds per Mbp called: the stream's `encode` span
(StreamStats, thread CPU time) over the untraced jobs of the window."""
LAYER = "host encode (pipelines/make_images.py, native/encoder.py)"
UNIT = "s/Mbp"
SOURCE = "program_span"
MOVES = "variant_mbp_s"
WORKLOADS = ["call_variant.r941.35x"]


def read(obs):
    jobs = obs.get("jobs") or []
    if not jobs:
        return None
    return sum(j["stats"].get("encode", 0.0) for j in jobs) / (
        obs["mbp"] * len(jobs))
