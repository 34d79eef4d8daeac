"""Entry: streamed variant calling, `pepper_tpu_torch.pipelines.call_variant
.call_variant`, the call the `pepper_variant call_variant` CLI makes, in a
closed loop: one whole job after another on the seed's genome, each from
the call to its closed VCFs, with the resume journal on.

Set-up: the dataset (cached), the committed weights in the program's
checkpoint format, and one whole job, which builds and loads every kernel
and library the window uses. The window runs whole jobs until `seconds`
have passed; the rate is the Mbp of all its jobs over the time from the
first job's call to the last job's return. In a traced run the second job
runs under the profiler.

Correct: a sample of intervals, drawn from the seed, is called again by
the plain reference (`reference/variant_calls.py`) in float32, and every
job's FULL VCF is compared with it there (`reference/compare.py::
variant_gaps`).
"""
import os
import shutil


from benchmark import harness
from benchmark.traffic import datasets


def _config(ctx, data, model, out_dir):
    from pepper_tpu_torch.options import PipelineConfig
    from pepper_tpu_torch.presets import set_parameters
    return set_parameters(PipelineConfig(
        bam=data["bam"], fasta=data["fasta"], output_dir=out_dir,
        model_path=model, sub_command="call_variant",
        threads=ctx.params["threads"], device=ctx.device,
        **{ctx.conf["preset"]["name"]: True}))


def run(ctx) -> harness.Outcome:
    seeds = harness.sub_seeds(ctx.seed, 4)
    data = datasets.variant_dataset(ctx.params, seeds)
    model = harness.program_checkpoint(ctx.conf)
    scratch = harness.scratch_dir(ctx.work["name"])
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)

    import torch
    from pepper_tpu_torch.ops import fused_lstm
    from pepper_tpu_torch.pipelines.call_variant import call_variant
    from pepper_tpu_torch.runtime import streaming
    from pepper_tpu_torch.utils import streamstats

    def job(i):
        out_dir = os.path.join(scratch, f"job_{i}")
        config = _config(ctx, data, model, out_dir)
        k1 = fused_lstm.launches
        t0 = harness.now()
        call_variant(config)
        t1 = harness.now()
        return {"t0": t0, "t1": t1, "wall": t1 - t0,
                "stats": dict(streamstats.CURRENT.seconds),
                "k1": fused_lstm.launches - k1,
                "vcf": os.path.join(out_dir, "PEPPER_VARIANT_FULL.vcf.gz")}

    harness.log(f"data at {harness.now() - ctx.t_start:.2f}s")
    job("warm")
    harness.sync(ctx.device)
    if ctx.device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    t_window = harness.now()
    setup_s = t_window - ctx.t_start
    jobs, trace = [], None
    attempted = failed = 0
    while len(jobs) < 1 + ctx.trace or \
            harness.now() - t_window < ctx.seconds:
        attempted += 1
        try:
            if ctx.trace and len(jobs) == 1:
                with harness.DeviceTrace(ctx.device) as trace:
                    jobs.append(job(len(jobs)))
                jobs[-1]["traced"] = True
            else:
                jobs.append(job(len(jobs)))
        except Exception as exc:   # a job that fails is counted, not hidden
            harness.log(f"job {attempted} failed: {exc!r}")
            failed += 1
            break
    harness.log("job walls (s): " + " ".join(f"{j['wall']:.3f}" for j in jobs))
    t_end = jobs[-1]["t1"] if jobs else harness.now()
    rate = len(jobs) * data["mbp"] / (t_end - t_window)

    obs = {"mbp": data["mbp"], "batch_rows": streaming.stream_batch_rows(
               512, torch.device(ctx.device)),
           "conf": ctx.conf,
           "jobs": [{k: j[k] for k in ("wall", "stats", "k1")}
                    for j in jobs if not j.get("traced")]}
    if trace:
        obs["trace"] = trace.summary()

    def free():
        streaming._runner_cache.clear()

    def check():
        from benchmark.reference import compare, variant_calls
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p = ctx.params
        sample = variant_calls.sample_intervals(
            data["fasta"], p["region_size"], p["check_intervals"], seeds[3])
        ref_tree = {layer: {n: torch.from_numpy(a).to(ctx.device)
                            for n, a in names.items()}
                    for layer, names in harness.tree(
                        harness.load_weights(ctx.conf)).items()}
        cands = variant_calls.candidates(data["bam"], data["fasta"], sample,
                                         ctx.conf["preset"]["image"])
        want = variant_calls.call_sites(cands, ref_tree,
                                        ctx.conf["preset"]["candidate"],
                                        ctx.device)
        harness.log(f"reference: {sum(len(v) for v in cands.values())} "
                    f"candidates, {sum(len(v) for v in compare.record_sites(want).values())} "
                    f"sites over {sample}")
        worst = {}
        for j in jobs:
            gaps = compare.variant_gaps(compare.vcf_sites(j["vcf"], sample),
                                        want)
            for k, v in gaps.items():
                worst[k] = max(worst.get(k, 0.0), v)
        shutil.rmtree(scratch, ignore_errors=True)
        if not jobs:
            worst = {k: float("inf") for k in ctx.limits}
        return {k: (worst[k], ctx.limits[k]) for k in ctx.limits}

    return harness.Outcome(rate, setup_s, attempted, failed, obs, check, free)
