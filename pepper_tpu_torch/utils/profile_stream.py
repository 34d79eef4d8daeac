"""Profile the host side of the port's streamed call_variant, with the
device forward stubbed.

    python -m pepper_tpu_torch.utils.profile_stream [--mbp 1] [--threads N]
        [--reps 3] [--device cuda] [--cache-dir build/bench]

The counterpart of the JAX package's root `profile_stream.py`. The hot
work of the stream lives on producer, flusher and collector threads, where
cProfile cannot see, so it times pipeline variants differentially (the
median of `--reps` runs each, after a warm run): the stream alone, with
the candidate collector (gates, no VCF), and with the collector and the
ordered VCF emitter; then it times stage 3's components standalone over
the prediction batches of the last run: the candidate gates
(batch_candidates), the aggregation and VCF write (finalize_candidates),
and the HDF5 prediction store's write alone. The device forward is
replaced by constant probabilities, so the numbers are the host's costs
with the device's removed. It prints to stdout.

Where it differs from the JAX tool:

  - the dataset, config and weights are utils/bench.py's, cached under
    `--cache-dir` (default build/bench/, shared with the bench).
  - no JAX platform setup. The stub replaces runtime/streaming.py::
    DeviceRunner.submit (which on a card returns a pending batch) with one
    that returns probabilities of 1/3 for the runner's whole batch, and
    puts the original back in a `finally`. The runner itself is still
    made on `--device` (default cuda; cuda with no card raises).
  - every run keeps the resume journal on, as production call_variant
    does, and stage 3's standalone timings read the last run's batches
    from it (utils/bench.py::journal_batches): the stream writes no
    prediction store where h5py is missing (the card's machine).
  - the HDF5 write alone is timed only where h5py is installed; otherwise
    the tool says that it was skipped.
"""
import argparse
import os
import shutil
import time
from contextlib import contextmanager

import numpy as np

from pepper_tpu_torch.utils import bench


@contextmanager
def stubbed_device():
    """DeviceRunner.submit returns constant probabilities while inside."""
    from pepper_tpu_torch.runtime import streaming as rs
    submit = rs.DeviceRunner.submit
    rs.DeviceRunner.submit = lambda self, images8: np.full(
        (self.batch, 3), 1 / 3, np.float32)
    try:
        yield
    finally:
        rs.DeviceRunner.submit = submit


def run_stream(cache, fasta, bam, threads, device, with_collector,
               with_emitter):
    """One streamed run into cache/prof_out with its resume journal on;
    returns (stream s, tail s, candidates, config, intervals, journal)."""
    from pepper_tpu_torch.pipelines.find_candidates import (
        StreamingCandidateCollector, make_ordered_emitter)
    from pepper_tpu_torch.pipelines.make_images import build_intervals
    from pepper_tpu_torch.runtime.streaming import stream_inference
    from pepper_tpu_torch.utils import streamstats

    config = bench.bench_config(fasta, bam, threads, device)
    config.model_path = bench.make_model(cache)
    intervals = build_intervals(config)
    intervals.sort(key=lambda iv: (iv[0], iv[1]))
    out = cache + "/prof_out"
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out + "/preds/")
    journal = out + "/resume.journal"

    streamstats.reset()   # one accounting epoch per run
    t0 = time.time()
    emitter = make_ordered_emitter(config, out + "/", intervals) \
        if with_emitter else None
    collector = StreamingCandidateCollector(config, emitter) \
        if with_collector else None
    n = stream_inference(config, intervals,
                         out + "/preds/pepper_predictions.hdf",
                         candidate_collector=collector,
                         resume_journal=journal)
    t_stream = time.time() - t0
    t0 = time.time()
    if collector is not None:
        collector.finish()
    if emitter is not None:
        emitter.finish()
    t_tail = time.time() - t0
    return t_stream, t_tail, n, config, intervals, journal


def main(argv=None) -> int:
    from pepper_tpu_torch.pipelines.datastore import (PredictionStore,
                                                      h5py_available)
    from pepper_tpu_torch.runtime.streaming import resolve_device

    ap = argparse.ArgumentParser(
        description="Host-side profile of the streamed call_variant with "
                    "the device forward stubbed.")
    ap.add_argument("--mbp", type=float, default=1.0)
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the (stubbed) runner (default "
                         "cuda; cuda with no card raises)")
    ap.add_argument("--cache-dir", default=os.path.join("build", "bench"),
                    help="where the dataset and weights are kept (default "
                         "build/bench under the current directory)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cache, fasta, bam = bench.get_dataset(os.path.abspath(args.cache_dir),
                                          args.mbp)

    # ---- pure encode (the floor) ----------------------------------------
    t0 = time.time()
    images = bench.encode_all(fasta, bam, args.threads)   # warm pages
    print(f"encode warmup: {time.time() - t0:.2f}s ({len(images)} windows)")
    t0 = time.time()
    bench.encode_all(fasta, bam, args.threads)
    t_encode = time.time() - t0
    print(f"pure encode ({args.threads}th): {t_encode:.2f}s")

    # ---- stream variants, device stubbed (median of reps) ----------------
    variants = [("stream only (no stage3)", False, False),
                ("stream + collector (gates, no vcf)", True, False),
                ("stream + collector + ordered vcf", True, True)]
    with stubbed_device():
        run_stream(cache, fasta, bam, args.threads, dev, False, False)
        for name, wc, we in variants:
            times = []
            for _ in range(args.reps):
                s, t, n, config, intervals, journal = run_stream(
                    cache, fasta, bam, args.threads, dev, wc, we)
                times.append((s, t))
            times.sort(key=lambda p: p[0] + p[1])
            s, t = times[len(times) // 2]
            print(f"{name}: stream={s:.2f}s tail={t:.2f}s (overhead vs "
                  f"encode {100 * (s / t_encode - 1):.0f}%) n={n}",
                  flush=True)

    # ---- stage-3 components standalone ----------------------------------
    batches = bench.journal_batches(journal, config, intervals)
    print(f"{len(batches)} prediction batches in the resume journal")
    t_gates, t_vcf, n_margin, n_dv = bench.stage3(config, batches,
                                                  cache + "/prof_vcf/")
    print(f"gates (batch_candidates) over all batches: {t_gates:.2f}s -> "
          f"{n_margin} margin, {n_dv} dv")
    print(f"aggregate+vcf write (finalize_candidates): {t_vcf:.2f}s")

    # HDF5 prediction-store write cost alone
    if not h5py_available():
        print("prediction HDF5 write alone: skipped (h5py is not "
              "installed)")
        return 0
    t0 = time.time()
    tmp_pred = cache + "/prof_predwrite.hdf"
    if os.path.exists(tmp_pred):
        os.remove(tmp_pred)
    with PredictionStore(tmp_pred, "w") as store:
        for i, (_, contigs, positions, depths, cands, freqs, probs,
                _) in enumerate(batches):
            store.write_prediction(i, contigs, positions, depths, cands,
                                   np.asarray(freqs), probs)
    print(f"prediction HDF5 write alone: {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
