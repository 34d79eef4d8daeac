"""The one generator of the benchmark's inputs, driven by a cell's traffic
parameters and the run's seed.

- `variant_dataset`: a synthetic genome of `mbp` Mbp over `contigs`
  contigs, `snps`/`insertions`/`deletions` planted (het or hom-alt; at
  more than 2,000 in all, the counts of the whole genome, spread over every
  contig; at fewer, each contig's), reads
  at `coverage`x of `read_length` bp with `error_rate` errors, written as
  FASTA+fai, BAM+bai and the planted truth VCF (the recipe of
  pepper_tpu_torch/utils/bench.py::
  get_dataset at commit d27cce3, on the frozen writers beside this file).

Datasets are cached under benchmark/.cache/data/, keyed by the parameters
and the seeds, written to a side directory and renamed into place when
complete; the newest few are kept.
"""
import hashlib
import json
import os
import shutil
import time

from benchmark import harness
from benchmark.traffic.synth import (plant_variants, random_genome,
                                     simulate_reads_fast, write_dataset,
                                     write_truth_vcf)

KEEP = 8          # datasets kept in the cache (two sets of six seeds share)


def _cached(kind: str, params: dict, seeds, build) -> str:
    root = os.path.join(harness.CACHE, "data")
    key = hashlib.sha256(json.dumps([kind, params, list(seeds)],
                                    sort_keys=True).encode()).hexdigest()[:16]
    path = os.path.join(root, f"{kind}-{key}")
    if not os.path.isdir(path):
        partial = path + ".partial"
        shutil.rmtree(partial, ignore_errors=True)
        os.makedirs(partial)
        t0 = time.perf_counter()
        build(partial)
        try:
            os.replace(partial, path)
        except OSError:     # another process finished the same dataset
            shutil.rmtree(partial, ignore_errors=True)
        harness.log(f"{kind} dataset built in "
                    f"{time.perf_counter() - t0:.1f}s")
        _prune(root)
    os.utime(path)
    return path


def _prune(root: str) -> None:
    done = []
    for d in os.listdir(root):
        path = os.path.join(root, d)
        try:
            if not d.endswith(".partial"):
                done.append((os.path.getmtime(path), path))
        except FileNotFoundError:   # pruned by another process meanwhile
            pass
    done.sort()
    for _, old in done[:-KEEP]:
        shutil.rmtree(old, ignore_errors=True)


def variant_dataset(params: dict, seeds) -> dict:
    """{fasta, bam, mbp} of the reads-on-a-genome dataset; `seeds` are the
    genome's, the planted variants' and the reads'."""
    p = params
    genome_seed, variant_seed, read_seed = seeds[:3]

    def build(out):
        genome = random_genome(int(p["mbp"] * 1e6 / p["contigs"]),
                               seed=genome_seed, n_contigs=p["contigs"])
        variants = plant_variants(dict(genome), p["snps"], p["insertions"],
                                  p["deletions"], seed=variant_seed)
        records = simulate_reads_fast(genome, variants,
                                      coverage=p["coverage"],
                                      read_length=p["read_length"],
                                      error_rate=p["error_rate"],
                                      seed=read_seed)
        write_dataset(out, genome, records)
        write_truth_vcf(os.path.join(out, "truth.vcf"), genome, variants)

    keys = ("mbp", "contigs", "snps", "insertions", "deletions",
            "coverage", "read_length", "error_rate")
    path = _cached("genome-v3", {k: p.get(k) for k in keys}, seeds[:3],
                   build)
    return {"fasta": os.path.join(path, "ref.fa"),
            "bam": os.path.join(path, "reads.bam"),
            "truth": os.path.join(path, "truth.vcf"),
            "mbp": int(p["mbp"] * 1e6 / p["contigs"]) * p["contigs"] / 1e6}

