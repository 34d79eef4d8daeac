"""Plain reference of streamed variant calling over a sample of intervals:
the reads and reference of each interval through the Python region encoder
(frozen copies beside this file), the candidates' images through the plain
classifier (`models.classifier_forward`), and the candidate gates of
PEPPER r0.8's CandidateFinder.py:356-531 into the records of the FULL VCF.

Sites are compared by position: a site with one candidate that passes
carries one record (GT from the argmax, AP = max(p_het, p_homalt), DP, AD,
REP); a position with several candidates is compared for its presence
only (those few records merge alleles in the VCF writer).
"""
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import models
from benchmark.reference.bam_reader import BamReader
from benchmark.reference.options import AlignerOptions, REGION_SAFE_BASES
from benchmark.reference.region_encoder import RegionalSummary, TruthRecord
from benchmark.traffic.fasta import FastaReader

ACGT = frozenset("ACGT")


def intervals(fasta: str, region_size: int):
    """The whole-genome intervals of the streamed caller, in its order:
    (contig, start, end) in region_size steps, sorted by (contig, start)."""
    out = []
    with FastaReader(fasta) as fa:
        for contig in fa.get_chromosome_names():
            last = fa.get_chromosome_sequence_length(contig) - 1
            for pos in range(0, last, region_size):
                out.append((contig, pos, min(last, pos + region_size)))
    out.sort(key=lambda iv: (iv[0], iv[1]))
    return out


def sample_intervals(fasta: str, region_size: int, n: int, seed: int):
    """The `n` intervals the check compares, drawn from `seed` among all
    the genome's intervals."""
    ivs = intervals(fasta, region_size)
    pick = np.random.default_rng(seed).choice(len(ivs), min(n, len(ivs)),
                                              replace=False)
    return [ivs[i] for i in sorted(pick)]


def truth_records(truth: str) -> dict:
    """{contig: (haplotype 1's records, haplotype 2's)} of a truth VCF."""
    out: Dict[str, tuple] = {}
    with open(truth) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            pos, ref, alt = int(f[1]) - 1, f[3], f[4]
            rec = TruthRecord(f[0], pos, pos + len(ref), ref, alt)
            haps = out.setdefault(f[0], ([], []))
            for h, allele in enumerate(f[9].replace("/", "|").split("|")):
                if allele == "1":
                    haps[h].append(rec)
    return out


def reservoir_downsample(reads: list, rate: float) -> list:
    """AlignmentSummarizer.py:195-208 (fixed seed)."""
    allowed = int(min(AlignerOptions.MAX_READS_IN_REGION, rate * len(reads)))
    if len(reads) <= allowed:
        return reads
    random = np.random.RandomState(AlignerOptions.RANDOM_SEED)
    sample = []
    for i, read in enumerate(reads):
        if len(sample) < allowed:
            sample.append(read)
        else:
            j = random.randint(0, i + 1)
            if j < allowed:
                sample[j] = read
    return sample


def encode_interval(bam: str, fasta: str, contig: str, start: int, end: int,
                    image: dict, truth: tuple = None) -> list:
    """Candidate images of one interval (AlignmentSummarizer.create_summary):
    reads fetched over the interval +-100 bp. With `truth` (the contig's
    two haplotypes' records, `truth_records`) in train mode, each image
    labeled by the genotype of its allele."""
    with FastaReader(fasta) as fa, BamReader(bam) as reads_in:
        last = fa.get_chromosome_sequence_length(contig) - 1
        lo = max(0, start - REGION_SAFE_BASES)
        hi = min(end + REGION_SAFE_BASES, last)
        ref_seq = fa.get_reference_sequence(contig, lo, hi + 1)
        reads = reads_in.get_reads(contig, lo, hi, False, image["min_mapq"],
                                   image["min_snp_baseq"])
    reads = reservoir_downsample(reads, 1.0)
    if not reads:
        return []
    summary = RegionalSummary(contig, lo, hi, ref_seq)
    if truth is not None:
        summary.generate_labels(*truth)
    return summary.generate_summary(
        reads, min_snp_baseq=image["min_snp_baseq"],
        min_indel_baseq=image["min_indel_baseq"],
        snp_freq_threshold=image["snp_frequency"],
        insert_freq_threshold=image["insert_frequency"],
        delete_freq_threshold=image["delete_frequency"],
        min_coverage_threshold=image["min_coverage_threshold"],
        snp_candidate_freq_threshold=image[
            "snp_candidate_frequency_threshold"],
        indel_candidate_freq_threshold=image[
            "indel_candidate_frequency_threshold"],
        candidate_support_threshold=image["candidate_support_threshold"],
        skip_indels=image["skip_indels"], candidate_region_start=start,
        candidate_region_end=end, train_mode=truth is not None)


def homopolymer_runs(seq: str) -> List[int]:
    """Per position, the length of the run of equal bases it lies in
    (CandidateFinder.py's repeat_annotation with k-mer size 1)."""
    out = [1] * len(seq)
    i = 0
    while i < len(seq):
        j = i + 1
        while j < len(seq) and seq[j] == seq[i]:
            j += 1
        out[i:j] = [j - i] * (j - i)
        i = j
    return out


def in_repeat(fa: FastaReader, contig: str, pos: int) -> bool:
    """CandidateFinder.py:393-416: the homopolymer runs of the +-10 bp
    around the site, and whether one of length >= 5 covers [pos-5, pos+4)."""
    length = fa.get_chromosome_sequence_length(contig)
    lo, hi = max(0, pos - 10), min(length, pos + 10)
    runs = homopolymer_runs(fa.get_reference_sequence(contig, lo, hi).upper())
    first, last = max(pos - 5, lo) - lo, min(pos + 4, hi) - lo
    return any(r >= 5 for r in runs[first:last])


def probabilities(tree: Dict, images: np.ndarray, device: str,
                  prec: models.Precision = models.F32,
                  block: int = 4096) -> np.ndarray:
    """[N,3] float64 softmax probabilities of int8 images, in blocks."""
    out = []
    with torch.no_grad():
        for lo in range(0, len(images), block):
            x = torch.from_numpy(images[lo:lo + block]).to(device).float()
            out.append(models.classifier_forward(tree, x, prec=prec)
                       .double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros((0, 3))


def candidates(bam: str, fasta: str, sample, image: dict) -> dict:
    """{interval: rows}; each row a dict of the candidate's contig, pos,
    allele, depth, support, ref base, in_repeat, and its int8 image."""
    out = {}
    with FastaReader(fasta) as fa:
        for iv in sample:
            rows = []
            for c in encode_interval(bam, fasta, *iv, image):
                pos = int(c.position)
                rows.append({"contig": c.contig, "pos": pos,
                             "allele": c.candidates[0],
                             "depth": int(c.depth),
                             "support": int(c.candidate_frequency[0]),
                             "ref": fa.get_reference_sequence(
                                 c.contig, pos, pos + 1).upper(),
                             "rep": in_repeat(fa, c.contig, pos),
                             "image": np.asarray(c.image).astype(np.int8)})
            out[iv] = rows
    return out


def gate(row: dict, probs: np.ndarray, cand: dict):
    """The DeepVariant-list gate for one single-allele candidate: None, or
    (ref, alt, nap, threshold) of the record it would write. `cand` holds
    the preset's p-values and frequency overrides."""
    allele = row["allele"]
    atype, body = allele[0], allele[1:]
    if row["ref"] not in ACGT or atype not in "123" or not body \
            or set(body) - ACGT:
        return None
    nap = float(max(probs[1], probs[2]))
    key = {"1": "snp", "2": "insert", "3": "delete"}[atype]
    thr = cand[f"{key}_p_value_in_lc" if row["rep"] else f"{key}_p_value"]
    over = cand["report_snp_above_freq" if atype == "1"
                else "report_indel_above_freq"]
    vaf = row["support"] / row["depth"] if row["depth"] else 0.0
    passed = nap >= thr
    if not (passed or 0 < over <= vaf):
        return None
    if atype == "3" and passed:
        return body, row["ref"], nap, thr
    return row["ref"], body, nap, thr


def sites(rows: list, probs: np.ndarray, cand: dict) -> dict:
    """{pos: site} of one interval: every candidate at the position with
    its probabilities, threshold, gate and, for a lone passing candidate,
    its record."""
    out: Dict[int, dict] = {}
    for row, p in zip(rows, probs):
        site = out.setdefault(row["pos"], {"cands": [], "record": None})
        g = gate(row, p, cand)
        key = {"1": "snp", "2": "insert", "3": "delete"}.get(row["allele"][0])
        thr = (cand[f"{key}_p_value_in_lc" if row["rep"]
                    else f"{key}_p_value"] if key else 1.0)
        site["cands"].append({"probs": p, "nap": float(max(p[1], p[2])),
                              "thr": thr, "passed": g is not None,
                              "gate": g, "row": row})
    for pos, site in out.items():
        passing = [c for c in site["cands"] if c["passed"]]
        site["present"] = bool(passing)
        if len(site["cands"]) == 1 and passing:
            c = passing[0]
            ref, alt, nap, _ = c["gate"]
            site["record"] = {"ref": ref, "alt": alt,
                              "gt": int(np.argmax(c["probs"])), "ap": nap,
                              "dp": c["row"]["depth"],
                              "ad": c["row"]["support"],
                              "rep": int(c["row"]["rep"])}
    return out


def call_sites(cands: dict, tree: Dict, cand_preset: dict, device: str,
               prec: models.Precision = models.F32) -> dict:
    """{interval: {pos: site}} for the candidates of each interval."""
    out = {}
    for iv, rows in cands.items():
        images = (np.stack([r["image"] for r in rows]) if rows
                  else np.zeros((0, 33, 26), np.int8))
        out[iv] = sites(rows, probabilities(tree, images, device, prec),
                        cand_preset)
    return out
