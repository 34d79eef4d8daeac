# Frozen copy of pepper_tpu_torch/utils/synth.py at commit d27cce3, kept with the benchmark so that
# a later change to the program cannot move the yardstick. Imports rewritten. Changed from the
# original: plant_variants's Mbp-scale path splits the planted count over the contigs and spreads
# each contig's share over the whole contig (the original planted the whole count in each contig,
# all in its first third).
"""Synthetic genome / read-set builders for tests and benchmarks.

Generates a random reference, samples reads with configurable SNP/indel
errors and planted variants, and writes FASTA(+fai) and sorted BAM(+bai)
using pepper_tpu's own writers. Plays the role the pinned GCS quickstart
data plays for the reference (no network egress here).
"""
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .bam_writer import BamWriter
from .fasta import write_fasta
from .sam import (SamRecord, OP_M, OP_I, OP_D, OP_S,
                               FLAG_REVERSE)

BASES = "ACGT"


def random_genome(length: int, seed: int = 7, n_contigs: int = 1) -> List[Tuple[str, str]]:
    if length >= 100_000:
        # bench-scale contigs: vectorized (the pure-Python path below is
        # ~5s/Mbp). Different stream than the small path — fine: goldens
        # only pin small sizes, and the bench keys its cache by content.
        import numpy as np
        rng_np = np.random.RandomState(seed)
        lut = np.frombuffer(b"ACGT", np.uint8)
        return [
            (f"contig{i+1}",
             lut[rng_np.randint(0, 4, length)].tobytes().decode())
            for i in range(n_contigs)
        ]
    rng = random.Random(seed)
    return [
        (f"contig{i+1}", "".join(rng.choice(BASES) for _ in range(length)))
        for i in range(n_contigs)
    ]


@dataclass
class Variant:
    contig: str
    pos: int              # 0-based
    ref: str
    alt: str
    genotype: Tuple[int, int]  # e.g. (0,1) het, (1,1) hom-alt

    @property
    def kind(self) -> str:
        if len(self.ref) == len(self.alt) == 1:
            return "snp"
        return "ins" if len(self.alt) > len(self.ref) else "del"


def plant_variants(genome: Dict[str, str], n_snp: int, n_ins: int, n_del: int,
                   seed: int = 13) -> List[Variant]:
    rng = random.Random(seed)
    variants: List[Variant] = []
    total = n_snp + n_ins + n_del
    if total > 2000:
        # Mbp-scale fast path: the rejection loop below is
        # O(total^2 * attempts) (every draw scans the whole `used` set) —
        # hours at chr-scale counts. Split the count over the contigs,
        # sample an over-provisioned position set over each whole contig
        # and draw its share among the >20bp-spaced ones instead.
        # (Different draws than the loop path, so small/golden datasets
        # keep the original algorithm.)
        import numpy as np
        nprng = np.random.RandomState(seed)
        kinds_all = ["snp"] * n_snp + ["ins"] * n_ins + ["del"] * n_del
        rng.shuffle(kinds_all)
        n = len(genome)
        shares = [total // n + (i < total % n) for i in range(n)]
        first = 0
        for (contig, seq), share in zip(genome.items(), shares):
            lo, hi = 50, len(seq) - 60
            want = min(share, (hi - lo) // 25)
            cand = np.sort(nprng.choice(
                hi - lo, size=min(hi - lo, want * 3), replace=False) + lo)
            spaced = cand[np.concatenate(([True], np.diff(cand) > 20))]
            keep = np.sort(nprng.choice(spaced, min(want, len(spaced)),
                                        replace=False))
            kinds = kinds_all[first:first + len(keep)]
            first += share
            for pos, kind in zip(keep.tolist(), kinds):
                ref_base = seq[pos]
                gt = rng.choice([(0, 1), (1, 1)])
                if kind == "snp":
                    alt = rng.choice([b for b in BASES if b != ref_base])
                    variants.append(Variant(contig, pos, ref_base, alt, gt))
                elif kind == "ins":
                    ins = "".join(rng.choice(BASES)
                                  for _ in range(rng.randint(1, 4)))
                    variants.append(Variant(contig, pos, ref_base,
                                            ref_base + ins, gt))
                else:
                    del_len = rng.randint(1, 4)
                    variants.append(Variant(contig, pos,
                                            seq[pos:pos + del_len + 1],
                                            ref_base, gt))
        variants.sort(key=lambda v: (v.contig, v.pos))
        return variants
    used = set()
    for contig, seq in genome.items():
        kinds = ["snp"] * n_snp + ["ins"] * n_ins + ["del"] * n_del
        for kind in kinds:
            for _ in range(100):
                pos = rng.randrange(50, len(seq) - 60)
                if all(abs(pos - u) > 20 for u in used):
                    break
            used.add(pos)
            ref_base = seq[pos]
            gt = rng.choice([(0, 1), (1, 1)])
            if kind == "snp":
                alt = rng.choice([b for b in BASES if b != ref_base])
                variants.append(Variant(contig, pos, ref_base, alt, gt))
            elif kind == "ins":
                ins = "".join(rng.choice(BASES) for _ in range(rng.randint(1, 4)))
                variants.append(Variant(contig, pos, ref_base, ref_base + ins, gt))
            else:
                del_len = rng.randint(1, 4)
                variants.append(Variant(contig, pos, seq[pos:pos + del_len + 1],
                                        ref_base, gt))
    variants.sort(key=lambda v: (v.contig, v.pos))
    return variants


def _apply_haplotype(seq: str, variants: List[Variant], hap: int) -> Tuple[str, List[Tuple[int, int, str]]]:
    """Return haplotype sequence and edit list [(ref_pos, kind_len, alt)]."""
    out = []
    edits = []
    i = 0
    for v in variants:
        if v.genotype[hap] == 0:
            continue
        out.append(seq[i:v.pos])
        if v.kind == "snp":
            out.append(v.alt)
            i = v.pos + 1
        elif v.kind == "ins":
            out.append(v.alt)
            i = v.pos + 1
        else:  # del: keep anchor base, skip deleted
            out.append(v.alt)
            i = v.pos + len(v.ref)
        edits.append((v.pos, len(v.alt) - len(v.ref), v.alt))
    out.append(seq[i:])
    return "".join(out), edits


def simulate_reads(genome: List[Tuple[str, str]], variants: List[Variant],
                   coverage: int = 30, read_length: int = 600,
                   error_rate: float = 0.0, seed: int = 29,
                   baseq: int = 20, mapq: int = 60,
                   hp_tags: bool = False) -> List[SamRecord]:
    """Sample reads from the two haplotypes; exact alignment CIGARs derived
    from the known edits so pileups are deterministic."""
    rng = random.Random(seed)
    genome_map = dict(genome)
    records: List[SamRecord] = []
    ref_ids = {name: i for i, (name, _) in enumerate(genome)}
    read_no = 0
    for contig, ref_seq in genome:
        contig_variants = [v for v in variants if v.contig == contig]
        n_reads = max(1, coverage * len(ref_seq) // read_length)
        for _ in range(n_reads):
            hap = rng.randrange(2)
            hap_variants = [v for v in contig_variants if v.genotype[hap] == 1]
            start = rng.randrange(0, max(1, len(ref_seq) - read_length))
            end = min(len(ref_seq), start + read_length)
            seq_parts: List[str] = []
            cigar: List[Tuple[int, int]] = []
            pos = start
            def push(op: int, length: int):
                if length <= 0:
                    return
                if cigar and cigar[-1][0] == op:
                    cigar[-1] = (op, cigar[-1][1] + length)
                else:
                    cigar.append((op, length))
            while pos < end:
                v = next((v for v in hap_variants if v.pos == pos), None)
                if v is None or pos == start:  # variants at read start skipped (need anchor)
                    base = ref_seq[pos]
                    if rng.random() < error_rate:
                        base = rng.choice([b for b in BASES if b != base])
                    seq_parts.append(base)
                    push(OP_M, 1)
                    pos += 1
                elif v.kind == "snp":
                    seq_parts.append(v.alt)
                    push(OP_M, 1)
                    pos += 1
                elif v.kind == "ins":
                    seq_parts.append(v.alt)
                    push(OP_M, 1)
                    push(OP_I, len(v.alt) - 1)
                    pos += 1
                else:  # deletion: anchor + D
                    seq_parts.append(v.alt)
                    push(OP_M, 1)
                    push(OP_D, len(v.ref) - 1)
                    pos += len(v.ref)
            seq = "".join(seq_parts)
            flag = FLAG_REVERSE if rng.random() < 0.5 else 0
            tags = [("HP", "i", hap + 1)] if hp_tags else []
            records.append(SamRecord(
                query_name=f"read{read_no}", flag=flag, ref_id=ref_ids[contig],
                pos=start, mapq=mapq, cigar=cigar, seq=seq,
                qual=[baseq] * len(seq), tags=tags))
            read_no += 1
    records.sort(key=lambda r: (r.ref_id, r.pos))
    return records


def simulate_reads_fast(genome: List[Tuple[str, str]], variants: List[Variant],
                        coverage: int = 30, read_length: int = 10000,
                        error_rate: float = 0.0, seed: int = 29,
                        baseq: int = 20, mapq: int = 60,
                        hp_tags: bool = False) -> List[SamRecord]:
    """Slice-based read simulator for Mbp-scale benchmarks: O(edits + slices)
    per read instead of O(bases). Same CIGAR semantics as simulate_reads."""
    import bisect
    rng = random.Random(seed)
    nprng = __import__("numpy").random.RandomState(seed)
    np = __import__("numpy")
    records: List[SamRecord] = []
    ref_ids = {name: i for i, (name, _) in enumerate(genome)}
    read_no = 0
    base_codes = np.frombuffer(b"ACGT", dtype=np.uint8)
    for contig, ref_seq in genome:
        hap_variants = [
            sorted((v for v in variants
                    if v.contig == contig and v.genotype[h] == 1),
                   key=lambda v: v.pos)
            for h in range(2)]
        hap_positions = [[v.pos for v in hv] for hv in hap_variants]
        n_reads = max(1, coverage * len(ref_seq) // read_length)
        for _ in range(n_reads):
            hap = rng.randrange(2)
            hv, hpos = hap_variants[hap], hap_positions[hap]
            start = rng.randrange(0, max(1, len(ref_seq) - read_length))
            end = min(len(ref_seq), start + read_length)
            parts: List[str] = []
            cigar: List[Tuple[int, int]] = []

            def push(op: int, length: int):
                if length <= 0:
                    return
                if cigar and cigar[-1][0] == op:
                    cigar[-1] = (op, cigar[-1][1] + length)
                else:
                    cigar.append((op, length))

            pos = start
            lo = bisect.bisect_right(hpos, start)  # variants at start skipped
            for vi in range(lo, len(hpos)):
                v = hv[vi]
                if v.pos >= end:
                    break
                if v.pos < pos:
                    continue
                parts.append(ref_seq[pos:v.pos])
                push(OP_M, v.pos - pos)
                if v.kind == "snp":
                    parts.append(v.alt)
                    push(OP_M, 1)
                    pos = v.pos + 1
                elif v.kind == "ins":
                    parts.append(v.alt)
                    push(OP_M, 1)
                    push(OP_I, len(v.alt) - 1)
                    pos = v.pos + 1
                else:
                    parts.append(v.alt)
                    push(OP_M, 1)
                    push(OP_D, len(v.ref) - 1)
                    pos = v.pos + len(v.ref)
            parts.append(ref_seq[pos:end])
            push(OP_M, end - pos)
            seq = "".join(parts)
            if error_rate > 0:
                codes = np.frombuffer(seq.encode(), dtype=np.uint8).copy()
                hits = np.flatnonzero(nprng.random_sample(len(codes))
                                      < error_rate)
                codes[hits] = base_codes[nprng.randint(0, 4, len(hits))]
                seq = codes.tobytes().decode()
            flag = FLAG_REVERSE if rng.random() < 0.5 else 0
            tags = [("HP", "i", hap + 1)] if hp_tags else []
            records.append(SamRecord(
                query_name=f"read{read_no}", flag=flag,
                ref_id=ref_ids[contig], pos=start, mapq=mapq, cigar=cigar,
                seq=seq, qual=[baseq] * len(seq), tags=tags))
            read_no += 1
    records.sort(key=lambda r: (r.ref_id, r.pos))
    return records


def write_dataset(tmpdir: str, genome: List[Tuple[str, str]],
                  records: List[SamRecord]) -> Tuple[str, str]:
    """Write FASTA+fai and BAM+bai under tmpdir; return (fasta_path, bam_path)."""
    fasta_path = f"{tmpdir}/ref.fa"
    bam_path = f"{tmpdir}/reads.bam"
    write_fasta(fasta_path, genome)
    refs = [(name, len(seq)) for name, seq in genome]
    with BamWriter(bam_path, refs) as bw:
        for rec in records:
            bw.write(rec)
    return fasta_path, bam_path


def write_truth_vcf(path: str, genome: List[Tuple[str, str]],
                    variants: List[Variant]) -> str:
    """Plain-text truth VCF for train-mode labeling tests."""
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        for name, seq in genome:
            fh.write(f"##contig=<ID={name},length={len(seq)}>\n")
        fh.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n")
        for v in variants:
            gt = f"{v.genotype[0]}|{v.genotype[1]}"
            fh.write(f"{v.contig}\t{v.pos+1}\t.\t{v.ref}\t{v.alt}\t60\tPASS\t.\tGT\t{gt}\n")
    return path
