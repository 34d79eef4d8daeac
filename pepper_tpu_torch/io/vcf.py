"""VCF reading/writing with bgzip + tabix, no htslib/pysam.

Reader: plain or BGZF-compressed VCF, with the truth-record extraction
semantics of the reference (AlignmentSummarizer.get_truth_vcf_records:
PASS-only, per-haplotype GT split, 0-based start, stop = start + len(ref)).

Writer: the reference's 5-file split engine (VcfWriter.py:21-218) — FULL /
PEPPER / VARIANT_CALLING(+_SNPs/_INDEL) — emitting bgzipped VCF text with a
TBI (tabix) index built inline from the record coordinates.
"""
import math
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pepper_tpu_torch.io.bgzf import BGZFReader, BGZFWriter


# ------------------------------------------------------------------ reading
@dataclass
class VcfRecord:
    contig: str
    pos: int                 # 0-based start
    id: str
    ref: str
    alts: List[str]
    qual: Optional[float]
    filters: List[str]
    info: str
    format: List[str]
    samples: List[List[str]]

    @property
    def stop(self) -> int:
        return self.pos + len(self.ref)

    @property
    def alleles(self) -> List[str]:
        return [self.ref] + self.alts

    def genotype(self, sample: int = 0) -> List[int]:
        """First sample's GT as int list; '.' -> -1."""
        if "GT" not in self.format:
            return []
        gt = self.samples[sample][self.format.index("GT")]
        return [(-1 if a in (".", "") else int(a))
                for a in gt.replace("|", "/").split("/")]


def _open_maybe_bgzf(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return BGZFReader(path).read_all().decode().splitlines()
    with open(path) as fh:
        return fh.read().splitlines()


def read_vcf(path: str, contig: Optional[str] = None,
             start: Optional[int] = None,
             stop: Optional[int] = None) -> List[VcfRecord]:
    """Parse a VCF; optional overlap filter [start, stop) on one contig."""
    out = []
    for line in _open_maybe_bgzf(path):
        if not line or line.startswith("#"):
            continue
        f = line.split("\t")
        rec = VcfRecord(
            contig=f[0], pos=int(f[1]) - 1, id=f[2], ref=f[3],
            alts=[] if f[4] == "." else f[4].split(","),
            qual=None if f[5] == "." else float(f[5]),
            filters=f[6].split(";") if f[6] != "." else [],
            info=f[7] if len(f) > 7 else ".",
            format=f[8].split(":") if len(f) > 8 else [],
            samples=[s.split(":") for s in f[9:]])
        if contig is not None and rec.contig != contig:
            continue
        if start is not None and rec.stop <= start:
            continue
        if stop is not None and rec.pos >= stop:
            continue
        out.append(rec)
    return out


def get_truth_records(path: str, contig: str, start: int, stop: int):
    """(hap1, hap2) truth tuples (contig, pos_start, pos_end, ref, alt) —
    reference AlignmentSummarizer.py:39-66."""
    hap1, hap2 = [], []
    for rec in read_vcf(path, contig, start, stop):
        if "PASS" not in rec.filters:
            continue
        gt = rec.genotype()
        for hap, alt_location in enumerate(gt):
            if alt_location <= 0:
                continue
            truth = (rec.contig, rec.pos, rec.stop, rec.alleles[0],
                     rec.alleles[alt_location])
            (hap1 if hap == 0 else hap2).append(truth)
    return hap1, hap2


# ------------------------------------------------------------ tabix writing
def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class _TabixBuilder:
    """Accumulates per-record coordinates; writes a .tbi on finish."""

    def __init__(self):
        self.names: List[str] = []
        self._name_idx: Dict[str, int] = {}
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[Dict[int, int]] = []
        self._last: Tuple[str, int] = ("", -1)  # (contig, ref) fast path

    def add(self, contig: str, beg: int, end: int, v_start: int, v_end: int):
        if contig == self._last[0]:
            ref = self._last[1]
        else:
            if contig not in self._name_idx:
                self._name_idx[contig] = len(self.names)
                self.names.append(contig)
                self.bins.append({})
                self.linear.append({})
            ref = self._name_idx[contig]
            self._last = (contig, ref)
        b = _reg2bin(beg, end)
        chunks = self.bins[ref].setdefault(b, [])
        if chunks and chunks[-1][1] == v_start:
            chunks[-1] = (chunks[-1][0], v_end)
        else:
            chunks.append((v_start, v_end))
        for window in range(beg >> 14, ((end - 1) >> 14) + 1):
            self.linear[ref].setdefault(window, v_start)

    def write(self, path: str):
        payload = bytearray()
        payload += b"TBI\x01"
        names_blob = b"".join(n.encode() + b"\x00" for n in self.names)
        payload += struct.pack("<8i", len(self.names), 2, 1, 2, 0,
                               ord("#"), 0, len(names_blob))
        payload += names_blob
        for ref in range(len(self.names)):
            bins = self.bins[ref]
            payload += struct.pack("<i", len(bins))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                payload += struct.pack("<Ii", bin_id, len(chunks))
                for beg, end in chunks:
                    payload += struct.pack("<QQ", beg, end)
            lin = self.linear[ref]
            n_intv = (max(lin) + 1) if lin else 0
            payload += struct.pack("<i", n_intv)
            prev = 0
            for w in range(n_intv):
                if w in lin:
                    prev = lin[w]
                payload += struct.pack("<Q", prev)
        with BGZFWriter(path) as bw:
            bw.write(bytes(payload))


class IndexedVcfWriter:
    """One bgzipped+tabixed VCF output stream.

    Records are NOT flushed individually: BGZFWriter.virtual_offset is
    valid on the unflushed buffer ((block_start << 16) | in_block_offset),
    so blocks fill to the full 64KB — htslib's own behavior. Per-record
    flushing costs ~3 zlib streams per variant and 100x file bloat."""

    def __init__(self, path: str, header_text: str):
        self.path = path
        self._bgzf = BGZFWriter(path)
        self._tabix = _TabixBuilder()
        self._bgzf.write(header_text.encode())
        self._voffset = self._bgzf.virtual_offset

    def write_record(self, contig: str, beg: int, end: int, line):
        # records are written back to back, so the previous record's end
        # offset is this record's start — one offset computation per record
        v_start = self._voffset
        self._bgzf.write(line if isinstance(line, bytes) else line.encode())
        self._voffset = v_end = self._bgzf.virtual_offset
        self._tabix.add(contig, beg, end, v_start, v_end)

    def close(self):
        self._bgzf.close()
        self._tabix.write(self.path + ".tbi")

    def abort(self):
        """Failure-path cleanup: close the stream and delete the partial
        output instead of leaving a truncated .vcf.gz with no index."""
        try:
            self._bgzf.close()
        except Exception:
            pass
        for p in (self.path, self.path + ".tbi"):
            try:
                os.remove(p)
            except OSError:
                pass


# ----------------------------------------------------------- 5-file engine
def _fmt_float(v: float) -> str:
    return format(float(v), ".6g")


def vcf_header_text(sample_name: str, contigs: Sequence[Tuple[str, int]]) -> str:
    """Header parity with reference VcfWriter.get_vcf_header (VcfWriter.py:220-289)."""
    lines = ["##fileformat=VCFv4.2"]
    lines += [
        '##FILTER=<ID=PASS,Description="All filters passed">',
        '##FILTER=<ID=refCall,Description="Call is homozygous">',
        '##FILTER=<ID=lowGQ,Description="Low genotype quality">',
        '##FILTER=<ID=lowQUAL,Description="Low variant call quality">',
        '##FILTER=<ID=conflictPos,Description="Overlapping record">',
        '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
        '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Depth">',
        '##FORMAT=<ID=AD,Number=A,Type=Integer,Description="Allele depth">',
        '##FORMAT=<ID=VAF,Number=A,Type=Float,Description="Variant allele fractions.">',
        '##FORMAT=<ID=AP,Number=A,Type=Float,Description="Maximum variant allele probability for each allele.">',
        '##FORMAT=<ID=GQ,Number=1,Type=Float,Description="Genotype Quality">',
        '##FORMAT=<ID=REP,Number=1,Type=String,Description="If set to 1 then variant site is considered to be ina LowCompexity repeat region">',
    ]
    for name, length in contigs:
        lines.append(f"##contig=<ID={name},length={length}>")
    lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + sample_name)
    return "\n".join(lines) + "\n"


def render_site_line(variant, options):
    """Format one site's record from a candidate_list_to_variant tuple.
    Returns (contig, ref_start, ref_end, line_bytes, selected, is_snp).
    Shared by the Python engine (below) and the native engine's
    multi-candidate fallback (io/vcf_native.py); the native sink's batch
    path re-implements this byte-for-byte in C++
    (native/src/vcf_write.cpp, fuzz-differential-tested)."""
    (contig, ref_start, ref_end, ref_seq, alleles, genotype, depth,
     support, gt_prob, non_alt_preds, in_repeat) = variant
    max_alt_len = max(len(ref_seq), max(len(x) for x in alleles))
    qual = max(1, int(-10 * math.log10(max(1e-9, 1.0 - gt_prob))))
    is_snp = max_alt_len == 1
    if is_snp:
        cutoff = (options.snp_q_cutoff_in_lc if in_repeat
                  else options.snp_q_cutoff)
    else:
        cutoff = (options.indel_q_cutoff_in_lc if in_repeat
                  else options.indel_q_cutoff)
    failed_variant = qual <= cutoff
    is_ref_call = genotype[0] == 0 and genotype[1] == 0
    selected = is_ref_call or failed_variant
    # true division per allele — a reciprocal multiply differs in the
    # last ulp and crosses round() boundaries (e.g. 3/80)
    dp = max(1, depth)
    vafs = [round(ad / dp, 3) for ad in support]
    filt = "refCall" if is_ref_call else "PASS"
    # str(qual) == format(qual, '.6g') for the int qual range here
    line = (f"{contig}\t{ref_start + 1}\t.\t{ref_seq}\t"
            f"{','.join(alleles)}\t{qual}\t{filt}\t.\t"
            f"GT:AP:GQ:DP:AD:VAF:REP\t"
            f"{genotype[0]}/{genotype[1]}:"
            f"{','.join(_fmt_float(p) for p in non_alt_preds) or '.'}:"
            f"{qual}:{depth}:"
            f"{','.join(map(str, support))}:"
            f"{','.join(_fmt_float(v) for v in vafs)}:"
            f"{'1' if in_repeat else '0'}\n").encode()
    return contig, ref_start, ref_end, line, selected, is_snp


class VCFWriteEngine:
    """The reference's 5-output VCF writer (VcfWriter.py:12-218)."""

    def __init__(self, fasta_contigs: Sequence[Tuple[str, int]],
                 sample_name: str, output_dir: str,
                 filename_full: str = "PEPPER_VARIANT_FULL",
                 filename_pepper: str = "PEPPER_VARIANT_OUTPUT_PEPPER",
                 filename_variant_calling: str = "PEPPER_VARIANT_OUTPUT_VARIANT_CALLING"):
        if not output_dir.endswith("/"):
            output_dir += "/"
        header = vcf_header_text(sample_name, fasta_contigs)
        self.paths = {
            "full": output_dir + filename_full + ".vcf.gz",
            "pepper": output_dir + filename_pepper + ".vcf.gz",
            "vc": output_dir + filename_variant_calling + ".vcf.gz",
            "vc_snp": output_dir + filename_variant_calling + "_SNPs.vcf.gz",
            "vc_indel": output_dir + filename_variant_calling + "_INDEL.vcf.gz",
        }
        self.files = {k: IndexedVcfWriter(p, header)
                      for k, p in self.paths.items()}
        self._totals = [0, 0, 0, 0, 0]
        self._last_position = -1

    def candidate_list_to_variant(self, candidates, allowed_multiallelics: int):
        """Parity: VcfWriter.candidate_list_to_variant (VcfWriter.py:49-138)."""
        if len(candidates) == 1 and allowed_multiallelics >= 1:
            # single-candidate site (the overwhelming majority): the sort,
            # truncation and ref-suffix normalization are all no-ops
            (contig, ref_start, _ref_end, ref_allele, alt_allele, _genotype,
             depth, support, gt_prob, predictions, non_alt_preds,
             in_repeat) = candidates[0]
            p0, p1, p2 = predictions
            pg = 0 if p0 >= p1 and p0 >= p2 else (1 if p1 >= p2 else 2)
            gt_qual = predictions[pg] if pg else max(p1, p2)
            gt = [0, 0] if pg == 0 else ([0, 1] if pg == 1 else [1, 1])
            return (contig, ref_start, ref_start + len(ref_allele),
                    ref_allele, [alt_allele[0]], gt, depth, [support[0]],
                    gt_qual, list(non_alt_preds), in_repeat)
        candidates = sorted(candidates, key=lambda x: (x[5], x[8]), reverse=True)
        if len(candidates) > allowed_multiallelics:
            candidates = candidates[:allowed_multiallelics]

        max_ref_allele = ""
        for cand in candidates:
            if len(cand[3]) > len(max_ref_allele):
                max_ref_allele = cand[3]

        normalized = []
        for cand in candidates:
            (contig, ref_start, ref_end, ref_allele, alt_allele, genotype,
             depth, support, gt_prob, predictions, non_alt_preds, in_repeat) = cand
            suffix_needed = len(max_ref_allele) - len(ref_allele)
            if suffix_needed > 0:
                suffix_seq = max_ref_allele[-suffix_needed:]
                ref_allele = ref_allele + suffix_seq
                alt_allele = [alt + suffix_seq for alt in alt_allele]
            normalized.append((contig, ref_start, ref_end, ref_allele,
                               alt_allele, genotype, depth, support, gt_prob,
                               predictions, non_alt_preds, in_repeat))

        gt_qual = -1.0
        genotype_hp1, genotype_hp2 = [], []
        all_initialized = False
        site = dict(contig="", ref_start=0, ref_end=0, ref_allele="", depth=0)
        site_alts, site_supports, site_quals, site_naps = [], [], [], []
        site_in_repeat = False
        for i, cand in enumerate(normalized):
            (contig, ref_start, ref_end, ref_allele, alt_allele, genotype,
             depth, support, gt_prob, predictions, non_alt_preds,
             in_repeat) = cand
            site_in_repeat = in_repeat or site_in_repeat
            # first-max over the 3 genotype probs (np.argmax semantics,
            # without the per-candidate numpy dispatch cost)
            p0, p1, p2 = predictions
            predicted_genotype = (0 if p0 >= p1 and p0 >= p2
                                  else (1 if p1 >= p2 else 2))
            if predicted_genotype != 0:
                p = predictions[predicted_genotype]
                gt_qual = p if gt_qual < 0 else min(gt_qual, p)
            elif gt_qual < 0:
                gt_qual = max(predictions[1], predictions[2])

            if not all_initialized:
                site = dict(contig=contig, ref_start=ref_start,
                            ref_end=ref_start + len(ref_allele),
                            ref_allele=ref_allele, depth=depth)
                all_initialized = True
            site["depth"] = min(site["depth"], depth)
            site_alts.append(alt_allele[0])
            site_supports.append(support[0])
            site_quals.append(gt_prob)
            site_naps.extend(non_alt_preds)
            if predicted_genotype == 1:
                genotype_hp1.append(i + 1)
            elif predicted_genotype == 2:
                genotype_hp1.append(i + 1)
                genotype_hp2.append(i + 1)

        if 0 < len(genotype_hp1) + len(genotype_hp2) <= 2:
            gt = genotype_hp1 + genotype_hp2
            if len(gt) == 1:
                gt = [0, gt[0]]
        else:
            gt = [0, 0]
        return (site["contig"], site["ref_start"], site["ref_end"],
                site["ref_allele"], site_alts, gt, site["depth"],
                site_supports, gt_qual, site_naps, site_in_repeat)

    def write_site(self, all_candidates, options) -> None:
        """Write one (contig, position) site's record(s). Sites MUST be fed
        in the final global order — (contig, position) lexicographic — the
        cross-site de-dup state (last_position) lives on the engine.
        Parity: one iteration of VcfWriter.write_vcf_records
        (VcfWriter.py:140-218)."""
        variant = self.candidate_list_to_variant(
            all_candidates, options.allowed_multiallelics)
        if len(variant[4]) <= 0:
            return
        if variant[1] == self._last_position:
            return
        self._last_position = variant[1]
        (contig, ref_start, ref_end, line, selected, is_snp) = \
            render_site_line(variant, options)

        def emit(key, total_idx):
            self.files[key].write_record(contig, ref_start, ref_end, line)
            self._totals[total_idx] += 1

        emit("full", 0)
        if selected:
            emit("vc_snp" if is_snp else "vc_indel", 3 if is_snp else 4)
            emit("vc", 2)
        else:
            emit("pepper", 1)

    @property
    def totals(self) -> Tuple[int, int, int, int, int]:
        return tuple(self._totals)

    def write_vcf_records(self, variants_list: Dict, options) -> Tuple[int, int, int, int, int]:
        """Parity: VcfWriter.write_vcf_records (VcfWriter.py:140-218)."""
        for key in sorted(variants_list):
            self.write_site(variants_list[key], options)
        return self.totals

    def close(self):
        for f in self.files.values():
            f.close()

    def abort(self):
        """Delete all 5 partial outputs on the failure path."""
        for f in self.files.values():
            f.abort()
