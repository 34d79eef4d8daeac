# Frozen copy of pepper_tpu_torch/io/bam_reader.py at commit d27cce3, kept with the benchmark so that
# a later change to the program cannot move the yardstick. Imports
# rewritten; the native fetch path is left out (plain Python only).
"""Pure-Python BAM reader with BAI region queries and PEPPER read trimming.

This is the reference backend used to validate the native C++ reader
(pepper_tpu/native/bam.cc); both implement the same trimming semantics as
reference `pepper_variant/modules/cpp/bam_handler.cpp:115-451`:

- records fetched via the BAI binning + linear index for [start, stop)
- skip qc_fail / duplicate / secondary / unmapped, optionally supplementary
- skip mapping_quality < min_mapq
- CIGAR/sequence trimmed to the region: match bases kept while
  ref_pos <= stop (inclusive); inserts and soft-clips kept only when
  anchored inside [start, stop]; deletes clipped at stop
- bad_indices collect low-quality or non-ACGT bases, terminated by a
  sentinel len(seq)+1 (bam_handler.cpp:307)
- HP integer aux tag extracted
"""
import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from benchmark.traffic.bgzf import BGZFReader
from benchmark.traffic.sam import (CIGAR_OPS, OP_M, OP_I, OP_D, OP_N, OP_S, OP_H,
                               OP_P, OP_EQ, OP_X, SEQ_NT16, reg2bins,
                               FLAG_UNMAPPED, FLAG_REVERSE, FLAG_SECONDARY,
                               FLAG_QCFAIL, FLAG_DUP, FLAG_SUPPLEMENTARY)

_MATCH_OPS = (OP_M, OP_EQ, OP_X)


@dataclass
class TrimmedRead:
    """Region-trimmed read — field parity with reference type_read (read.h:16-40)."""
    query_name: str
    pos: int
    pos_end: int
    sequence: str
    base_qualities: List[int]
    cigar_tuples: List[Tuple[int, int]]   # [(op, length)] after trimming
    mapping_quality: int
    flags: int
    hp_tag: int
    bad_indices: List[int]

    @property
    def is_reverse(self) -> bool:
        return bool(self.flags & FLAG_REVERSE)


@dataclass
class RawAlignment:
    query_name: str
    flag: int
    ref_id: int
    pos: int
    mapq: int
    cigar: List[Tuple[int, int]]
    seq: str
    qual: List[int]
    hp_tag: int


def _parse_aux_hp(aux: bytes) -> int:
    """Scan the aux blob for an integer HP tag (bam_handler.cpp:313-428)."""
    i = 0
    n = len(aux)
    while i + 4 <= n:
        tag = aux[i:i + 2]
        typ = aux[i + 2:i + 3]
        i += 3
        if typ in (b"c", b"C"):
            val = struct.unpack_from("<b" if typ == b"c" else "<B", aux, i)[0]
            i += 1
        elif typ in (b"s", b"S"):
            val = struct.unpack_from("<h" if typ == b"s" else "<H", aux, i)[0]
            i += 2
        elif typ in (b"i", b"I"):
            val = struct.unpack_from("<i" if typ == b"i" else "<I", aux, i)[0]
            i += 4
        elif typ == b"A":
            i += 1
            continue
        elif typ == b"f":
            i += 4
            continue
        elif typ in (b"Z", b"H"):
            end = aux.index(b"\0", i)
            i = end + 1
            continue
        elif typ == b"B":
            sub = aux[i:i + 1]
            count = struct.unpack_from("<I", aux, i + 1)[0]
            size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4}[sub]
            i += 5 + count * size
            continue
        else:
            break
        if tag == b"HP":
            return val
    return 0


def parse_bam_record(data: bytes) -> Tuple[RawAlignment, int]:
    """Parse one record starting at data[0] (without the leading block_size)."""
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_ref, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    name = data[off:off + l_read_name - 1].decode()
    off += l_read_name
    cigar = []
    for _ in range(n_cigar):
        v = struct.unpack_from("<I", data, off)[0]
        cigar.append((v & 0xF, v >> 4))
        off += 4
    seq_bytes = data[off:off + (l_seq + 1) // 2]
    off += (l_seq + 1) // 2
    seq = "".join(
        SEQ_NT16[(seq_bytes[i // 2] >> 4) & 0xF] if i % 2 == 0
        else SEQ_NT16[seq_bytes[i // 2] & 0xF]
        for i in range(l_seq))
    qual = list(data[off:off + l_seq])
    off += l_seq
    hp = _parse_aux_hp(data[off:])
    return RawAlignment(name, flag, ref_id, pos, mapq, cigar, seq, qual, hp), off


def trim_read(aln: RawAlignment, start: int, stop: int,
              min_baseq: int) -> Optional[TrimmedRead]:
    """Trim an alignment to [start, stop] — reference bam_handler.cpp:174-307."""
    current_pos = aln.pos
    read_index = 0
    pos_start = -1
    pos_end = -1
    seq_out: List[str] = []
    qual_out: List[int] = []
    cigar_out: List[Tuple[int, int]] = []
    bad: List[int] = []
    running = 0

    for op, length in aln.cigar:
        if current_pos > stop:
            break
        if op in _MATCH_OPS:
            cigar_index = 0
            if current_pos < start:
                cigar_index = min(start - current_pos, length)
                read_index += cigar_index
                current_pos += cigar_index
            kept = 0
            for _ in range(cigar_index, length):
                if current_pos <= stop:
                    if pos_start == -1:
                        pos_start = current_pos
                        pos_end = pos_start
                    q = aln.qual[read_index]
                    qual_out.append(q)
                    base = aln.seq[read_index].upper()
                    seq_out.append(base)
                    if q < min_baseq or base not in "ACGT":
                        bad.append(running)
                    running += 1
                    kept += 1
                    pos_end += 1
                else:
                    break
                read_index += 1
                current_pos += 1
            if kept > 0:
                cigar_out.append((op, kept))
        elif op in (OP_S, OP_I):
            kept = 0
            if start <= current_pos <= stop and pos_start != -1:
                for _ in range(length):
                    q = aln.qual[read_index]
                    qual_out.append(q)
                    base = aln.seq[read_index].upper()
                    seq_out.append(base)
                    if q < min_baseq or base not in "ACGT":
                        bad.append(running)
                    running += 1
                    kept += 1
                    read_index += 1
            else:
                read_index += length
            if kept > 0:
                cigar_out.append((op, kept))
        elif op in (OP_N, OP_D):
            kept = 0
            if start <= current_pos <= stop and pos_start != -1:
                for _ in range(length):
                    if current_pos <= stop:
                        kept += 1
                        pos_end += 1
                    else:
                        break
                    current_pos += 1
            else:
                current_pos += length
            if kept > 0:
                cigar_out.append((op, kept))
        elif op == OP_H:
            pass
        elif op == OP_P:
            current_pos += length

    if not seq_out:
        return None
    bad.append(len(seq_out) + 1)
    return TrimmedRead(
        query_name=aln.query_name,
        pos=pos_start,
        pos_end=pos_end,
        sequence="".join(seq_out),
        base_qualities=qual_out,
        cigar_tuples=cigar_out,
        mapping_quality=aln.mapq,
        flags=aln.flag,
        hp_tag=aln.hp_tag,
        bad_indices=bad,
    )


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError("not a BAI file")
        off = 4
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.bins: List[dict] = []
        self.linear: List[List[int]] = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, off)[0]
            off += 4
            bins = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, off)[0]
            off += 4
            intervals = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            self.bins.append(bins)
            self.linear.append(intervals)

    def chunks_for(self, ref_id: int, start: int, stop: int) -> List[Tuple[int, int]]:
        bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        window = start >> 14
        min_voff = linear[window] if window < len(linear) else (linear[-1] if linear else 0)
        chunks = []
        for b in reg2bins(start, stop):
            for beg, end in bins.get(b, ()):
                if end > min_voff:
                    chunks.append((max(beg, min_voff), end))
        chunks.sort()
        merged: List[Tuple[int, int]] = []
        for beg, end in chunks:
            if merged and beg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end))
            else:
                merged.append((beg, end))
        return merged


class BamReader:
    """BAM reader with PEPPER get_reads semantics (pure Python backend)."""

    def __init__(self, path: str):
        self.path = path
        # CRAM is not supported by this from-spec reader (the reference
        # silently accepts it through htslib's sam_open auto-detection,
        # bam_handler.cpp:7). Surface a crisp, actionable error instead
        # of a confusing BGZF parse failure.
        with open(path, "rb") as _fh:
            if _fh.read(4) == b"CRAM":
                raise ValueError(
                    f"{path} is a CRAM file — CRAM input is not "
                    f"supported; convert it first with: samtools view "
                    f"-b -o {path.rsplit('.', 1)[0]}.bam {path}")
        self._bgzf = BGZFReader(path)
        magic = self._bgzf.read(4)
        if magic != b"BAM\x01":
            raise ValueError("not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        self.header_text = self._bgzf.read(l_text).decode()
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            name = self._bgzf.read(l_name)[:-1].decode()
            l_ref = struct.unpack("<i", self._bgzf.read(4))[0]
            self.references.append((name, l_ref))
        self._ref_ids = {name: i for i, (name, _) in enumerate(self.references)}
        self._index = BaiIndex(path + ".bai")

    def close(self) -> None:
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def get_chromosome_sequence_names(self) -> List[str]:
        return [name for name, _ in self.references]

    def get_sample_names(self) -> List[str]:
        samples = set()
        for line in self.header_text.splitlines():
            if line.startswith("@RG"):
                for token in line.split("\t")[1:]:
                    if token.startswith("SM:"):
                        samples.add(token[3:])
        return sorted(samples)

    def _iter_region_records(self, chromosome: str, start: int, stop: int):
        ref_id = self._ref_ids[chromosome]
        for beg, end in self._index.chunks_for(ref_id, start, stop):
            self._bgzf.seek_virtual(beg)
            while self._bgzf.virtual_offset < end:
                size_bytes = self._bgzf.read(4)
                if len(size_bytes) < 4:
                    break
                block_size = struct.unpack("<i", size_bytes)[0]
                data = self._bgzf.read(block_size)
                aln, _ = parse_bam_record(data)
                if aln.ref_id != ref_id:
                    continue
                if aln.pos >= stop:
                    break
                ref_end = aln.pos
                for op, length in aln.cigar:
                    if op in (OP_M, OP_D, OP_N, OP_EQ, OP_X):
                        ref_end += length
                if ref_end <= start:
                    continue
                yield aln

    def get_reads(self, chromosome: str, start: int, stop: int,
                  include_supplementary: bool = False, min_mapq: int = 0,
                  min_baseq: int = 0) -> List[TrimmedRead]:
        """Fetch trimmed reads overlapping [start, stop) — bam_handler.cpp:115-451."""
        reads = []
        for aln in self._iter_region_records(chromosome, start, stop):
            if aln.flag & (FLAG_QCFAIL | FLAG_DUP | FLAG_SECONDARY | FLAG_UNMAPPED):
                continue
            if not include_supplementary and (aln.flag & FLAG_SUPPLEMENTARY):
                continue
            if aln.mapq < min_mapq:
                continue
            trimmed = trim_read(aln, start, stop, min_baseq)
            if trimmed is not None:
                reads.append(trimmed)
        return reads
