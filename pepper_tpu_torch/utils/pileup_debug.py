"""ASCII pileup pretty-printer — manual QA tool.

Role parity: reference helper/generate_pileup_from_reads.py and the C++
debug_print/debug_candidate_summary dumps (region_summary.cpp:919-1054).
Renders reads stacked under the reference with match/mismatch/indel marks.

The port's copy of pepper_tpu/utils/pileup_debug.py, with its imports
rewritten to pepper_tpu_torch.*.
"""
from typing import List, Optional, TextIO

import sys

from pepper_tpu_torch.io.bam_reader import TrimmedRead
from pepper_tpu_torch.io.sam import OP_M, OP_EQ, OP_X, OP_I, OP_D, OP_S


def render_pileup(ref_seq: str, ref_start: int, reads: List[TrimmedRead],
                  width: int = 120) -> str:
    """Text pileup: one row per read; '.' match, base for mismatch,
    '*' deletion, lowercase insert anchor."""
    rows = []
    for read in reads:
        row = [" "] * len(ref_seq)
        read_index = 0
        pos = read.pos
        for op, length in read.cigar_tuples:
            if op in (OP_M, OP_EQ, OP_X):
                for _ in range(length):
                    i = pos - ref_start
                    if 0 <= i < len(ref_seq):
                        base = read.sequence[read_index]
                        row[i] = "." if base == ref_seq[i] else base
                    read_index += 1
                    pos += 1
            elif op == OP_I:
                i = pos - 1 - ref_start
                if 0 <= i < len(ref_seq) and row[i] != " ":
                    row[i] = row[i].lower() if row[i] != "." else "+"
                read_index += length
            elif op == OP_D:
                for k in range(length):
                    i = pos + k - ref_start
                    if 0 <= i < len(ref_seq):
                        row[i] = "*"
                pos += length
            elif op == OP_S:
                read_index += length
        rows.append(("".join(row), read.query_name))

    out = []
    for chunk_start in range(0, len(ref_seq), width):
        chunk_end = min(chunk_start + width, len(ref_seq))
        out.append(f"POS {ref_start + chunk_start}")
        out.append("REF " + ref_seq[chunk_start:chunk_end])
        for row, name in rows:
            segment = row[chunk_start:chunk_end]
            if segment.strip():
                out.append("    " + segment + "  " + name)
        out.append("")
    return "\n".join(out)


def print_region_pileup(bam_path: str, fasta_path: str, contig: str,
                        start: int, end: int,
                        stream: Optional[TextIO] = None) -> None:
    from pepper_tpu_torch.io.bam_reader import BamReader
    from pepper_tpu_torch.io.fasta import FastaReader
    stream = stream or sys.stdout
    with BamReader(bam_path) as bam, FastaReader(fasta_path) as fa:
        ref_seq = fa.get_reference_sequence(contig, start, end)
        reads = bam.get_reads(contig, start, end)
    stream.write(render_pileup(ref_seq, start, reads) + "\n")
