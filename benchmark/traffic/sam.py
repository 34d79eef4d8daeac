# Frozen copy of pepper_tpu_torch/io/sam.py at commit d27cce3, kept with the benchmark so that
# a later change to the program cannot move the yardstick. Imports
# rewritten; the quality bytes are built without a scan for their maximum.
"""SAM/BAM record model and binning math (SAM spec sections 4.2, 5.3).

Shared by the pure-Python BAM reader/writer and the test fixtures; the native
C++ reader implements the same spec independently.
"""
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P, OP_EQ, OP_X = range(9)
CONSUMES_QUERY = {OP_M, OP_I, OP_S, OP_EQ, OP_X}
CONSUMES_REF = {OP_M, OP_D, OP_N, OP_EQ, OP_X}

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
NT16_CODE = {c: i for i, c in enumerate(SEQ_NT16)}
# byte -> 4-bit code; any other character is N (15)
_NT16_TABLE = np.full(256, 15, np.uint8)
_NT16_TABLE[np.frombuffer(SEQ_NT16.encode(), np.uint8)] = np.arange(16)

FLAG_PAIRED = 1
FLAG_PROPER_PAIR = 2
FLAG_UNMAPPED = 4
FLAG_MATE_UNMAPPED = 8
FLAG_REVERSE = 16
FLAG_MATE_REVERSE = 32
FLAG_READ1 = 64
FLAG_READ2 = 128
FLAG_SECONDARY = 256
FLAG_QCFAIL = 512
FLAG_DUP = 1024
FLAG_SUPPLEMENTARY = 2048


@dataclass
class SamRecord:
    query_name: str
    flag: int
    ref_id: int
    pos: int                         # 0-based leftmost
    mapq: int
    cigar: List[Tuple[int, int]]     # [(op, length)]
    seq: str
    qual: List[int]
    next_ref_id: int = -1
    next_pos: int = -1
    tlen: int = 0
    tags: List[Tuple[str, str, object]] = field(default_factory=list)  # (tag, type, value)

    def reference_end(self) -> int:
        end = self.pos
        for op, length in self.cigar:
            if op in CONSUMES_REF:
                end += length
        return end


def reg2bin(beg: int, end: int) -> int:
    """SAM spec 5.3: compute the bin for a [beg, end) interval."""
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


def reg2bins(beg: int, end: int) -> List[int]:
    """SAM spec 5.3: all bins a [beg, end) interval may overlap."""
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def encode_cigar(cigar: List[Tuple[int, int]]) -> bytes:
    return b"".join(struct.pack("<I", (length << 4) | op) for op, length in cigar)


def encode_seq(seq: str) -> bytes:
    codes = _NT16_TABLE[np.frombuffer(
        seq.upper().encode("ascii", "replace"), np.uint8)]
    if len(codes) % 2:
        codes = np.append(codes, np.uint8(0))
    return ((codes[0::2] << 4) | codes[1::2]).tobytes()


def encode_aux(tags: List[Tuple[str, str, object]]) -> bytes:
    out = bytearray()
    for tag, typ, value in tags:
        out += tag.encode()
        if typ == "i":
            out += b"i" + struct.pack("<i", value)
        elif typ == "C":
            out += b"C" + struct.pack("<B", value)
        elif typ == "c":
            out += b"c" + struct.pack("<b", value)
        elif typ == "S":
            out += b"S" + struct.pack("<H", value)
        elif typ == "s":
            out += b"s" + struct.pack("<h", value)
        elif typ == "I":
            out += b"I" + struct.pack("<I", value)
        elif typ == "A":
            out += b"A" + value.encode()[:1]
        elif typ == "f":
            out += b"f" + struct.pack("<f", value)
        elif typ == "Z":
            out += b"Z" + value.encode() + b"\0"
        else:
            raise ValueError(f"unsupported aux type {typ}")
    return bytes(out)


def encode_record(rec: SamRecord) -> bytes:
    name = rec.query_name.encode() + b"\0"
    cig = encode_cigar(rec.cigar)
    seq = encode_seq(rec.seq)
    if not rec.qual:
        qual = b"\xff" * len(rec.seq)
    else:
        try:
            qual = bytes(rec.qual)
        except ValueError:   # a quality above 255
            qual = bytes(min(q, 0xFF) for q in rec.qual)
    aux = encode_aux(rec.tags)
    bin_ = reg2bin(rec.pos, max(rec.reference_end(), rec.pos + 1))
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.ref_id, rec.pos, len(name), rec.mapq, bin_,
        len(rec.cigar), rec.flag, len(rec.seq), rec.next_ref_id,
        rec.next_pos, rec.tlen,
    ) + name + cig + seq + qual + aux
    return struct.pack("<i", len(body)) + body
