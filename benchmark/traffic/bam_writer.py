# Frozen copy of pepper_tpu_torch/io/bam_writer.py at commit d27cce3, kept with the benchmark so that
# a later change to the program cannot move the yardstick. Imports
# rewritten; the index maps the writer's logical offsets to the file's.
"""BAM + BAI writer, pure Python (SAM spec 4.2 / 5.2).

Produces sorted, indexed BAMs used as test fixtures and by utility tools —
the capability the reference gets from htslib/samtools externally.
"""
import struct
from typing import List, Tuple

from .bgzf import BGZFWriter
from .sam import SamRecord, encode_record, reg2bin

_LINEAR_SHIFT = 14  # 16kb linear index windows


class BamWriter:
    def __init__(self, path: str, references: List[Tuple[str, int]],
                 header_text: str = ""):
        """references: [(name, length)] in target order."""
        self.path = path
        self.references = references
        if not header_text:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in references)
        self._writer = BGZFWriter(path)
        self._write_header(header_text)
        # per-ref index state
        self._bins = [dict() for _ in references]       # bin -> [(beg_voff, end_voff)]
        self._linear = [dict() for _ in references]     # window -> min voff
        self._last = (-1, -1)
        self._n_no_coor = 0

    def _write_header(self, text: str) -> None:
        w = self._writer
        tb = text.encode()
        w.write(b"BAM\x01" + struct.pack("<i", len(tb)) + tb)
        w.write(struct.pack("<i", len(self.references)))
        for name, length in self.references:
            nb = name.encode() + b"\0"
            w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", length))

    def write(self, rec: SamRecord) -> None:
        if rec.ref_id >= 0 and (rec.ref_id, rec.pos) < self._last:
            raise ValueError("records must be written in coordinate order")
        self._last = (rec.ref_id, rec.pos)
        start_voff = self._writer.virtual_offset
        self._writer.write(encode_record(rec))
        end_voff = self._writer.virtual_offset
        if rec.ref_id < 0:
            self._n_no_coor += 1
            return
        end = max(rec.reference_end(), rec.pos + 1)
        b = reg2bin(rec.pos, end)
        chunks = self._bins[rec.ref_id].setdefault(b, [])
        if chunks and chunks[-1][1] == start_voff:
            chunks[-1] = (chunks[-1][0], end_voff)
        else:
            chunks.append((start_voff, end_voff))
        lin = self._linear[rec.ref_id]
        for window in range(rec.pos >> _LINEAR_SHIFT, ((end - 1) >> _LINEAR_SHIFT) + 1):
            if window not in lin or lin[window] > start_voff:
                lin[window] = start_voff

    def close(self) -> None:
        self._writer.close()
        self._write_bai()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _write_bai(self) -> None:
        real = self._writer.real_offset   # the index holds logical offsets
        with open(self.path + ".bai", "wb") as fh:
            fh.write(b"BAI\x01")
            fh.write(struct.pack("<i", len(self.references)))
            for ref_idx in range(len(self.references)):
                bins = self._bins[ref_idx]
                fh.write(struct.pack("<i", len(bins)))
                for bin_id in sorted(bins):
                    chunks = bins[bin_id]
                    fh.write(struct.pack("<Ii", bin_id, len(chunks)))
                    for beg, end in chunks:
                        fh.write(struct.pack("<QQ", real(beg), real(end)))
                lin = self._linear[ref_idx]
                n_intv = (max(lin) + 1) if lin else 0
                fh.write(struct.pack("<i", n_intv))
                # fill gaps with the previous window's offset (htslib convention)
                prev = 0
                for window in range(n_intv):
                    if window in lin:
                        prev = real(lin[window])
                    fh.write(struct.pack("<Q", prev))
            fh.write(struct.pack("<Q", self._n_no_coor))
