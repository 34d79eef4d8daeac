# Frozen copy of pepper_tpu_torch/io/fasta.py at commit d27cce3, kept with the benchmark so that
# a later change to the program cannot move the yardstick. Imports rewritten.
"""FASTA with .fai index: writer, index builder, and reader.

Replaces the reference's htslib faidx usage
(`pepper_variant/modules/cpp/fasta_handler.cpp:7-55`). Lookups are
uppercased like the reference's get_reference_sequence.
"""
import os
from typing import Dict, List, Tuple


def write_fasta(path: str, sequences: List[Tuple[str, str]], line_width: int = 60) -> None:
    with open(path, "w") as fh:
        for name, seq in sequences:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i:i + line_width] + "\n")
    build_fai(path)


def build_fai(path: str) -> None:
    """Build a samtools-compatible .fai index."""
    entries = []
    with open(path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        first_line = True
        while True:
            line_start = fh.tell()
            line = fh.readline()
            if not line:
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                break
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, offset, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                offset = fh.tell()
                linebases = 0
                linewidth = 0
                first_line = True
            else:
                bases = len(line.rstrip(b"\r\n"))
                if first_line and bases:
                    linebases = bases
                    linewidth = len(line)
                    first_line = False
                length += bases
    with open(path + ".fai", "w") as fh:
        for name, length, offset, linebases, linewidth in entries:
            fh.write(f"{name}\t{length}\t{offset}\t{linebases}\t{linewidth}\n")


class FastaReader:
    """fai-backed random access, API-parity with the reference FASTA_handler."""

    def __init__(self, path: str):
        self.path = path
        if not os.path.exists(path + ".fai"):
            build_fai(path)
        self._index: Dict[str, Tuple[int, int, int, int]] = {}
        self._order: List[str] = []
        with open(path + ".fai") as fh:
            for line in fh:
                name, length, offset, linebases, linewidth = line.rstrip("\n").split("\t")[:5]
                self._index[name] = (int(length), int(offset), int(linebases), int(linewidth))
                self._order.append(name)
        self._fh = open(path, "rb")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def get_chromosome_names(self) -> List[str]:
        return list(self._order)

    def get_chromosome_sequence_length(self, name: str) -> int:
        return self._index[name][0]

    def get_reference_sequence(self, name: str, start: int, stop: int) -> str:
        """Return uppercased reference [start, stop), clipped to the contig.

        Matches reference fasta_handler.cpp:31-47 (faidx_fetch_seq + toupper).
        """
        length, offset, linebases, linewidth = self._index[name]
        start = max(0, start)
        stop = min(stop, length)
        if stop <= start:
            return ""
        file_start = offset + (start // linebases) * linewidth + (start % linebases)
        file_stop = offset + ((stop - 1) // linebases) * linewidth + ((stop - 1) % linebases) + 1
        self._fh.seek(file_start)
        raw = self._fh.read(file_stop - file_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode().upper()
