"""Diploid-label pileup encoder — the variant package's SummaryGenerator.

Parity: reference pepper_variant/modules/cpp/summary_generator.{cpp,h} —
the OTHER SummaryGenerator. Unlike the polish twin
(pepper_tpu/polish/summary.py <- pepper/modules/src/pileup_summary/
summary_generator.cpp), this one labels each expanded pileup column with a
15-class DIPLOID base pair drawn from two truth haplotype reads
(get_labels(h1, h2), summary_generator.cpp:44-88), carries a per-column
reference-feature row (ref_image, :440-447/:466-474), and owns its own
chunking incl. the train-mode bad-label segmentation (:491-582). It is
bound but caller-less in reference r0.8 (pybind_api.h:32-43) — the live
variant path uses RegionalSummaryGenerator instead — so this is a
parity/auditability port, Python over native speed.

Quirks preserved deliberately:
  - no mapping-quality gate on reads (generate_summary iterates all,
    :456-464);
  - a DELETE bumps coverage at the op's START position once per in-range
    deleted base (coverage[ref_position], not ref_position+i, :153-159);
  - REF_SKIP and PAD fall through to DELETE (:146-148);
  - inserts never bump coverage (:126-145);
  - uncovered positions are labeled get_labels('*','*') == 0 (:387-391);
  - bad_label_positions stores len(labels) AFTER the push (i.e. a
    1-based index, :394-398) and ends with a final len(labels) sentinel;
  - truth inserts are truncated to the read-observed longest insert and
    '*'-padded when shorter (:220-230);
  - train chunking pads by shifting the window LEFT and abandons windows
    that would cross a previous bad-label segment (:539-579).

The port's copy of pepper_tpu/encode/diploid_pileup.py, with its imports
rewritten to pepper_tpu_torch.*.
"""
from typing import Dict, List, Tuple

import numpy as np

from pepper_tpu_torch.io.bam_reader import TrimmedRead
from pepper_tpu_torch.io.sam import OP_M, OP_EQ, OP_X, OP_I, OP_D, OP_N, OP_S, OP_P

_MATCH = (OP_M, OP_EQ, OP_X)
_DELETE_LIKE = (OP_D, OP_N, OP_P)  # reference case fallthrough

MAX_COLOR = 254  # summary_generator.h:17


def get_feature_index(base: str, is_reverse: bool) -> int:
    """summary_generator.cpp:16-32 (reverse -> 0-3/8, forward -> 4-7/9)."""
    base = base.upper()
    order = "ACGT"
    if is_reverse:
        return order.index(base) if base in order else 8
    return order.index(base) + 4 if base in order else 9


def get_reference_feature_index(base: str) -> int:
    """summary_generator.cpp:34-41."""
    return {"A": 1, "C": 2, "G": 3, "T": 4}.get(base.upper(), 0)


# unordered diploid pair -> class (summary_generator.cpp:44-88); anything
# unlisted (incl. '#', missing) falls back to 0
_PAIR_LABELS: Dict[frozenset, int] = {}
for _lbl, (_a, _b) in enumerate(
        [("*", "*"), ("A", "A"), ("A", "C"), ("A", "T"), ("A", "G"),
         ("A", "*"), ("C", "C"), ("C", "T"), ("C", "G"), ("C", "*"),
         ("T", "T"), ("T", "G"), ("T", "*"), ("G", "G"), ("G", "*")]):
    _PAIR_LABELS[frozenset((_a, _b))] = _lbl


def get_labels(base_h1: str, base_h2: str) -> int:
    return _PAIR_LABELS.get(
        frozenset((base_h1.upper(), base_h2.upper())), 0)


def check_base(base: str) -> bool:
    """summary_generator.cpp:171-177."""
    return base.upper() in "ACGT*#" and base != ""


class ImageSummary:
    """Chunked output container (summary_generator.h:20-26)."""

    def __init__(self):
        self.images: List[List[List[int]]] = []
        self.positions: List[List[Tuple[int, int]]] = []
        self.refs: List[List[int]] = []
        self.labels: List[List[int]] = []
        self.chunk_ids: List[int] = []


class DiploidPileupSummary:
    """One region's diploid pileup state (reference SummaryGenerator)."""

    def __init__(self, reference_sequence: str, chromosome_name: str,
                 ref_start: int, ref_end: int):
        self.reference_sequence = reference_sequence
        self.chromosome_name = chromosome_name
        self.ref_start = ref_start
        self.ref_end = ref_end
        self._base: Dict[Tuple[int, int], float] = {}
        self._inserts: Dict[Tuple[int, int, int], float] = {}
        self._coverage: Dict[int, float] = {}
        self._longest_insert: Dict[int, int] = {}
        self._base_labels = [{}, {}]     # hp -> {pos: char}
        self._insert_labels = [{}, {}]   # hp -> {(pos, i): char}
        # outputs
        self.image: List[List[int]] = []
        self.labels: List[int] = []
        self.genomic_pos: List[Tuple[int, int]] = []
        self.bad_label_positions: List[int] = []
        self.ref_image: List[int] = []

    # ------------------------------------------------------------- pileup
    def iterate_over_read(self, read: TrimmedRead, region_start: int,
                          region_end: int) -> None:
        """summary_generator.cpp:91-169."""
        read_index = 0
        ref_position = read.pos
        rev = read.is_reverse
        rs, re_ = self.ref_start, self.ref_end
        for op, length in read.cigar_tuples:
            if ref_position > region_end:
                break
            if op in _MATCH:
                start_i = 0
                if ref_position < rs:
                    start_i = min(rs - ref_position, length)
                    read_index += start_i
                    ref_position += start_i
                for _ in range(start_i, length):
                    if rs <= ref_position <= re_:
                        base = read.sequence[read_index]
                        key = (ref_position, get_feature_index(base, rev))
                        self._base[key] = self._base.get(key, 0.0) + 1.0
                        self._coverage[ref_position] = \
                            self._coverage.get(ref_position, 0.0) + 1.0
                    read_index += 1
                    ref_position += 1
            elif op == OP_I:
                if rs <= ref_position - 1 <= re_:
                    alt = read.sequence[read_index:read_index + length]
                    anchor = ref_position - 1
                    for i, b in enumerate(alt):
                        key = (anchor, i, get_feature_index(b, rev))
                        self._inserts[key] = self._inserts.get(key, 0.0) + 1.0
                    self._longest_insert[anchor] = max(
                        self._longest_insert.get(anchor, 0), len(alt))
                read_index += length
            elif op in _DELETE_LIKE:
                for i in range(length):
                    if rs <= ref_position + i <= re_:
                        key = (ref_position + i, get_feature_index("*", rev))
                        self._base[key] = self._base.get(key, 0.0) + 1.0
                        # quirk: coverage bumps at the op START position
                        self._coverage[ref_position] = \
                            self._coverage.get(ref_position, 0.0) + 1.0
                ref_position += length
            elif op == OP_S:
                read_index += length
            # OP_H: nothing

    # ------------------------------------------------------------- labels
    def generate_labels(self, read: TrimmedRead, region_start: int,
                        region_end: int, hp_tag: int) -> None:
        """summary_generator.cpp:179-261 (one truth haplotype's walk)."""
        read_index = 0
        ref_position = read.pos
        rs = self.ref_start
        base_labels = self._base_labels[hp_tag - 1]
        insert_labels = self._insert_labels[hp_tag - 1]
        for op, length in read.cigar_tuples:
            if ref_position > region_end:
                break
            if op in _MATCH:
                start_i = 0
                if ref_position < rs:
                    start_i = min(rs - ref_position, length)
                    read_index += start_i
                    ref_position += start_i
                for _ in range(start_i, length):
                    if rs <= ref_position <= self.ref_end:
                        base_labels[ref_position] = read.sequence[read_index]
                    read_index += 1
                    ref_position += 1
            elif op == OP_I:
                anchor = ref_position - 1
                if rs <= anchor <= self.ref_end:
                    alt = read.sequence[read_index:read_index + length]
                    for i in range(self._longest_insert.get(anchor, 0)):
                        insert_labels[(anchor, i)] = (
                            alt[i] if i < len(alt) else "*")
                read_index += length
            elif op in _DELETE_LIKE:
                if rs <= ref_position <= self.ref_end:
                    for i in range(length):
                        if rs <= ref_position + i <= self.ref_end:
                            base_labels[ref_position + i] = "*"
                ref_position += length
            elif op == OP_S:
                read_index += length

    # -------------------------------------------------------------- image
    def _generate_image(self, start_pos: int, end_pos: int) -> None:
        """summary_generator.cpp:330-364 (counts / coverage * 254)."""
        for pos in range(start_pos, end_pos + 1):
            cov = max(1.0, self._coverage.get(pos, 0.0))
            self.image.append([
                int(np.uint8(self._base.get((pos, j), 0.0) / cov * MAX_COLOR))
                for j in range(10)])
            for ii in range(self._longest_insert.get(pos, 0)):
                self.image.append([
                    int(np.uint8(self._inserts.get((pos, ii, j), 0.0) / cov
                                 * MAX_COLOR))
                    for j in range(10)])

    def _generate_ref_image(self, start_pos: int, end_pos: int) -> None:
        """summary_generator.cpp:440-447/:466-474."""
        for pos in range(start_pos, end_pos + 1):
            self.ref_image.append(get_reference_feature_index(
                self.reference_sequence[pos - start_pos]))
            for _ in range(self._longest_insert.get(pos, 0)):
                self.ref_image.append(get_reference_feature_index("*"))

    def generate_summary(self, reads: List[TrimmedRead], start_pos: int,
                         end_pos: int) -> None:
        """Inference-mode entry (summary_generator.cpp:456-489)."""
        for read in reads:
            self.iterate_over_read(read, start_pos, end_pos)
        self._generate_ref_image(start_pos, end_pos)
        for pos in range(start_pos, end_pos + 1):
            self.genomic_pos.append((pos, 0))
            for ii in range(self._longest_insert.get(pos, 0)):
                self.genomic_pos.append((pos, ii + 1))
        self._generate_image(start_pos, end_pos)

    def generate_train_summary(self, reads: List[TrimmedRead],
                               start_pos: int, end_pos: int,
                               truth_read_hp1: TrimmedRead,
                               truth_read_hp2: TrimmedRead) -> None:
        """Train-mode entry (summary_generator.cpp:368-453)."""
        for read in reads:
            self.iterate_over_read(read, start_pos, end_pos)
        self.generate_labels(truth_read_hp1, start_pos, end_pos + 1, 1)
        self.generate_labels(truth_read_hp2, start_pos, end_pos + 1, 2)
        h1, h2 = self._base_labels
        i1, i2 = self._insert_labels
        for pos in range(start_pos, end_pos + 1):
            b1, b2 = h1.get(pos, ""), h2.get(pos, "")
            if self._coverage.get(pos, 0.0) > 0:
                self.labels.append(get_labels(b1, b2))
            else:
                self.labels.append(get_labels("*", "*"))
            if not check_base(b1) or not check_base(b2):
                self.bad_label_positions.append(len(self.labels))
            self.genomic_pos.append((pos, 0))
            for ii in range(self._longest_insert.get(pos, 0)):
                self.genomic_pos.append((pos, ii + 1))
                l1, l2 = i1.get((pos, ii)), i2.get((pos, ii))
                if l1 and l2:
                    self.labels.append(get_labels(l1, l2))
                    if not check_base(l1) or not check_base(l2):
                        self.bad_label_positions.append(len(self.labels))
                elif l1:
                    self.labels.append(get_labels(l1, "*"))
                    if not check_base(l1):
                        self.bad_label_positions.append(len(self.labels))
                elif l2:
                    self.labels.append(get_labels("*", l2))
                    if not check_base(l2):
                        self.bad_label_positions.append(len(self.labels))
                else:
                    self.labels.append(get_labels("*", "*"))
        self.bad_label_positions.append(len(self.labels))
        self._generate_ref_image(start_pos, end_pos)
        self._generate_image(start_pos, end_pos)

    # ----------------------------------------------------------- chunking
    def chunk_image(self, chunk_size: int, chunk_overlap: int,
                    image_height: int) -> ImageSummary:
        """summary_generator.cpp:491-536 (inference chunking, zero labels,
        right-padded with (-1,-1)/0 rows)."""
        out = ImageSummary()
        chunk_start = 0
        chunk_id = 0
        chunk_end = min(len(self.genomic_pos), chunk_size)
        while True:
            image_chunk = list(self.image[chunk_start:chunk_end])
            pos_chunk = list(self.genomic_pos[chunk_start:chunk_end])
            ref_chunk = list(self.ref_image[chunk_start:chunk_end])
            label_chunk = [0] * (chunk_end - chunk_start)
            padding = chunk_size - len(image_chunk)
            if padding > 0:
                image_chunk += [[0] * image_height] * padding
                pos_chunk += [(-1, -1)] * padding
                ref_chunk += [0] * padding
                label_chunk += [0] * padding
            out.images.append(image_chunk)
            out.positions.append(pos_chunk)
            out.labels.append(label_chunk)
            out.refs.append(ref_chunk)
            out.chunk_ids.append(chunk_id)
            chunk_id += 1
            if chunk_end == len(self.genomic_pos):
                break
            chunk_start = chunk_end - chunk_overlap
            chunk_end = min(len(self.genomic_pos), chunk_start + chunk_size)
        return out

    def chunk_image_train(self, chunk_size: int, chunk_overlap: int,
                          image_height: int,
                          chunk_id_start: int = 0) -> ImageSummary:
        """summary_generator.cpp:539-582 (train chunking over bad-label
        segments; pads by shifting the window left)."""
        out = ImageSummary()
        chunk_start = 0
        chunk_id = chunk_id_start
        chunk_end = 0
        bad = self.bad_label_positions
        for i in range(len(bad)):
            chunk_end = min(chunk_start + chunk_size, bad[i])
            while True:
                if chunk_end - chunk_start != chunk_size:
                    padding = chunk_size - (chunk_end - chunk_start)
                    chunk_start -= padding
                    if chunk_start < 0:
                        break
                    if i > 0 and chunk_start < bad[i - 1]:
                        break
                out.images.append(list(self.image[chunk_start:chunk_end]))
                out.positions.append(
                    list(self.genomic_pos[chunk_start:chunk_end]))
                out.refs.append(list(self.ref_image[chunk_start:chunk_end]))
                out.labels.append(list(self.labels[chunk_start:chunk_end]))
                out.chunk_ids.append(chunk_id)
                chunk_id += 1
                if chunk_end == bad[i]:
                    break
                chunk_start = chunk_end - chunk_overlap
                chunk_end = min(bad[i], chunk_start + chunk_size)
            chunk_start = chunk_end + 1
        return out

    # -------------------------------------------------------------- debug
    def debug_render(self, start_pos: int, end_pos: int) -> str:
        """ASCII pileup dump (summary_generator.cpp:264-328)."""
        lines = []
        cols = []
        for pos in range(start_pos, end_pos + 1):
            cols.append(self.reference_sequence[pos - start_pos])
            cols.extend("*" * self._longest_insert.get(pos, 0))
        lines.append("REF:\t" + "\t".join(cols))
        for h, name in ((0, "TRH1"), (1, "TRH2")):
            cols = []
            for pos in range(start_pos, end_pos + 1):
                cols.append(self._base_labels[h].get(pos, "?"))
                for ii in range(self._longest_insert.get(pos, 0)):
                    cols.append(self._insert_labels[h].get((pos, ii), "*"))
            lines.append(f"{name}:\t" + "\t".join(cols))
        lines.append("LBL:\t" + "\t".join(str(x) for x in self.labels))
        lines.append("POS:\t" + "\t".join(
            str(p % 100) for p, _ in self.genomic_pos))
        names = ["AFW", "CFW", "GFW", "TFW", "ARV", "CRV", "GRV", "TRV",
                 "*FW", "*RV"]
        for j in range(10):
            lines.append(f"{names[j]}:\t" + "\t".join(
                str(row[j]) for row in self.image))
        return "\n".join(lines)
