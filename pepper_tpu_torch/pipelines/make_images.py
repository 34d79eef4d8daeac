"""Stage 1 — candidate-image generation over genomic regions.

Parity source: pepper_variant/modules/python/ImageGenerationUI.py (contig
selection, 100kb interval build, process striping i % threads, per-worker
HDF5 output) and AlignmentSummarizer.py (region padding, reservoir
downsampling with the fixed seed, truth labeling, ref-example subsampling).

Parallelism model: regions are embarrassingly parallel host-side work
(BAM decode + event walk); a process pool stripes intervals exactly like the
reference. The device only enters at stage 2 (inference).
"""
import concurrent.futures
import os
import re
import sys
import time
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pepper_tpu_torch.encode.region_encoder import (CandidateBatch, CandidateImage,
                                              RegionalSummary, TruthRecord)
from pepper_tpu_torch.io.bam_reader import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.io.vcf import get_truth_records
from pepper_tpu_torch.options import (AlignerOptions, ConsensCandidateFinder,
                                ImageOptions, PipelineConfig)
from pepper_tpu_torch.pipelines.datastore import ImageStore

# Non-canonical human contig families skipped by default — covers the
# accession families in the reference's EXCLUDED_HUMAN_CONTIGS constant
# (pepper_variant/modules/python/ExcludeContigs.py, from DeepVariant r0.10):
# b37 GL* decoys, hs37d5, b38 chrUn/_random/_alt/_decoy/HLA-* and
# KI/KN/KQ/KV/KZ/JH scaffolds.
_EXCLUDE_PATTERNS = re.compile(
    r"^(GL\d|hs37d5|NC_007605|chrUn|chrEBV$|HLA-|KI\d|KN\d|KQ\d|KV\d|KZ\d|JH\d)"
    r"|_(random|alt|decoy)$|_hap\d")


def is_excluded_human_contig(name: str) -> bool:
    return bool(_EXCLUDE_PATTERNS.search(name))


def natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def parse_region_bed(path: str) -> Dict[str, List[List[int]]]:
    """BED -> {contig: [[start, end], ...]} (ImageGenerationUI.py:173-188)."""
    out: Dict[str, List[List[int]]] = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith(("#", "track", "browser")):
                continue
            f = line.split()
            out.setdefault(f[0], []).append([int(f[1]), int(f[2])])
    return out


def get_chromosome_list(region: Optional[str], fasta: str, bam: str
                        ) -> List[Tuple[str, Optional[Tuple[int, int]]]]:
    """Contig selection — BAM∩FASTA minus excluded contigs, or parse
    'chr20' / 'chr20:1000-2000' / comma lists (ImageGenerationUI.py:99-158)."""
    if not region:
        with FastaReader(fasta) as fa, BamReader(bam) as br:
            common = (set(fa.get_chromosome_names())
                      & set(br.get_chromosome_sequence_names()))
        common = sorted((c for c in common if not is_excluded_human_contig(c)),
                        key=natural_key)
        if not common:
            raise ValueError("no common contigs between the BAM and FASTA")
        return [(c, None) for c in common]
    out = []
    for name in (n.strip() for n in region.strip().split(",")):
        m = re.match(r"^([^:]+):(\d+)-(\d+)$", name)
        if m:
            out.append((m.group(1), (int(m.group(2)), int(m.group(3)))))
            continue
        # contig range syntax, e.g. 'chr1-5' (ImageGenerationUI.py:155-172)
        m = re.match(r"^([A-Za-z_]+)(\d+)-(?:[A-Za-z_]+)?(\d+)$", name)
        if m:
            prefix, lo, hi = m.group(1), int(m.group(2)), int(m.group(3))
            for i in range(min(lo, hi), max(lo, hi) + 1):
                out.append((f"{prefix}{i}", None))
        else:
            out.append((name, None))
    return out


def build_intervals(config: PipelineConfig
                    ) -> List[Tuple[str, int, int]]:
    """100kb region shards (ImageGenerationUI.py:289-316)."""
    chr_list = get_chromosome_list(config.region, config.fasta, config.bam)
    intervals = []
    with FastaReader(config.fasta) as fa:
        for chr_name, region in chr_list:
            length = fa.get_chromosome_sequence_length(chr_name)
            if not region:
                interval_start, interval_end = 0, length - 1
            else:
                interval_start = max(0, region[0])
                interval_end = min(region[1], length - 1)
            if (config.train_mode and interval_end - interval_start
                    < ImageOptions.MIN_SEQUENCE_LENGTH):
                continue
            for pos in range(interval_start, interval_end, config.region_size):
                pos_start = max(interval_start, pos)
                pos_end = min(interval_end, pos + config.region_size)
                if (config.train_mode and pos_end - pos_start
                        < ImageOptions.MIN_SEQUENCE_LENGTH):
                    continue
                intervals.append((chr_name, pos_start, pos_end))
    return intervals


def reservoir_downsample(reads: list, downsample_rate: float,
                         max_reads: int = AlignerOptions.MAX_READS_IN_REGION
                         ) -> list:
    """Fixed-seed reservoir sample (AlignmentSummarizer.py:195-208)."""
    total_allowed = int(min(max_reads, downsample_rate * len(reads)))
    if len(reads) <= total_allowed:
        return reads
    random = np.random.RandomState(AlignerOptions.RANDOM_SEED)
    sample = []
    for i, read in enumerate(reads):
        if len(sample) < total_allowed:
            sample.append(read)
        else:
            j = random.randint(0, i + 1)
            if j < total_allowed:
                sample[j] = read
    return sample


def create_region_summary(config: PipelineConfig, bam: BamReader,
                          fasta: FastaReader, chromosome: str,
                          region_start_position: int,
                          region_end_position: int,
                          bed_list: Optional[Dict] = None
                          ) -> Optional[Sequence[CandidateImage]]:
    """One region's candidate images (AlignmentSummarizer.create_summary)."""
    safe = ConsensCandidateFinder.REGION_SAFE_BASES

    use_native = not os.environ.get("PEPPER_TPU_NO_NATIVE")
    if use_native:
        from pepper_tpu_torch.native import encoder as native_encoder
        use_native = native_encoder.available()

    def encode(sub_start: int, sub_end: int,
               train: bool) -> Sequence[CandidateImage]:
        region_start = max(0, sub_start - safe)
        region_end = sub_end + safe
        contig_len = fasta.get_chromosome_sequence_length(chromosome)
        region_end = min(region_end, contig_len - 1)
        fetch_stop = region_end + 1 if train else region_end
        ref_seq = fasta.get_reference_sequence(chromosome, region_start,
                                               region_end + 1)
        hap1, hap2 = [], []
        if train:
            h1, h2 = get_truth_records(config.truth_vcf, chromosome,
                                       region_start, region_end)
            hap1 = [TruthRecord(*t) for t in h1]
            hap2 = [TruthRecord(*t) for t in h2]
        thresholds = dict(
            min_snp_baseq=config.min_snp_baseq,
            min_indel_baseq=config.min_indel_baseq,
            snp_freq_threshold=config.snp_frequency,
            insert_freq_threshold=config.insert_frequency,
            delete_freq_threshold=config.delete_frequency,
            min_coverage_threshold=config.min_coverage_threshold,
            snp_candidate_freq_threshold=config.snp_candidate_frequency_threshold,
            indel_candidate_freq_threshold=config.indel_candidate_frequency_threshold,
            candidate_support_threshold=config.candidate_support_threshold,
            skip_indels=config.skip_indels)

        if use_native:
            from pepper_tpu_torch.options import ImageOptions, ImageOptionsHP
            geometry = (dict(hp_mode=True,
                             window_size=ImageOptionsHP.CANDIDATE_WINDOW_SIZE,
                             feature_size=ImageOptionsHP.IMAGE_HEIGHT)
                        if config.use_hp_info else {})
            ref_id = bam._ref_ids[chromosome]
            chunks = bam._index.chunks_for(ref_id, region_start, fetch_stop)
            return native_encoder.encode_region_native(
                bam.path, chunks, ref_id, chromosome, region_start,
                fetch_stop, region_start, region_end, ref_seq,
                include_supplementary=config.include_supplementary,
                min_mapq=config.min_mapq,
                candidate_region_start=region_start_position,
                candidate_region_end=region_end_position,
                train_mode=train, hap1=hap1, hap2=hap2,
                downsample_rate=config.downsample_rate, **geometry,
                **thresholds)

        reads = bam.get_reads(chromosome, region_start, fetch_stop,
                              config.include_supplementary,
                              config.min_mapq, config.min_snp_baseq)
        reads = reservoir_downsample(reads, config.downsample_rate)
        if not reads:
            return []
        if config.use_hp_info:
            # PEPPER-HP second pass: 48-feature dual-haplotype encoder
            from pepper_tpu_torch.encode.region_encoder_hp import RegionalSummaryHP
            summary = RegionalSummaryHP(chromosome, region_start, region_end,
                                        ref_seq)
        else:
            summary = RegionalSummary(chromosome, region_start, region_end,
                                      ref_seq)
        if train:
            summary.generate_labels(hap1, hap2)
        return summary.generate_summary(
            reads,
            candidate_region_start=region_start_position,
            candidate_region_end=region_end_position,
            train_mode=train, **thresholds)

    if not config.train_mode:
        return encode(region_start_position, region_end_position, False)

    # train mode: intersect with the high-confidence bed when given
    if bed_list is not None:
        if chromosome not in bed_list:
            return None
        truth_regions = []
        for bed_start, bed_end in bed_list[chromosome]:
            lo = max(region_start_position, bed_start)
            hi = min(region_end_position, bed_end)
            if lo <= hi:
                truth_regions.append((lo, hi))
        if not truth_regions:
            return None
    else:
        truth_regions = [(region_start_position, region_end_position)]

    out: List[CandidateImage] = []
    batches: List[CandidateBatch] = []
    rng = np.random
    for sub_start, sub_end in truth_regions:
        candidates = encode(sub_start, sub_end, True)
        if isinstance(candidates, CandidateBatch):
            # subsample hom-ref examples, vectorized: draws are consumed in
            # record order, matching the reference's sequential loop
            # (AlignmentSummarizer.py:163-179)
            mask = np.ones(len(candidates), dtype=bool)
            ref_idx = np.flatnonzero(candidates.type_labels == 0)
            draws = rng.uniform(0.0, 1.0, len(ref_idx))
            mask[ref_idx] = draws <= config.random_draw_probability
            batches.append(candidates.select(mask))
            continue
        # subsample hom-ref examples (AlignmentSummarizer.py:163-179)
        n_ref = sum(1 for c in candidates if c.type_label == 0)
        draws = rng.uniform(0.0, 1.0, n_ref)
        di = 0
        for cand in candidates:
            if cand.type_label == 0:
                keep = draws[di] <= config.random_draw_probability
                di += 1
                if keep:
                    out.append(cand)
            else:
                out.append(cand)
    if batches and not out:
        return CandidateBatch.concat(batches)
    for b in batches:
        out.extend(b)
    return out


def _worker(config: PipelineConfig, all_intervals: List[Tuple[str, int, int]],
            bed_list, process_id: int) -> int:
    from pepper_tpu_torch.parallel.multihost import host_tag
    timestr = time.strftime("%m%d%Y_%H%M%S")
    file_name = os.path.join(
        config.image_output_directory,
        f"pepper_variants_images_{host_tag()}thread_{process_id}_{timestr}"
        + ("_hp" if config.use_hp_info else "") + ".hdf5")
    intervals = [r for i, r in enumerate(all_intervals)
                 if i % config.threads == process_id]
    with BamReader(config.bam) as bam, FastaReader(config.fasta) as fasta, \
            ImageStore(file_name, "w") as store:
        for chr_name, start, end in intervals:
            candidates = create_region_summary(config, bam, fasta, chr_name,
                                               start, end, bed_list)
            if candidates:
                store.write_summary(f"{chr_name}_{start}_{end}", candidates,
                                    config.train_mode)
    return process_id


def generate_images(config: PipelineConfig) -> str:
    """Run stage 1; returns the image output directory."""
    from pepper_tpu_torch.parallel import multihost

    multihost.initialize_from_config(config)
    os.makedirs(config.image_output_directory, exist_ok=True)
    bed_list = parse_region_bed(config.region_bed) if config.region_bed else None
    intervals = build_intervals(config)
    if multihost.host_count() > 1:
        # static interval striping across hosts (the reference's i % workers
        # process striping, ImageGenerationUI.py:326-339, lifted host-level)
        intervals = multihost.host_shard(intervals)
        _log(f"HOST {multihost.host_index()}/{multihost.host_count()}: "
             f"{len(intervals)} INTERVALS IN SHARD")
    _log(f"TOTAL INTERVALS: {len(intervals)}")
    t0 = time.time()
    if config.threads <= 1:
        _worker(config, intervals, bed_list, 0)
    else:
        # share-nothing threads, not fork: the C++ encoder releases the GIL
        # so threads parallelize the hot walk, and fork after JAX init is a
        # deadlock risk at scale (JAX is multithreaded by the time stage 1
        # runs under the fused driver)
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=config.threads) as pool:
            futures = [pool.submit(_worker, config, intervals, bed_list, pid)
                       for pid in range(config.threads)]
            for fut in concurrent.futures.as_completed(futures):
                exc = fut.exception()
                if exc is not None:
                    raise RuntimeError(f"image-generation shard failed: {exc}") \
                        from exc
    _log(f"FINISHED IMAGE GENERATION [{time.time() - t0:.1f}s]")
    return config.image_output_directory
