"""Compiled constants and typed pipeline configuration.

Parity source: reference `pepper_variant/modules/python/Options.py` and the
C++ namespaces `ImageOptionsRegion` (`region_summary.h:14-51`) and
`AlleleType` (`candidate_finder.h:23-27`).
"""
from dataclasses import dataclass, field
from typing import List, Optional


class ImageOptions:
    """Variant-calling image geometry (reference Options.py:5-14, region_summary.h:14-51)."""
    IMAGE_HEIGHT = 26               # feature columns per position
    CANDIDATE_WINDOW_SIZE = 32      # window is CANDIDATE_WINDOW_SIZE+1 = 33 positions
    TOTAL_LABELS = 28               # base-pair labels (RR..##)
    TOTAL_TYPE_LABELS = 3           # HOM-REF / HET / HOM-ALT
    MIN_SEQUENCE_LENGTH = 1000
    MAX_COLOR_VALUE = 125
    MIN_COLOR_VALUE = -125
    BASE_INDEX_START = 11           # clamp window [11, 25): reference quirk —
    BASE_INDEX_SIZE = 14            # columns 0-10 and 25 are NOT clamped.
    DECODED_LABELS = ["HOM-REF", "HET-ALT", "HOM-ALT"]
    DECODED_BASE_LABELS = ["RR", "RA", "RC", "RT", "RG", "R*", "R#", "AA", "AC",
                           "AT", "AG", "A*", "A#", "CC", "CT", "CG", "C*", "C#",
                           "TT", "TG", "T*", "T#", "GG", "G*", "G#", "**", "*#", "##"]
    COLUMN_NAMES = ["REFB", "SNPS", "INSS", "DELS", "REFF", "SNPF", "INSF", "DELF",
                    "AFRW", "CFRW", "GFRW", "TFRW", "IFRW", "DFRW", "*FRW",
                    "REFR", "SNPR", "INSR", "DELR",
                    "AREV", "CREV", "GREV", "TREV", "IREV", "DREV", "*REV"]


class ImageOptionsHP:
    """PEPPER-HP image geometry (reference Options.py:17-29, region_summary_hp.h)."""
    IMAGE_HEIGHT = 48
    CANDIDATE_WINDOW_SIZE = 20
    TOTAL_LABELS = 28
    TOTAL_TYPE_LABELS = 3
    SEQ_LENGTH = 1000
    SEQ_OVERLAP = 50


class PolishImageOptions:
    """Polishing pileup geometry (reference pepper/modules/python/Options.py)."""
    IMAGE_HEIGHT = 10
    SEQ_LENGTH = 1000
    SEQ_OVERLAP = 50
    LABEL_LENGTH = 1000
    TOTAL_LABELS = 5               # {*, A, C, G, T}
    MAX_COLOR_VALUE = 254
    MIN_IMAGE_OVERLAP = 100
    # the polish package's own read cap (pepper/modules/python/Options.py:28
    # — distinct from the variant side's 5000)
    MAX_READS_IN_REGION = 1500


class PolishTrainOptions:
    TRAIN_WINDOW = 100
    WINDOW_JUMP = 50
    GRU_LAYERS = 1
    HIDDEN_SIZE = 128


class TrainOptions:
    """Variant model training knobs (reference Options.py:83-90)."""
    TRAIN_WINDOW = 100
    WINDOW_JUMP = 50
    GRU_LAYERS = 1
    HIDDEN_SIZE = 256


class AlleleType:
    """candidate_finder.h:23-27."""
    SNP = 1
    INSERT = 2
    DELETE = 3


class Genotype:
    HOM = 0
    HET = 1
    HOM_ALT = 2


class VariantTypes:
    """region_summary.h:70-76."""
    HOM_REF = 0
    SNP = 1
    INSERT = 2
    DELETE = 3


class ReadFilterOptions:
    MIN_MAPQ = 5
    MIN_BASEQ = 1
    INCLUDE_SUPPLEMENTARY = False


class TruthFilterOptions:
    MIN_MAPQ = 60
    MIN_BASEQ = 0
    INCLUDE_SUPPLEMENTARY = True


class AlignerOptions:
    """Options.py:93-99 ('AlingerOptions' in the reference)."""
    ALIGNMENT_SAFE_BASES = 20
    MIN_MAP_QUALITY = 20
    MAX_READS_IN_REGION = 5000
    RANDOM_SEED = 2719747673


class ConsensCandidateFinder:
    REGION_SAFE_BASES = 100


class CandidateFinderOptions:
    """Candidate-finder constants (reference Options.py:44-80)."""
    MOST_ALLOWED_CANDIDATES_PER_SITE = 2
    SAFE_BASES = 20
    ALT_PROB_THRESHOLD = 0.1


@dataclass
class PipelineConfig:
    """Typed configuration mirroring the reference's argparse surface.

    Field names follow the reference flags (CallVariantsArguments.py) so the
    CLI maps 1:1. Platform presets (presets.py) fill any field left as None,
    reproducing SetParameters.py exactly.
    """
    # inputs / outputs
    bam: str = ""
    fasta: str = ""
    output_dir: str = ""
    model_path: Optional[str] = None
    use_hp_info: bool = False
    sample_name: str = "Sample"
    region: Optional[str] = None
    region_size: int = 100000
    region_bed: Optional[str] = None
    include_supplementary: bool = False
    threads: int = 1
    dry: bool = False

    # multi-host scale-out (parallel/multihost.py): regions striped across
    # hosts, candidates gathered via the shared output dir before the VCF
    num_hosts: Optional[int] = None
    host_id: Optional[int] = None
    coordinator_address: Optional[str] = None

    # image generation thresholds (filled by presets)
    downsample_rate: float = 1.0
    min_mapq: Optional[int] = None
    min_snp_baseq: Optional[int] = None
    min_indel_baseq: Optional[int] = None
    snp_frequency: Optional[float] = None
    insert_frequency: Optional[float] = None
    delete_frequency: Optional[float] = None
    min_coverage_threshold: Optional[int] = None
    candidate_support_threshold: Optional[int] = None
    snp_candidate_frequency_threshold: Optional[float] = None
    indel_candidate_frequency_threshold: Optional[float] = None
    skip_indels: bool = False

    # inference
    # streaming: fuse stage 1+2 (encode on host threads while the device
    # infers) — no file barrier between stages; see runtime/streaming.py.
    # Applies to non-dry call_variant runs; staged stages remain available
    # as standalone subcommands either way.
    streaming: bool = True
    keep_image_artifacts: bool = False
    # per-region resume journal (runtime/resume.py): a killed streamed run
    # resumes without re-encoding completed intervals; byte-identical VCFs
    resume: bool = True
    batch_size: int = 512
    num_workers: int = 0
    quantized: bool = False
    gpu: bool = False             # accepted for CLI parity; see `device`
    # torch device of the model forward: "cuda" (default) or "cpu". "cuda"
    # with no CUDA device raises; it never carries on on the CPU
    device: str = "cuda"
    device_ids: Optional[str] = None
    callers_per_gpu: int = 4

    # candidate finding (filled by presets)
    allowed_multiallelics: Optional[int] = None
    snp_p_value: Optional[float] = None
    insert_p_value: Optional[float] = None
    delete_p_value: Optional[float] = None
    snp_p_value_in_lc: Optional[float] = None
    insert_p_value_in_lc: Optional[float] = None
    delete_p_value_in_lc: Optional[float] = None
    snp_q_cutoff: Optional[int] = None
    indel_q_cutoff: Optional[int] = None
    snp_q_cutoff_in_lc: Optional[int] = None
    indel_q_cutoff_in_lc: Optional[int] = None
    report_snp_above_freq: Optional[float] = None
    report_indel_above_freq: Optional[float] = None

    # training
    train_mode: bool = False
    truth_vcf: Optional[str] = None
    random_draw_probability: float = 0.33

    # platform preset flags
    ont_r9_guppy5_sup: bool = False
    ont_r9_guppy4_hac: bool = False
    ont_r10_q20: bool = False
    hifi: bool = False
    clr: bool = False

    # internal
    sub_command: str = "call_variant"
    image_output_directory: str = ""

    def require(self, *names: str) -> None:
        missing = [n for n in names if getattr(self, n) is None]
        if missing:
            raise ValueError(
                f"Config fields {missing} are unset; pick a platform preset "
                f"(--ont_r9_guppy5_sup/--ont_r9_guppy4_hac/--ont_r10_q20/--hifi/--clr) "
                f"or set them explicitly.")
