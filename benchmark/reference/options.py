# Frozen copy of the constants of pepper_tpu_torch/options.py at commit
# d27cce3 that the plain encoder and the candidate gates read.
"""Image geometry and encoder constants (reference Options.py)."""


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
    DECODED_BASE_LABELS = ["RR", "RA", "RC", "RT", "RG", "R*", "R#", "AA", "AC",
                           "AT", "AG", "A*", "A#", "CC", "CT", "CG", "C*", "C#",
                           "TT", "TG", "T*", "T#", "GG", "G*", "G#", "**", "*#", "##"]


class AlleleType:
    """candidate_finder.h:23-27."""
    SNP = 1
    INSERT = 2
    DELETE = 3


class VariantTypes:
    """region_summary.h:70-76."""
    HOM_REF = 0
    SNP = 1
    INSERT = 2
    DELETE = 3


class AlignerOptions:
    """Options.py:93-99 ('AlingerOptions' in the reference)."""
    MAX_READS_IN_REGION = 5000
    RANDOM_SEED = 2719747673


REGION_SAFE_BASES = 100             # ConsensCandidateFinder.REGION_SAFE_BASES
