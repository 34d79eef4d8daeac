"""Platform presets — parity with reference SetParameters.py.

Each preset is a pair of dicts: image-generation thresholds (applied for
sub-commands call_variant/make_images/make_train_images) and candidate-finding
thresholds (call_variant/find_candidates). Values transcribed from
`pepper_variant/modules/argparse/SetParameters.py:12-283`.
"""
import sys
from pepper_tpu_torch.options import PipelineConfig

_IMAGE_CMDS = ("call_variant", "make_images", "make_train_images")
_CANDIDATE_CMDS = ("call_variant", "find_candidates")

PRESETS = {
    "ont_r9_guppy5_sup": {
        "image": dict(min_mapq=5, min_snp_baseq=1, min_indel_baseq=1,
                      snp_frequency=0.10, insert_frequency=0.15, delete_frequency=0.15,
                      min_coverage_threshold=3, candidate_support_threshold=2,
                      snp_candidate_frequency_threshold=0.10,
                      indel_candidate_frequency_threshold=0.10, skip_indels=False),
        "candidate": dict(allowed_multiallelics=4,
                          snp_p_value=0.1, insert_p_value=0.1, delete_p_value=0.1,
                          snp_q_cutoff=20, indel_q_cutoff=15,
                          report_snp_above_freq=0, report_indel_above_freq=0,
                          snp_p_value_in_lc=0.1, insert_p_value_in_lc=0.15,
                          delete_p_value_in_lc=0.1,
                          snp_q_cutoff_in_lc=20, indel_q_cutoff_in_lc=10),
    },
    "ont_r9_guppy4_hac": {
        "image": dict(min_mapq=5, min_snp_baseq=1, min_indel_baseq=1,
                      snp_frequency=0.10, insert_frequency=0.12, delete_frequency=0.12,
                      min_coverage_threshold=3, candidate_support_threshold=2,
                      snp_candidate_frequency_threshold=0.10,
                      indel_candidate_frequency_threshold=0.10, skip_indels=False),
        "candidate": dict(allowed_multiallelics=4,
                          snp_p_value=0.10, insert_p_value=0.25, delete_p_value=0.25,
                          snp_q_cutoff=20, indel_q_cutoff=15,
                          report_snp_above_freq=0, report_indel_above_freq=0,
                          snp_p_value_in_lc=0.05, insert_p_value_in_lc=0.01,
                          delete_p_value_in_lc=0.01,
                          snp_q_cutoff_in_lc=20, indel_q_cutoff_in_lc=10),
    },
    "ont_r10_q20": {
        "image": dict(min_mapq=1, min_snp_baseq=1, min_indel_baseq=1,
                      snp_frequency=0.1, insert_frequency=0.1, delete_frequency=0.1,
                      min_coverage_threshold=3, candidate_support_threshold=2,
                      snp_candidate_frequency_threshold=0.10,
                      indel_candidate_frequency_threshold=0.10, skip_indels=False),
        "candidate": dict(allowed_multiallelics=4,
                          snp_p_value=0.00001, insert_p_value=0.001, delete_p_value=0.001,
                          snp_q_cutoff=15, indel_q_cutoff=30,
                          report_snp_above_freq=0, report_indel_above_freq=0,
                          snp_p_value_in_lc=0.000001, insert_p_value_in_lc=0.001,
                          delete_p_value_in_lc=0.001,
                          snp_q_cutoff_in_lc=20, indel_q_cutoff_in_lc=35),
    },
    "hifi": {
        "image": dict(min_mapq=5, min_snp_baseq=10, min_indel_baseq=10,
                      snp_frequency=0.10, insert_frequency=0.12, delete_frequency=0.10,
                      min_coverage_threshold=2, candidate_support_threshold=2,
                      snp_candidate_frequency_threshold=0.10,
                      indel_candidate_frequency_threshold=0.10, skip_indels=False),
        "candidate": dict(allowed_multiallelics=4,
                          snp_p_value=0, insert_p_value=0, delete_p_value=0,
                          snp_q_cutoff=15, indel_q_cutoff=20,
                          report_snp_above_freq=0, report_indel_above_freq=0,
                          snp_p_value_in_lc=0, insert_p_value_in_lc=0,
                          delete_p_value_in_lc=0,
                          snp_q_cutoff_in_lc=15, indel_q_cutoff_in_lc=20),
    },
    "clr": {
        "image": dict(min_mapq=5, min_snp_baseq=0, min_indel_baseq=0,
                      snp_frequency=0.10, insert_frequency=0.12, delete_frequency=0.12,
                      min_coverage_threshold=3, candidate_support_threshold=2,
                      snp_candidate_frequency_threshold=0.10,
                      indel_candidate_frequency_threshold=0.12, skip_indels=True),
        "candidate": dict(allowed_multiallelics=4,
                          snp_p_value=0.1, insert_p_value=0.2, delete_p_value=0.2,
                          snp_q_cutoff=20, indel_q_cutoff=20,
                          report_snp_above_freq=0, report_indel_above_freq=0,
                          snp_p_value_in_lc=0.05, insert_p_value_in_lc=0.05,
                          delete_p_value_in_lc=0.05,
                          snp_q_cutoff_in_lc=20, indel_q_cutoff_in_lc=20),
    },
}


def set_parameters(options: PipelineConfig) -> PipelineConfig:
    """Fill None fields from the selected platform preset.

    Mirrors reference SetParameters.py:5-322 including the quirk that
    skip_indels is only forced by the preset when currently False (the
    reference uses `if not options.skip_indels: options.skip_indels = X`).
    """
    selected = None
    for name in ("ont_r9_guppy5_sup", "ont_r9_guppy4_hac", "ont_r10_q20", "hifi", "clr"):
        if getattr(options, name):
            selected = name
            break
    if selected is None:
        return options

    preset = PRESETS[selected]
    if options.sub_command in _IMAGE_CMDS:
        for key, value in preset["image"].items():
            if key == "skip_indels":
                if not options.skip_indels:
                    options.skip_indels = value
            elif getattr(options, key) is None:
                setattr(options, key, value)
    if options.sub_command in _CANDIDATE_CMDS:
        for key, value in preset["candidate"].items():
            if getattr(options, key) is None:
                setattr(options, key, value)
    return options
