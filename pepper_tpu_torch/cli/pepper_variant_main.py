"""`pepper_variant` CLI of the PyTorch port — flag parity with the
reference's argparse surface.

Subcommands (reference pepper_variant/pepper_variant.py:37-55):
  call_variant, make_images, run_inference, find_candidates, merge_variants.
Platform presets fill unset thresholds exactly as SetParameters.py does.
The model runs on `--device` (cuda by default; cuda with no CUDA device
raises).
"""
import argparse
import sys

from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.version import __version__


def _add_common_io(p):
    p.add_argument("-b", "--bam", required=True,
                   help="Alignment containing mapping between reads and the reference.")
    p.add_argument("-f", "--fasta", required=True,
                   help="The reference FASTA file (with .fai index).")
    p.add_argument("-o", "--output_dir", required=True, help="Output directory.")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="Number of host worker processes.")
    p.add_argument("-r", "--region", default=None,
                   help="Region in contig:start-end format (or contig list).")
    p.add_argument("--region_size", type=int, default=100000,
                   help="Region size to chunk the genome (default 100000).")
    p.add_argument("--region_bed", default=None,
                   help="Only process regions in this BED.")
    p.add_argument("-s", "--sample_name", default="Sample",
                   help="Sample name in output VCFs.")
    p.add_argument("--include_supplementary", action="store_true", default=False)
    p.add_argument("--downsample_rate", type=float, default=1.0)


def _add_image_thresholds(p):
    p.add_argument("--min_mapq", type=int, default=None)
    p.add_argument("--min_snp_baseq", type=int, default=None)
    p.add_argument("--min_indel_baseq", type=int, default=None)
    p.add_argument("--snp_frequency", type=float, default=None)
    p.add_argument("--insert_frequency", type=float, default=None)
    p.add_argument("--delete_frequency", type=float, default=None)
    p.add_argument("--min_coverage_threshold", type=int, default=None)
    p.add_argument("--candidate_support_threshold", type=int, default=None)
    p.add_argument("--snp_candidate_frequency_threshold", type=float, default=None)
    p.add_argument("--indel_candidate_frequency_threshold", type=float, default=None)
    p.add_argument("--skip_indels", action="store_true", default=False)
    p.add_argument("--use_hp_info", action="store_true", default=False)


def _add_inference(p):
    p.add_argument("-bs", "--batch_size", type=int, default=512)
    p.add_argument("--no_streaming", dest="streaming", action="store_false",
                   default=True,
                   help="Disable the fused encode+inference stream; run "
                        "staged stage 1 then stage 2 with a file barrier.")
    p.add_argument("--keep_image_artifacts", action="store_true",
                   default=False,
                   help="In streaming mode, also write the stage-1 image "
                        "HDF5s (as artifacts, not a barrier).")
    p.add_argument("--no_resume", dest="resume", action="store_false",
                   default=True,
                   help="Disable the per-region resume journal (a killed "
                        "streamed run then restarts from scratch).")
    p.add_argument("--dry", action="store_true", default=False,
                   help="Oracle backend: emit labels as predictions (pipeline test).")
    p.add_argument("-m", "--model_path", default=None,
                   help="Model checkpoint (.npz native or torch .pkl).")
    p.add_argument("-w", "--num_workers", type=int, default=0)
    p.add_argument("-g", "--gpu", action="store_true", default=False,
                   help="Accepted for CLI parity; --device selects the device.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device of the model forward (default cuda; cuda "
                        "with no CUDA device is an error).")
    p.add_argument("--quantized", dest="quantized", action="store_true", default=False)
    p.add_argument("--no_quantized", dest="quantized", action="store_false")
    p.add_argument("-d_ids", "--device_ids", default=None)
    p.add_argument("--callers_per_gpu", type=int, default=4)


def _add_candidate_thresholds(p):
    p.add_argument("--allowed_multiallelics", type=int, default=None)
    p.add_argument("--snp_p_value", type=float, default=None)
    p.add_argument("--insert_p_value", type=float, default=None)
    p.add_argument("--delete_p_value", type=float, default=None)
    p.add_argument("--snp_p_value_in_lc", type=float, default=None)
    p.add_argument("--insert_p_value_in_lc", type=float, default=None)
    p.add_argument("--delete_p_value_in_lc", type=float, default=None)
    p.add_argument("--snp_q_cutoff", type=float, default=None)
    p.add_argument("--indel_q_cutoff", type=float, default=None)
    p.add_argument("--snp_q_cutoff_in_lc", type=float, default=None)
    p.add_argument("--indel_q_cutoff_in_lc", type=float, default=None)
    p.add_argument("--report_snp_above_freq", type=float, default=None)
    p.add_argument("--report_indel_above_freq", type=float, default=None)


def _add_multihost(p):
    p.add_argument("--num_hosts", type=int, default=None,
                   help="Total hosts sharing this run (regions are striped "
                        "across hosts; host 0 assembles the global VCF).")
    p.add_argument("--host_id", type=int, default=None,
                   help="This host's index in [0, num_hosts).")
    p.add_argument("--coordinator_address", default=None,
                   help="torch.distributed coordinator (host:port of the "
                        "rank-0 host); with --num_hosts and --host_id as "
                        "the world size and rank. Without it, --num_hosts "
                        "selects filesystem mode (no rendezvous; the hosts "
                        "share the output directory).")


def _add_platform_presets(p):
    g = p.add_mutually_exclusive_group()
    g.add_argument("--ont_r9_guppy5_sup", action="store_true", default=False,
                   help="Preset: ONT R9.4.1 Guppy 5+ sup basecaller.")
    g.add_argument("--ont_r9_guppy4_hac", action="store_true", default=False,
                   help="Preset: ONT R9.4.1 Guppy 4.x hac basecaller.")
    g.add_argument("--ont_r10_q20", action="store_true", default=False,
                   help="Preset: ONT R10.4 Q20.")
    g.add_argument("--hifi", action="store_true", default=False,
                   help="Preset: PacBio HiFi.")
    g.add_argument("--clr", action="store_true", default=False,
                   help="Preset: PacBio CLR.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pepper_variant",
        description="Long-read variant calling (PyTorch/CUDA).")
    parser.add_argument("--version", action="version",
                        version="pepper_tpu_torch " + __version__)
    sub = parser.add_subparsers(dest="sub_command", required=True)

    cv = sub.add_parser("call_variant", help="Run the full 3-stage pipeline.")
    for add in (_add_common_io, _add_image_thresholds, _add_inference,
                _add_candidate_thresholds, _add_platform_presets,
                _add_multihost):
        add(cv)

    mi = sub.add_parser("make_images", help="Stage 1: candidate images.")
    for add in (_add_common_io, _add_image_thresholds, _add_platform_presets,
                _add_multihost):
        add(mi)

    ri = sub.add_parser("run_inference", help="Stage 2: model inference.")
    ri.add_argument("-i", "--image_dir", required=True)
    ri.add_argument("-o", "--output_dir", required=True)
    ri.add_argument("-t", "--threads", type=int, default=1)
    ri.add_argument("--use_hp_info", action="store_true", default=False)
    _add_inference(ri)
    _add_multihost(ri)

    fc = sub.add_parser("find_candidates", help="Stage 3: candidates -> VCFs.")
    fc.add_argument("-i", "--input_dir", required=True,
                    help="Directory containing prediction files.")
    fc.add_argument("-f", "--fasta", required=True)
    fc.add_argument("-o", "--output_dir", required=True)
    fc.add_argument("-t", "--threads", type=int, default=1)
    fc.add_argument("-s", "--sample_name", default="Sample")
    fc.add_argument("--use_hp_info", action="store_true", default=False)
    _add_candidate_thresholds(fc)
    _add_platform_presets(fc)
    _add_multihost(fc)

    mv = sub.add_parser("merge_variants",
                        help="Merge PEPPER and DeepVariant VCFs.")
    mv.add_argument("-vp", "--vcf_pepper", required=True)
    mv.add_argument("-vd", "--vcf_deepvariant", default=None)
    mv.add_argument("-vds", "--vcf_deepvariant_snps", default=None)
    mv.add_argument("-vdi", "--vcf_deepvariant_indels", default=None)
    mv.add_argument("-o", "--output_dir", required=True)
    mv.add_argument("-s", "--sample_name", default="Sample")
    return parser


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    config = PipelineConfig()
    for key, value in vars(args).items():
        if hasattr(config, key):
            setattr(config, key, value)
    config.train_mode = False  # forced off (pepper_variant.py:60-62)
    return set_parameters(config)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    if args.sub_command != "merge_variants":
        from pepper_tpu_torch.parallel import multihost
        multihost.initialize_from_config(config)

    if args.sub_command == "call_variant":
        config.require("min_mapq", "min_snp_baseq", "snp_frequency",
                       "allowed_multiallelics", "snp_p_value")
        from pepper_tpu_torch.pipelines.call_variant import call_variant
        call_variant(config)
    elif args.sub_command == "make_images":
        config.require("min_mapq", "min_snp_baseq", "snp_frequency")
        import os
        config.image_output_directory = os.path.join(config.output_dir, "")
        from pepper_tpu_torch.pipelines.make_images import generate_images
        generate_images(config)
    elif args.sub_command == "run_inference":
        # standalone stage run on a shared image dir: stripe files by host
        from pepper_tpu_torch.runtime.inference import run_inference
        run_inference(config, args.image_dir, args.output_dir,
                      shard_files_by_host=True)
    elif args.sub_command == "find_candidates":
        # standalone stage run on a shared prediction dir: stripe batches
        config.require("allowed_multiallelics", "snp_p_value")
        from pepper_tpu_torch.pipelines.find_candidates import process_candidates
        process_candidates(config, args.input_dir, args.output_dir,
                           shard_batches_by_host=True)
    elif args.sub_command == "merge_variants":
        from pepper_tpu_torch.pipelines.merge_variants import merge_variants
        merge_variants(args.vcf_pepper, args.vcf_deepvariant,
                       args.vcf_deepvariant_snps, args.vcf_deepvariant_indels,
                       args.output_dir, args.sample_name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
