"""`pepper_variant_train` CLI of the PyTorch port — training-side
subcommands (reference pepper_variant/pepper_variant_train.py:308-347:
make_train_images, train_model, test_model, backend_stat). The model runs
on `--device` (cuda by default; cuda with no CUDA device raises).

train_model joins a torch.distributed group first when `torchrun` started
it (parallel/multihost.py), so

    torchrun --nproc_per_node N -m pepper_tpu_torch.cli.pepper_variant_train_main train_model ...

trains data parallel, one rank per card (`-bs` is the global batch)."""
import argparse
import sys

from pepper_tpu_torch.cli.pepper_variant_main import (_add_common_io,
                                                      _add_image_thresholds,
                                                      _add_platform_presets,
                                                      config_from_args)
from pepper_tpu_torch.version import __version__


def _add_device(p):
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device of the model (default cuda; cuda with no "
                        "CUDA device is an error).")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pepper_variant_train",
        description="Train the variant-calling model (PyTorch/CUDA).")
    parser.add_argument("--version", action="version",
                        version="pepper_tpu_torch " + __version__)
    sub = parser.add_subparsers(dest="sub_command", required=True)

    mi = sub.add_parser("make_train_images",
                        help="Generate labeled candidate images.")
    for add in (_add_common_io, _add_image_thresholds, _add_platform_presets):
        add(mi)
    mi.add_argument("-tv", "--truth_vcf", required=True,
                    help="Truth VCF (PASS records label the images).")
    mi.add_argument("-p", "--random_draw_probability", type=float,
                    default=0.33,
                    help="Probability of keeping a hom-ref example.")

    tm = sub.add_parser("train_model", help="Train the genotype classifier.")
    tm.add_argument("--train_image_dir", required=True)
    tm.add_argument("--test_image_dir", required=True)
    tm.add_argument("-o", "--model_out_dir", required=True)
    tm.add_argument("-bs", "--batch_size", type=int, default=64)
    tm.add_argument("--epoch_size", type=int, default=10)
    tm.add_argument("--step_size", type=int, default=100)
    tm.add_argument("-lr", "--learning_rate", type=float, default=0.0001)
    tm.add_argument("-wd", "--weight_decay", type=float, default=0.000001)
    tm.add_argument("--retrain_model_path", default=None)
    _add_device(tm)

    te = sub.add_parser("test_model", help="Evaluate a trained model.")
    te.add_argument("--test_image_dir", required=True)
    te.add_argument("-m", "--model_path", required=True)
    te.add_argument("-bs", "--batch_size", type=int, default=512)
    _add_device(te)

    sub.add_parser("backend_stat",
                   help="Print the torch/CUDA configuration.")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sub_command == "make_train_images":
        import os
        config = config_from_args(args)
        config.train_mode = True
        config.truth_vcf = args.truth_vcf
        config.random_draw_probability = args.random_draw_probability
        config.require("min_mapq", "min_snp_baseq", "snp_frequency")
        config.image_output_directory = os.path.join(config.output_dir, "")
        from pepper_tpu_torch.pipelines.make_images import generate_images
        generate_images(config)
    elif args.sub_command == "train_model":
        from pepper_tpu_torch.parallel import multihost
        from pepper_tpu_torch.train.variant_train import train
        multihost.initialize(backend=multihost.default_backend(args.device))
        best = train(args.train_image_dir, args.test_image_dir,
                     args.model_out_dir, batch_size=args.batch_size,
                     epoch_limit=args.epoch_size, step_size=args.step_size,
                     lr=args.learning_rate, weight_decay=args.weight_decay,
                     retrain_model_path=args.retrain_model_path,
                     device=args.device)
        print(best)
    elif args.sub_command == "test_model":
        import numpy as np

        from pepper_tpu_torch.models.checkpoint import params_from_jax
        from pepper_tpu_torch.runtime.inference import (_load_model_params,
                                                        load_all_summaries)
        from pepper_tpu_torch.runtime.streaming import resolve_device
        from pepper_tpu_torch.train.variant_train import confusion_and_accuracy
        params = params_from_jax(_load_model_params(args.model_path),
                                 resolve_device(args.device))
        data = load_all_summaries(args.test_image_dir, train_mode=True)
        if data is None or "type_label" not in data:
            sys.stderr.write("ERROR: no labeled images found.\n")
            return 1
        cm, accuracy = confusion_and_accuracy(
            params, data["images"], data["type_label"].astype(np.int64),
            batch_size=args.batch_size)
        print("Confusion matrix [true x predicted]:")
        print(cm)
        print(f"Accuracy: {accuracy:.4f}")
    elif args.sub_command == "backend_stat":
        import torch
        print(f"torch version: {torch.__version__}")
        print(f"cuda version: {torch.version.cuda}")
        print(f"cuda available: {torch.cuda.is_available()}")
        for i in range(torch.cuda.device_count()):
            print(f"device {i}: {torch.cuda.get_device_name(i)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
