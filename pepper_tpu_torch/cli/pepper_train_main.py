"""`pepper_train` CLI of the PyTorch port — polishing-model training
(reference pepper/pepper_train.py:286-345: make_train_images, train_model,
test_model, run_hyperband). The model runs on `--device` (cuda by default;
cuda with no CUDA device raises).

train_model joins a torch.distributed group first when `torchrun` started
it (parallel/multihost.py), so

    torchrun --nproc_per_node N -m pepper_tpu_torch.cli.pepper_train_main train_model ...

trains data parallel, one rank per card (`-bs` is the global batch)."""
import argparse
import sys

from pepper_tpu_torch.version import __version__


def _add_device(p):
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device of the model (default cuda; cuda with no "
                        "CUDA device is an error).")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pepper_train",
        description="Train the polishing model (PyTorch/CUDA).")
    parser.add_argument("--version", action="version",
                        version="pepper_tpu_torch " + __version__)
    sub = parser.add_subparsers(dest="sub_command", required=True)

    mi = sub.add_parser("make_train_images",
                        help="Generate labeled pileup images.")
    mi.add_argument("-b", "--bam", required=True,
                    help="Reads-to-draft alignment BAM.")
    mi.add_argument("-f", "--fasta", required=True, help="Draft FASTA.")
    mi.add_argument("-tb", "--truth_bam", required=True,
                    help="Truth-to-draft alignment BAM.")
    mi.add_argument("-o", "--output_dir", required=True)
    mi.add_argument("-t", "--threads", type=int, default=1)
    mi.add_argument("-r", "--region", default=None)
    mi.add_argument("-d", "--downsample_rate", type=float, default=1.0)
    mi.add_argument("--no_realignment", action="store_true", default=False)

    tm = sub.add_parser("train_model", help="Train the consensus GRU.")
    tm.add_argument("--train_image_dir", required=True)
    tm.add_argument("--test_image_dir", required=True)
    tm.add_argument("-o", "--model_out_dir", required=True)
    tm.add_argument("-bs", "--batch_size", type=int, default=64)
    tm.add_argument("--epoch_size", type=int, default=10)
    tm.add_argument("-lr", "--learning_rate", type=float, default=0.0001)
    tm.add_argument("-wd", "--weight_decay", type=float, default=0.000001)
    tm.add_argument("--retrain_model_path", default=None)
    _add_device(tm)

    te = sub.add_parser("test_model", help="Evaluate a polish model.")
    te.add_argument("--test_image_dir", required=True)
    te.add_argument("-m", "--model_path", required=True)
    te.add_argument("-bs", "--batch_size", type=int, default=64)
    _add_device(te)

    hb = sub.add_parser("run_hyperband",
                        help="Hyperband search over lr/weight decay.")
    hb.add_argument("--train_image_dir", required=True)
    hb.add_argument("--test_image_dir", required=True)
    hb.add_argument("-o", "--output_dir", required=True)
    hb.add_argument("--max_epochs", type=int, default=9)
    hb.add_argument("--eta", type=int, default=3)
    _add_device(hb)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sub_command == "make_train_images":
        from pepper_tpu_torch.polish.make_images import generate_polish_images
        generate_polish_images(
            args.bam, args.fasta, args.output_dir, region=args.region,
            threads=args.threads, train_mode=True, truth_bam=args.truth_bam,
            downsample_rate=args.downsample_rate,
            realignment_flag=not args.no_realignment)
    elif args.sub_command == "train_model":
        from pepper_tpu_torch.parallel import multihost
        from pepper_tpu_torch.train.polish_train import train_polish
        multihost.initialize(backend=multihost.default_backend(args.device))
        best = train_polish(args.train_image_dir, args.test_image_dir,
                            args.model_out_dir, batch_size=args.batch_size,
                            epoch_limit=args.epoch_size,
                            lr=args.learning_rate,
                            weight_decay=args.weight_decay,
                            retrain_model_path=args.retrain_model_path,
                            device=args.device)
        print(best)
    elif args.sub_command == "test_model":
        from pepper_tpu_torch.models.checkpoint import params_from_jax
        from pepper_tpu_torch.runtime.inference import _load_model_params
        from pepper_tpu_torch.runtime.streaming import resolve_device
        from pepper_tpu_torch.train.polish_train import (
            load_polish_training_data, polish_accuracy)
        device = resolve_device(args.device)
        params = params_from_jax(_load_model_params(args.model_path), device)
        images, labels = load_polish_training_data(args.test_image_dir)
        if images is None:
            sys.stderr.write("ERROR: no labeled images found.\n")
            return 1
        cm, accuracy = polish_accuracy(params, images, labels,
                                       batch_size=args.batch_size)
        print("Confusion matrix [true x predicted]:")
        print(cm)
        print(f"Accuracy: {accuracy:.4f}")
    elif args.sub_command == "run_hyperband":
        from pepper_tpu_torch.train.hyperband import run_hyperband
        best = run_hyperband(args.train_image_dir, args.test_image_dir,
                             args.output_dir, max_epochs=args.max_epochs,
                             eta=args.eta, device=args.device)
        print(best)
    return 0


if __name__ == "__main__":
    sys.exit(main())
