"""Multi-device dry run of the port at production widths.

The port's counterpart of `__graft_entry__.py::dryrun_multichip`: over a
mesh of n entries (parallel/mesh.py) it runs

* one train step of the full-width classifier (hidden 256, 33x26), the
  batch split over n in-process replicas (`variant_train.make_train_step`
  over a list of replicas: their gradients are summed in one flat buffer
  in mesh order, as the all-reduce sums them across ranks);
* sharded inference through `DeviceRunner` at 33x26 and at the HP
  geometry 21x48;
* the sharded polish vote function (hidden 128) on [B,1000,10] uint8.

It checks finite outputs of the expected shapes, and that the replicas
hold identical parameters after the step.

    python -m pepper_tpu_torch.parallel.dryrun 8 --device cpu
"""
import argparse
import json
import sys

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run over n_devices mesh entries: the cards of `device`
    ("cuda" every visible card, "cuda:N" one) taken in turn, or n CPU
    entries for "cpu". Returns the step's loss and the output shapes."""
    from pepper_tpu_torch.models.polish_model import init_polish_params
    from pepper_tpu_torch.models.variant_model import init_variant_params
    from pepper_tpu_torch.options import ImageOptionsHP
    from pepper_tpu_torch.parallel.mesh import mesh_for
    from pepper_tpu_torch.polish.consensus import make_window_vote_fn
    from pepper_tpu_torch.runtime.streaming import DeviceRunner
    from pepper_tpu_torch.train import variant_train as vt

    cards = mesh_for(device)
    mesh = [cards[i % len(cards)] for i in range(n_devices)]
    batch = 2 * n_devices

    # the data-parallel train step, replicas in process
    tree = init_variant_params(torch.Generator().manual_seed(0))
    replicas = [vt.trainable(tree, dev) for dev in mesh]
    optimizers = [vt.make_optimizer(p, 1e-4, 1e-6) for p in replicas]
    images = np.random.RandomState(0).randn(batch, 33, 26).astype(np.float32)
    labels = np.zeros(batch, np.int64)
    total = vt.make_train_step(replicas, optimizers)(images, labels)
    loss = float(total)
    if not np.isfinite(loss):
        raise RuntimeError("non-finite loss in the dry run's train step")
    first = dict(vt.sorted_leaves(replicas[0]))
    for params in replicas[1:]:
        for key, p in vt.sorted_leaves(params):
            if not torch.equal(p.detach().to(mesh[0]), first[key].detach()):
                raise RuntimeError(f"replicas disagree on {key} after the "
                                   f"dry run's train step")
    del replicas, optimizers, first

    # sharded inference, the base and the HP geometry
    shapes = {}
    rng = np.random.RandomState(1)
    hp_window = ImageOptionsHP.CANDIDATE_WINDOW_SIZE + 1
    for name, window, features in (("base", 33, 26),
                                   ("hp", hp_window,
                                    ImageOptionsHP.IMAGE_HEIGHT)):
        runner = DeviceRunner(init_variant_params(
            torch.Generator().manual_seed(3), image_features=features,
            window=window), batch, mesh)
        x8 = torch.from_numpy(rng.randint(
            -125, 126, (batch, window, features)).astype(np.int8))
        probs = runner.forward(x8.to(mesh[0]))
        if tuple(probs.shape) != (batch, 3) \
                or not bool(torch.isfinite(probs).all()):
            raise RuntimeError(f"sharded {name} inference gave "
                               f"{tuple(probs.shape)} or non-finite probs")
        shapes[name] = list(probs.shape)
        del runner

    # the sharded polish vote function
    dtype = torch.bfloat16 if mesh[0].type == "cuda" else torch.float32
    vote = make_window_vote_fn(init_polish_params(
        torch.Generator().manual_seed(2)), mesh[0], dtype, mesh=mesh)
    images8 = torch.from_numpy(np.random.RandomState(2).randint(
        0, 255, (batch, 1000, 10)).astype(np.uint8))
    base_labels, phred = vote(images8.to(mesh[0]))
    if tuple(base_labels.shape) != (batch, 1000) \
            or not bool(torch.isfinite(phred).all()):
        raise RuntimeError(f"sharded polish vote gave "
                           f"{tuple(base_labels.shape)} or non-finite phred")
    shapes["polish"] = list(base_labels.shape)
    return {"mesh": [str(d) for d in mesh], "loss": loss, "shapes": shapes}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Multi-device dry run of the PyTorch port.")
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda",
                        help="cuda (every visible card), cuda:N or cpu")
    args = parser.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n_devices, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
