"""The port's variant trainer (pepper_tpu_torch/train/variant_train.py)
against the JAX package's, on the same numpy inputs and weights, in f32 on
the CPU, at small widths (hidden 8, short windows).

The JAX step runs `make_train_step(fused_rnn=False)` (autodiff through the
scan) with dropout off (`rng=None`): dropout masks come from each
framework's own generator and cannot match. torch is pinned to one thread:
with several test workers the plain loops' tiny ops otherwise stall at
OpenMP barriers.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models import checkpoint as jax_ckpt
from pepper_tpu.models.variant_model import variant_forward as jax_forward
from pepper_tpu.train import variant_train as jax_vt
from pepper_tpu_torch.models import checkpoint as ckpt
from pepper_tpu_torch.models import variant_model as vm
from pepper_tpu_torch.train import variant_train as vt
from pepper_tpu_torch.train.dataloader import ShuffleBufferLoader


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain recurrences issue thousands of tiny ops. With several
    test workers on one host, torch's intra-op thread pool then spends far
    more time waiting at its barriers than computing; one thread per worker
    keeps the file's run time the same under load as alone. Set for this
    file's tests only: a process-wide setting at import would reach every
    file the worker collects."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


T, F, HID = 9, 12, 8


def _tree(seed, window=T, features=F, hidden=HID):
    """Seeded classifier parameters as a numpy tree."""
    params = vm.init_variant_params(torch.Generator().manual_seed(seed),
                                    image_features=features, window=window,
                                    hidden=hidden)
    return {g: {k: v.numpy() for k, v in leaves.items()}
            for g, leaves in params.items()}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _images(rng, n, window=T, features=F):
    x = rng.integers(-125, 126, (n, window, features))
    x[rng.random(x.shape) < 0.6] = 0
    return x.astype(np.int8)


def _flat(tree):
    return dict(vt.sorted_leaves(tree))


def test_cross_entropy_sum_matches_jax_and_torch():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((8, 3)).astype(np.float32)
    labels = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    got = vt.cross_entropy_sum(torch.from_numpy(logits),
                               torch.from_numpy(labels)).item()
    want = float(jax_vt.cross_entropy_sum(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    ref = torch.nn.CrossEntropyLoss(reduction="sum")(
        torch.from_numpy(logits), torch.from_numpy(labels)).item()
    assert abs(got - want) < 1e-5 and abs(got - ref) < 1e-5


def test_reduce_lr_on_plateau_matches_jax():
    metrics = [50.0, 49.0, 49.0, 49.0, 51.0, 50.0, 50.0, 50.0, 50.0, 50.0,
               50.0, 52.0]
    ours = vt.ReduceLROnPlateau(1e-4, patience=2, min_lr=0.75e-4)
    theirs = jax_vt.ReduceLROnPlateau(1e-4, patience=2, min_lr=0.75e-4)
    got = [ours.step(m) for m in metrics]
    assert got == [theirs.step(m) for m in metrics]
    assert got[2] == 1e-4 and got[3] == pytest.approx(0.75e-4)
    deep = vt.ReduceLROnPlateau(1.0, patience=0)
    assert [deep.step(m) for m in (1.0, 0.0, 0.0)] == [
        1.0, pytest.approx(0.1), pytest.approx(0.01)]


def test_confusion_and_accuracy_matches_jax():
    rng = np.random.default_rng(1)
    tree = _tree(1)
    images = _images(rng, 37)
    labels = rng.integers(0, 3, 37)
    cm, acc = vt.confusion_and_accuracy(vt.trainable(tree, "cpu"), images,
                                        labels, batch_size=16)
    want_cm, want_acc = jax_vt.confusion_and_accuracy(
        _jax_tree(tree), images, labels, batch_size=16)
    assert cm.sum() == 37 and np.array_equal(cm, want_cm)
    assert acc == pytest.approx(want_acc)


def test_train_mode_logits_match_jax():
    rng = np.random.default_rng(2)
    tree = _tree(2)
    x = _images(rng, 6).astype(np.float32)
    want = np.asarray(jax_forward(_jax_tree(tree), jnp.asarray(x),
                                  train_mode=True, dropout_rng=None,
                                  fused_rnn=False))
    params = ckpt.params_from_jax(tree)
    got = vm.variant_forward(params, torch.from_numpy(x), train_mode=True)
    assert got.shape == (6, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the inference forward is the softmax of the same logits
    probs = vm.variant_forward(params, torch.from_numpy(x))
    np.testing.assert_allclose(probs.numpy(),
                               torch.softmax(got, -1).numpy(), atol=1e-6)


def test_step_one_gradients_match_jax():
    rng = np.random.default_rng(3)
    tree = _tree(3)
    x = _images(rng, 16)
    y = rng.integers(0, 3, 16)

    def loss_fn(p):
        logits = jax_forward(p, jnp.asarray(x.astype(np.float32)),
                             train_mode=True, fused_rnn=False)
        return jax_vt.cross_entropy_sum(logits, jnp.asarray(y))

    want_loss, want = jax.value_and_grad(loss_fn)(_jax_tree(tree))
    params = vt.trainable(tree, "cpu")
    loss = vt.cross_entropy_sum(
        vm.variant_forward(params, torch.from_numpy(x).float(),
                           train_mode=True), torch.from_numpy(y))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, want))
    for path, p in vt.sorted_leaves(params):
        np.testing.assert_allclose(p.grad.numpy(), want[path], atol=5e-4,
                                   rtol=1e-3, err_msg=path)


K, LR, WD = 5, 1e-3, 1e-2


def _jax_steps(tree, batches, opt_state=None, k0=0):
    """Run the JAX train step over batches (dropout off). Returns (params,
    opt_state, losses)."""
    optimizer = jax_vt.make_optimizer(WD)
    params = _jax_tree(tree)
    if opt_state is None:
        opt_state = optimizer.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(LR)
    step = jax_vt.make_train_step(optimizer, fused_rnn=False)
    losses = []
    for x, y in batches[k0:]:
        params, opt_state, loss = step(
            params, opt_state, jnp.asarray(x.astype(np.float32)),
            jnp.asarray(y), None)
        losses.append(float(loss))
    return params, opt_state, losses


def _batches(seed, k, n=16):
    rng = np.random.default_rng(seed)
    return [(_images(rng, n), rng.integers(0, 3, n)) for _ in range(k)]


def _assert_params_close(params, want_tree, what):
    """Adam's update is lr * m/(sqrt(v)+eps): an element whose gradient is
    near zero can take opposite signs in the two frameworks and then moves
    by up to lr in a step the other side sits still or goes the other way.
    So, in units of lr: no element is off by more than 1 lr, and at most
    1 in 10,000 by more than 0.01 lr (measured: 6 and 15 of 1.13 M)."""
    want = _flat(jax.tree_util.tree_map(np.asarray, want_tree))
    diff = np.concatenate([
        np.abs(p.detach().numpy() - want[path]).ravel()
        for path, p in vt.sorted_leaves(params)]) / LR
    assert diff.max() <= 1.0, (what, diff.max())
    assert (diff > 0.01).mean() <= 1e-4, (what, int((diff > 0.01).sum()))


def test_k_steps_match_the_jax_train_step():
    tree = _tree(4)
    batches = _batches(4, K)
    want_params, _, want_losses = _jax_steps(tree, batches)
    params = vt.trainable(tree, "cpu")
    optimizer = vt.make_optimizer(params, LR, WD)
    step = vt.make_train_step(params, optimizer)
    losses = [float(step(x, y)) for x, y in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_params_close(params, want_params, "after 5 steps")
    moved = max(float((p.detach() - torch.from_numpy(_flat(tree)[path]))
                      .abs().max()) for path, p in vt.sorted_leaves(params))
    assert moved > 2 * LR


def test_optimizer_state_crosses_between_the_packages(tmp_path):
    """JAX 3 steps -> its checkpoint -> the port 3 more == JAX 6 steps; and
    the port's checkpoint loads through the JAX package's load_opt_state
    with the leaves in its order."""
    tree = _tree(5)
    batches = _batches(5, 6)
    want_params, want_state, want_losses = _jax_steps(tree, batches)
    mid_params, mid_state, _ = _jax_steps(tree, batches[:3])
    path = str(tmp_path / "jax3.npz")
    jax_ckpt.save_checkpoint(
        path, jax.tree_util.tree_map(np.asarray, mid_params), {"epochs": 1},
        opt_state=jax.tree_util.tree_map(np.asarray, mid_state))

    loaded, meta = ckpt.load_checkpoint(path)
    assert meta == {"epochs": 1}
    params = vt.trainable(loaded, "cpu")
    optimizer = vt.make_optimizer(params, 123.0, WD)
    saved = ckpt.load_opt_state(path)
    assert vt.restore_optimizer(optimizer, params, saved) == 3
    assert optimizer.param_groups[0]["lr"] == pytest.approx(LR)
    step = vt.make_train_step(params, optimizer)
    losses = [float(step(x, y)) for x, y in batches[3:]]
    np.testing.assert_allclose(losses, want_losses[3:], rtol=1e-4)
    _assert_params_close(params, want_params, "after 3+3 steps")

    # the other way: the port's state, after 6 steps, in the JAX optimizer
    ours = str(tmp_path / "torch6.npz")
    ckpt.save_checkpoint(ours, params, {"epochs": 2},
                         opt_state=vt.optimizer_leaves(optimizer, params, 6))
    template = jax_vt.make_optimizer(WD).init(_jax_tree(tree))
    restored = jax_ckpt.load_opt_state(ours, template)
    got = jax.tree_util.tree_leaves_with_path(restored)
    want = jax.tree_util.tree_leaves_with_path(want_state)
    assert len(got) == len(want) == 3 + 2 * 28
    for (gp, g), (wp, w) in zip(got, want):
        name = jax.tree_util.keystr(gp)
        assert gp == wp and np.asarray(g).dtype == np.asarray(w).dtype, name
        # moments are running sums of gradients that agree to ~1e-3 of
        # the largest entry
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=2e-3,
                                   atol=2e-3 * float(np.abs(w).max()),
                                   err_msg=name)
    assert int(restored.count) == int(restored.inner_state[1].count) == 6
    jax_params = _flat(jax_ckpt.load_checkpoint(ours)[0])
    for name, p in vt.sorted_leaves(params):
        assert np.array_equal(p.detach().numpy(), jax_params[name]), name
    # a params-only file carries no optimizer state
    ckpt.save_checkpoint(str(tmp_path / "plain.npz"), params, {})
    assert ckpt.load_opt_state(str(tmp_path / "plain.npz")) is None
    with pytest.raises(ValueError, match="optimizer state mismatch"):
        vt.restore_optimizer(optimizer, params, saved[:-1])


def test_dropout_is_seeded_rescaled_and_placed_as_in_jax(monkeypatch):
    """Five draws in train mode with a generator (after the LSTM stack and
    after linear_1..4, not after linear_5), none without; kept values are
    rescaled by 1/0.8; the same seed gives the same logits."""
    rng = np.random.default_rng(6)
    params = ckpt.params_from_jax(_tree(6))
    x = torch.from_numpy(_images(rng, 64).astype(np.float32))
    shapes = []
    real = vm._dropout

    def recording(t, rate, gen, block):
        out = real(t, rate, gen, block)
        assert block is None     # one process: the mask is the batch's
        shapes.append(tuple(t.shape))
        kept = out != 0
        assert rate == 0.2
        assert torch.allclose(out[kept], (t / 0.8)[kept])
        frac = kept.float().mean().item() / max(
            (t != 0).float().mean().item(), 1e-9)
        assert 0.7 < frac < 0.9, frac
        return out

    monkeypatch.setattr(vm, "_dropout", recording)

    def run(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return vm.variant_forward(params, x, train_mode=True,
                                  dropout_gen=gen)

    a = run(7)
    assert shapes == [(64, T, 2 * HID)] + [(64, 512)] * 4
    assert torch.equal(a, run(7)) and not torch.equal(a, run(8))
    shapes.clear()
    plain = run(None)
    assert shapes == [] and not torch.equal(a, plain)
    # inference mode never drops, generator or not
    probs = vm.variant_forward(params, x, dropout_gen=torch.Generator())
    assert shapes == [] and torch.allclose(probs, torch.softmax(plain, -1))


# ------------------------------------------------------------ train() runs
W2, F2 = 5, 6    # train() builds the hidden-256 model; keep the window short


def _write_image_store(path, images, labels, per_summary=17):
    from pepper_tpu_torch.encode.region_encoder import CandidateBatch
    from pepper_tpu_torch.pipelines.datastore import ImageStore
    with ImageStore(path, "w") as store:
        for si, lo in enumerate(range(0, len(images), per_summary)):
            img, lab = images[lo:lo + per_summary], labels[lo:lo + per_summary]
            n = len(img)
            store.write_summary(f"s{si}", CandidateBatch(
                "c1", np.arange(lo, lo + n), np.full(n, 30, np.int32),
                ["1A"] * n, np.full(n, 10, np.int32), img,
                np.zeros(n, np.int32), lab.astype(np.int32)),
                train_mode=True)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """120 labeled images whose label can be read off the image."""
    tmp = tmp_path_factory.mktemp("train_images")
    rng = np.random.default_rng(13)
    labels = rng.integers(0, 3, 120)
    images = _images(rng, 120, W2, F2)
    images[:, :, 0] = (labels * 40)[:, None]
    _write_image_store(str(tmp / "imgs.hdf5"), images, labels)
    return str(tmp), images, labels


def _train_csv(out):
    with open(glob.glob(out + "/stats_*/train_loss.csv")[0]) as fh:
        return fh.read()


def test_train_writes_stats_checkpoints_and_is_deterministic(image_dir,
                                                             tmp_path):
    imgs, _, _ = image_dir

    def run(tag, buffer_bytes=512 << 20):
        out = str(tmp_path / tag)
        best = vt.train(imgs, imgs, out, batch_size=16, epoch_limit=2,
                        step_size=5, lr=2e-4, seed=9, device="cpu",
                        buffer_bytes=buffer_bytes)
        return out, best

    out, best = run("a")
    assert best == os.path.join(out, "PEPPER_VARIANT_BEST.npz")
    stats = glob.glob(out + "/stats_*")
    assert len(stats) == 1
    for name in ("train_loss.csv", "test_loss.csv", "confusion_matrix.txt"):
        assert os.path.getsize(os.path.join(stats[0], name)) > 0, name
    rows = [ln.split(",") for ln in _train_csv(out).splitlines()]
    # 120 // 16 = 7 steps per epoch, capped by step_size 5: 2 * 5 steps,
    # the epoch counter advancing after each pass over the 7 batches
    assert [int(r[1]) for r in rows] == list(range(1, 11))
    assert [int(r[0]) for r in rows] == [0] * 7 + [1] * 3
    assert all(float(r[2]) > 0 for r in rows)
    assert sorted(os.path.basename(p) for p in glob.glob(out + "/*.npz")) == [
        "PEPPER_VARIANT_BEST.npz", "PEPPER_VARIANT_STEP_10.npz",
        "PEPPER_VARIANT_STEP_5.npz"]
    with np.load(os.path.join(out, "PEPPER_VARIANT_STEP_10.npz")) as z:
        opt = sorted(k for k in z.files if k.startswith("__opt__/"))
        assert len(opt) == 3 + 2 * 28
        assert int(z["__opt__/0"]) == int(z["__opt__/2"]) == 10
    _, meta = ckpt.load_checkpoint(os.path.join(out,
                                                "PEPPER_VARIANT_STEP_10.npz"))
    assert meta["step"] == 10 and meta["epochs"] == 1
    # the JAX package reads the checkpoint: same tree, optimizer state too
    jax_params, _ = jax_ckpt.load_checkpoint(best)
    assert jax_params["linear_1"]["weight"].shape == (512, 2 * 256 * W2)
    template = jax_vt.make_optimizer(1e-6).init(_jax_tree(jax_params))
    assert jax_ckpt.load_opt_state(best, template) is not None

    out_b, _ = run("b")
    assert _train_csv(out) == _train_csv(out_b), "same seed, same losses"
    out_s, _ = run("small", buffer_bytes=40 * (W2 * F2 + 8))
    assert len(_train_csv(out_s).splitlines()) == 10, \
        "the streaming buffer must run the same number of steps"


def test_train_resumes_with_its_optimizer_state(image_dir, tmp_path):
    imgs, images, labels = image_dir
    first = vt.train(imgs, imgs, str(tmp_path / "m1"), batch_size=16,
                     epoch_limit=1, step_size=5, lr=2e-4, seed=3,
                     device="cpu")
    with np.load(first) as z:
        assert int(z["__opt__/2"]) == 5
    second = vt.train(imgs, imgs, str(tmp_path / "m2"), batch_size=16,
                      epoch_limit=1, step_size=5, lr=2e-4, seed=3,
                      device="cpu", retrain_model_path=first)
    with np.load(second) as z:
        assert int(z["__opt__/0"]) == int(z["__opt__/2"]) == 10
    _, meta = ckpt.load_checkpoint(second)
    assert meta["epochs"] == 0 and meta["step"] == 5
    loss1 = [float(ln.split(",")[2]) for ln in
             _train_csv(str(tmp_path / "m1")).splitlines()]
    loss2 = [float(ln.split(",")[2]) for ln in
             _train_csv(str(tmp_path / "m2")).splitlines()]
    assert np.mean(loss2) < np.mean(loss1), "the resumed run starts trained"


def test_train_loop_takes_a_loader_from_arrays(image_dir, tmp_path):
    """The loop body over an in-memory loader equals train() over the same
    images in an HDF5 store (the eager path, same permutations)."""
    imgs, images, labels = image_dir
    vt.train(imgs, imgs, str(tmp_path / "disk"), batch_size=16,
             epoch_limit=1, step_size=4, seed=5, device="cpu")
    loader = ShuffleBufferLoader.from_arrays(images, labels, 16)
    assert loader.n_examples == 120 and loader.example_shape == (W2, F2)
    vt.train_loop(loader, {"images": images, "type_label": labels},
                  str(tmp_path / "mem"), epoch_limit=1, step_size=4, seed=5,
                  device="cpu")
    assert _train_csv(str(tmp_path / "disk")) == _train_csv(
        str(tmp_path / "mem"))
    with pytest.raises(ValueError, match="labeled images"):
        vt.train_loop(ShuffleBufferLoader.from_arrays(
            images[:0], labels[:0], 16), None, str(tmp_path / "none"),
            device="cpu")


def test_cli_train_model_and_test_model_on_the_cpu(image_dir, tmp_path,
                                                   capsys):
    from pepper_tpu_torch.cli.pepper_variant_train_main import main
    imgs, _, _ = image_dir
    out = str(tmp_path / "cli")
    assert main(["train_model", "--train_image_dir", imgs,
                 "--test_image_dir", imgs, "-o", out, "-bs", "16",
                 "--epoch_size", "1", "--step_size", "3", "-lr", "0.0002",
                 "--device", "cpu"]) == 0
    best = capsys.readouterr().out.strip().splitlines()[-1]
    assert best == os.path.join(out, "PEPPER_VARIANT_BEST.npz")
    assert os.path.isfile(best)
    assert main(["test_model", "--test_image_dir", imgs, "-m", best,
                 "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "Confusion matrix" in text and "Accuracy:" in text
    assert main(["backend_stat"]) == 0
    assert "torch version" in capsys.readouterr().out


@pytest.mark.parametrize("command", ["train_model", "test_model", "train"])
def test_cuda_without_a_card_raises(command, image_dir, tmp_path,
                                    monkeypatch):
    from pepper_tpu_torch.cli.pepper_variant_train_main import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs, _, _ = image_dir
    out = str(tmp_path / "out")
    model = str(tmp_path / "m.npz")
    ckpt.save_checkpoint(model, _tree(0, W2, F2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if command == "train_model":     # --device defaults to cuda
            main(["train_model", "--train_image_dir", imgs,
                  "--test_image_dir", imgs, "-o", out])
        elif command == "test_model":
            main(["test_model", "--test_image_dir", imgs, "-m", model])
        else:
            vt.train(imgs, imgs, out)
    assert not os.path.exists(out)


def test_train_learns_the_planted_label(image_dir, tmp_path):
    """42 steps (~5 s at this window): the label is column 0 of the image, so accuracy must
    beat the majority class."""
    imgs, images, labels = image_dir
    best = vt.train(imgs, imgs, str(tmp_path / "m"), batch_size=16,
                    epoch_limit=6, step_size=7, lr=5e-4, seed=1,
                    device="cpu")
    params = vt.trainable(ckpt.load_checkpoint(best)[0], "cpu")
    _, accuracy = vt.confusion_and_accuracy(params, images, labels)
    assert accuracy > 100.0 * np.bincount(labels).max() / len(labels)
