"""The port's polish trainer (pepper_tpu_torch/train/polish_train.py),
hyperband and `pepper_train` CLI against the JAX package's, on the same
numpy inputs and weights, in f32 on the CPU.

Tolerances: the window loss and every gradient at 2e-5 (absolute) against
`jax.value_and_grad` of the JAX trainer's loss; k steps at variant
training's bar (losses rtol 1e-4, parameters in units of the learning rate,
see `_assert_params_close`); the eval's confusion matrix equal. Most tests
use hidden 32; the ones that run the JAX package's `train_polish` or
`polish_accuracy` use its fixed hidden 128 and two or three sequences.
"""
import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models import checkpoint as jax_ckpt
from pepper_tpu.models.polish_model import init_polish_params as jax_init
from pepper_tpu.models.polish_model import polish_forward as jax_forward
from pepper_tpu.parallel.mesh import data_mesh
from pepper_tpu.train import hyperband as jax_hb
from pepper_tpu.train import polish_train as jax_pt
from pepper_tpu.train.variant_train import make_optimizer as jax_optimizer
from pepper_tpu_torch.models import checkpoint as ckpt
from pepper_tpu_torch.models.polish_model import (init_polish_params,
                                                  polish_forward)
from pepper_tpu_torch.ops.fused_lstm import records_grad
from pepper_tpu_torch.polish.datastore import PolishImageStore
from pepper_tpu_torch.train import hyperband as hb
from pepper_tpu_torch.train import polish_train as pt
from pepper_tpu_torch.train import variant_train as vt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD = 1e-3, 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain recurrences issue thousands of tiny ops; one thread per
    test worker keeps the file's run time the same under load as alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_compile_cache(monkeypatch):
    """The JAX trainer would otherwise write its compile cache under HOME."""
    monkeypatch.setenv("PEPPER_TPU_CACHE_DIR", "off")


def _tree(seed, hidden=32):
    """Seeded polish-model parameters as a numpy tree."""
    params = init_polish_params(torch.Generator().manual_seed(seed),
                                hidden=hidden)
    return {g: {k: v.numpy() for k, v in leaves.items()}
            for g, leaves in params.items()}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree):
    return dict(vt.sorted_leaves(tree))


def _data(seed, n):
    """(uint8 pileup-like images [n,1000,10], uint8 labels [n,1000])."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 60, (n, 1000, 10))
    x[rng.random(x.shape) < 0.5] = 0
    return x.astype(np.uint8), rng.integers(0, 5, (n, 1000)).astype(np.uint8)


def _assert_params_close(params, want_tree, what):
    """Adam's update is lr * m/(sqrt(v)+eps): an element whose gradient is
    near zero can take opposite signs in the two frameworks and then moves
    by up to lr in a step the other side sits still or goes the other way.
    So, in units of lr: no element is off by more than 1 lr, and at most 1
    in 10,000 by more than 0.01 lr."""
    want = _flat(jax.tree_util.tree_map(np.asarray, want_tree))
    diff = np.concatenate([
        np.abs(np.asarray(p.detach() if isinstance(p, torch.Tensor) else p)
               - want[path]).ravel()
        for path, p in vt.sorted_leaves(params)]) / LR
    assert diff.max() <= 1.0, (what, diff.max())
    assert (diff > 0.01).mean() <= 1e-4, (what, int((diff > 0.01).sum()))


def test_records_grad_predicate():
    params = {"w": torch.zeros(3, 3)}
    x, h0 = torch.zeros(2, 3), torch.zeros(2, 2, 3)
    assert not records_grad(params, x, h0)
    assert records_grad(params, x.requires_grad_(), h0)
    assert records_grad(params, torch.zeros(2, 3), h0.clone()
                        .requires_grad_())
    params["w"].requires_grad_()
    assert records_grad(params, torch.zeros(2, 3))
    with torch.no_grad():
        assert not records_grad(params, x, h0)
    with torch.inference_mode():
        assert not records_grad(params, x, h0)


def test_cross_entropy_mean_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 100, 5)).astype(np.float32)
    labels = rng.integers(0, 5, (4, 100))
    got = pt.cross_entropy_mean(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    want = jax_pt.cross_entropy_mean(jnp.asarray(logits),
                                     jnp.asarray(labels))
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    assert got.item() == pytest.approx(torch.nn.functional.cross_entropy(
        torch.from_numpy(logits).reshape(-1, 5),
        torch.from_numpy(labels).reshape(-1)).item(), rel=1e-6)


@pytest.mark.parametrize("fused_rnn", [False, True])
def test_polish_forward_switch_matches_jax(fused_rnn):
    """Both biGRU routes (the step loop autograd differentiates, K2's plain
    version) against the JAX scan, with a nonzero carried hidden."""
    tree = _tree(2)
    rng = np.random.default_rng(2)
    x = _data(2, 3)[0][:, :100].astype(np.float32)
    h0 = (0.5 * rng.standard_normal((3, 2, 32))).astype(np.float32)
    want, want_h = jax_forward(_jax_tree(tree), jnp.asarray(x),
                               jnp.asarray(h0))
    got, got_h = polish_forward(ckpt.params_from_jax(tree),
                                torch.from_numpy(x), torch.from_numpy(h0),
                                fused_rnn=fused_rnn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-5)


def test_window_loss_and_gradients_match_jax():
    """One window's loss and the gradient of every parameter; the decoder
    starts from the encoder's final hidden, so the encoder's parameters
    also take gradient through that hidden."""
    tree = _tree(3)
    rng = np.random.default_rng(3)
    images, labels = _data(3, 3)
    x = images[:, 100:200].astype(np.float32)
    y = labels[:, 100:200].astype(np.int32)
    h0 = (0.5 * rng.standard_normal((3, 2, 32))).astype(np.float32)

    def loss_fn(p):
        logits, hidden = jax_forward(p, jnp.asarray(x), jnp.asarray(h0))
        return jax_pt.cross_entropy_mean(logits, jnp.asarray(y)), hidden

    (want_loss, want_h), want = jax.value_and_grad(
        loss_fn, has_aux=True)(_jax_tree(tree))
    params = vt.trainable(tree, "cpu")
    logits, hidden = polish_forward(params, torch.from_numpy(x),
                                    torch.from_numpy(h0))
    loss = pt.cross_entropy_mean(logits, torch.from_numpy(y))
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-6)
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(want_h),
                               atol=2e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, want))
    assert len(want) == 18
    for path, p in vt.sorted_leaves(params):
        assert p.grad is not None and float(p.grad.abs().max()) > 0, path
        np.testing.assert_allclose(p.grad.numpy(), want[path], atol=2e-5,
                                   err_msg=path)


def _jax_window_steps(tree, x, y, k, opt_state=None):
    """k JAX train steps over the first k windows of one batch, the hidden
    carried. Returns (params, opt_state, losses, hidden)."""
    optimizer = jax_optimizer(WD)
    params = _jax_tree(tree)
    if opt_state is None:
        opt_state = optimizer.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(LR)
    step = jax_pt.make_polish_train_step(optimizer)
    hidden = jnp.zeros((x.shape[0], 2, 32), jnp.float32)
    losses = []
    for i in range(0, 50 * k, 50):
        params, opt_state, hidden, loss = step(
            params, opt_state, jnp.asarray(x[:, i:i + 100]),
            jnp.asarray(y[:, i:i + 100]), hidden)
        losses.append(float(loss))
    return params, opt_state, losses, hidden


def test_k_window_steps_match_the_jax_train_step():
    tree = _tree(4)
    images, labels = _data(4, 4)
    x, y = images.astype(np.float32), labels.astype(np.int32)
    want_params, _, want_losses, want_h = _jax_window_steps(tree, x, y, 5)
    params = vt.trainable(tree, "cpu")
    step = pt.make_polish_train_step(params, vt.make_optimizer(params, LR,
                                                               WD))
    hidden = torch.zeros(4, 2, 32)
    losses = []
    for i in range(0, 250, 50):
        hidden, loss = step(torch.from_numpy(x[:, i:i + 100]),
                            torch.from_numpy(y[:, i:i + 100]), hidden)
        assert not hidden.requires_grad
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_params_close(params, want_params, "after 5 window steps")
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_h),
                               atol=1e-4)
    moved = max(float((p.detach() - torch.from_numpy(_flat(tree)[path]))
                      .abs().max()) for path, p in vt.sorted_leaves(params))
    assert moved > 2 * LR


def test_polish_accuracy_matches_jax():
    """The windowed eval (K2's plain version on the CPU) against the JAX
    eval (its scan), at the JAX package's hidden 128, over a partial last
    batch."""
    tree = _tree(5, hidden=128)
    images, labels = _data(5, 3)
    x, y = images.astype(np.float32), labels.astype(np.int32)
    want_cm, want_acc = jax_pt.polish_accuracy(_jax_tree(tree), x, y,
                                               batch_size=2)
    cm, acc = pt.polish_accuracy(ckpt.params_from_jax(tree), x, y,
                                 batch_size=2)
    assert cm.dtype == np.int64 and cm.shape == (5, 5)
    assert cm.sum() == 3 * 19 * 100
    np.testing.assert_array_equal(cm, np.asarray(want_cm))
    assert acc == pytest.approx(want_acc, abs=1e-12)


def _write_store(directory, images, labels):
    os.makedirs(directory, exist_ok=True)
    with PolishImageStore(os.path.join(directory, "imgs.hdf"), "w") as s:
        for k, (image, label) in enumerate(zip(images, labels)):
            s.write_summary(("contig1", 1000 * k, 1000 * k + 999), image,
                            label, np.arange(1000), np.zeros(1000), 0,
                            f"contig1_{k}")
    return directory


def _stats(model_dir, name):
    path, = glob.glob(os.path.join(model_dir, "stats_*", name))
    with open(path) as fh:
        return [ln.strip().split(",") for ln in fh]


def test_train_polish_resumes_from_a_jax_checkpoint_as_jax_does(tmp_path):
    """A JAX-written checkpoint (3 JAX steps in, with its optimizer state)
    retrained for one epoch by the JAX package's train_polish and by the
    port's, on the same image directory: the same epoch loss, parameters
    within lr units, the optimizer count and learning rate carried, and
    each package's checkpoint read by the other."""
    tree = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(6)))
    images, labels = _data(6, 2)
    image_dir = _write_store(str(tmp_path / "images"), images, labels)
    optimizer = jax_optimizer(WD)
    params = _jax_tree(tree)
    opt_state = optimizer.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(5 * LR)
    step = jax_pt.make_polish_train_step(optimizer)
    hidden = jnp.zeros((2, 2, 128), jnp.float32)
    x, y = images.astype(np.float32), labels.astype(np.int32)
    for i in (500, 550, 600):
        params, opt_state, hidden, _ = step(params, opt_state,
                                            jnp.asarray(x[:, i:i + 100]),
                                            jnp.asarray(y[:, i:i + 100]),
                                            hidden)
    start = str(tmp_path / "jax3.npz")
    jax_ckpt.save_checkpoint(
        start, jax.tree_util.tree_map(np.asarray, params), {"epochs": 1},
        opt_state=jax.tree_util.tree_map(np.asarray, opt_state))

    kw = dict(batch_size=2, epoch_limit=1, lr=LR, weight_decay=WD,
              retrain_model_path=start, seed=3)
    want = jax_pt.train_polish(image_dir, image_dir, str(tmp_path / "jax"),
                               mesh=data_mesh(jax.devices()[:1]), **kw)
    got = pt.train_polish(image_dir, image_dir, str(tmp_path / "port"),
                          device="cpu", **kw)
    for model_dir in (tmp_path / "port", tmp_path / "jax"):
        assert sorted(os.listdir(model_dir))[:2] == [
            "PEPPER_POLISH_BEST.npz", "PEPPER_POLISH_EPOCH_1.npz"]
        assert glob.glob(str(model_dir / "stats_*" / "confusion_matrix.txt"))
    (g_epoch, g_loss), = _stats(str(tmp_path / "port"), "train_loss.csv")
    (w_epoch, w_loss), = _stats(str(tmp_path / "jax"), "train_loss.csv")
    assert g_epoch == w_epoch == "1"
    assert float(g_loss) == pytest.approx(float(w_loss), rel=1e-4)
    (_, _, g_acc), = _stats(str(tmp_path / "port"), "test_loss.csv")
    (_, _, w_acc), = _stats(str(tmp_path / "jax"), "test_loss.csv")
    assert float(g_acc) == pytest.approx(float(w_acc), abs=0.1)

    got_params, meta = ckpt.load_checkpoint(got)
    want_params, _ = jax_ckpt.load_checkpoint(want)
    assert meta["epochs"] == 1
    _assert_params_close(got_params, want_params, "after 3 + 19 steps")
    saved = ckpt.load_opt_state(got)
    assert len(saved) == 3 + 2 * 18
    assert int(saved[0]) == int(saved[2]) == 3 + 19
    assert float(saved[1]) == pytest.approx(LR)
    # the port's checkpoint in the JAX optimizer, and the JAX one's count
    template = jax_optimizer(WD).init(_jax_tree(tree))
    restored = jax_ckpt.load_opt_state(got, template)
    assert int(restored.inner_state[1].count) == 3 + 19
    assert int(ckpt.load_opt_state(want)[2]) == 3 + 19


def test_train_polish_loop_on_arrays(tmp_path):
    """The array path: stats files, per-epoch and best checkpoints with the
    optimizer state, deterministic for one seed, the last partial batch
    dropped; with no test set only the best checkpoint is written."""
    start = str(tmp_path / "start.npz")
    ckpt.save_checkpoint(start, _tree(7), {})   # no optimizer state
    images, labels = _data(7, 3)
    train = pt.polish_training_arrays(images, labels)
    test = pt.polish_training_arrays(images[:1], labels[:1])
    assert train[0].dtype == np.float32 and train[1].dtype == np.int32
    kw = dict(batch_size=2, epoch_limit=2, lr=LR, weight_decay=WD,
              retrain_model_path=start, seed=4, device="cpu")
    runs = [pt.train_polish_loop(train, test, str(tmp_path / f"run{k}"),
                                 **kw) for k in range(2)]
    model_dir = str(tmp_path / "run0")
    assert sorted(f for f in os.listdir(model_dir) if f.endswith(".npz")) \
        == ["PEPPER_POLISH_BEST.npz", "PEPPER_POLISH_EPOCH_1.npz",
            "PEPPER_POLISH_EPOCH_2.npz"]
    losses = _stats(model_dir, "train_loss.csv")
    assert [r[0] for r in losses] == ["1", "2"]
    assert all(np.isfinite(float(r[1])) for r in losses)
    assert len(_stats(model_dir, "test_loss.csv")) == 2
    saved = ckpt.load_opt_state(os.path.join(model_dir,
                                             "PEPPER_POLISH_EPOCH_2.npz"))
    assert int(saved[2]) == 2 * 19      # 2 epochs x 1 full batch x 19
    a, meta = ckpt.load_checkpoint(runs[0])
    b, _ = ckpt.load_checkpoint(runs[1])
    assert 0 <= meta["accuracy"] <= 100
    for (path, x), (_, y) in zip(vt.sorted_leaves(a), vt.sorted_leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=path)

    bare = str(tmp_path / "no_test")
    best = pt.train_polish_loop(train, None, bare, **{**kw, "epoch_limit": 1})
    assert sorted(f for f in os.listdir(bare) if f.endswith(".npz")) == \
        ["PEPPER_POLISH_BEST.npz"]
    assert ckpt.load_checkpoint(best)[1] == {"epochs": 1}
    with pytest.raises(ValueError, match="no labeled polish images"):
        pt.train_polish_loop(pt.polish_training_arrays([], []), None, bare,
                             device="cpu")


def test_load_polish_training_data_reads_the_stores(tmp_path):
    images, labels = _data(8, 3)
    image_dir = _write_store(str(tmp_path / "imgs"), images, labels)
    got = pt.load_polish_training_data(image_dir)
    want = jax_pt.load_polish_training_data(image_dir)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert pt.load_polish_training_data(str(tmp_path)) == (None, None)


def test_hyperband_converges_with_fake_trainer():
    calls = []

    def fake_train(config, epochs, run_dir):
        # quadratic bowl around lr=1e-3: closer lr -> higher accuracy
        calls.append((config, epochs))
        return 100.0 - abs(np.log10(config["lr"]) + 3) * 10, run_dir

    best = hb.run_hyperband("x", "y", "/tmp/hb", max_epochs=9, eta=3,
                            seed=1, train_fn=fake_train)
    assert best["accuracy"] > 80
    assert abs(np.log10(best["lr"]) + 3) < 2.0
    assert len(calls) > 5


def test_sample_config_ranges():
    rng = np.random.RandomState(0)
    for _ in range(20):
        config = hb.sample_config(rng)
        assert 1e-5 <= config["lr"] <= 1e-2
        assert 1e-7 <= config["weight_decay"] <= 1e-4


def test_hyperband_persists_results_json_as_jax_does(tmp_path):
    def fake_train(config, epochs, run_dir):
        return 50.0 + np.log10(config["lr"]), run_dir

    for name, module in (("port", hb), ("jax", jax_hb)):
        module.run_hyperband("x", "y", str(tmp_path / name), max_epochs=3,
                             eta=3, seed=2, train_fn=fake_train)
    results_file = tmp_path / "port" / "hyperband_results.json"
    results = json.loads(results_file.read_text())
    assert results and all(
        {"accuracy", "iterations", "params", "model_path"} <= set(r)
        for r in results)
    want = json.loads((tmp_path / "jax" / "hyperband_results.json")
                      .read_text())
    assert [(r["accuracy"], r["iterations"], r["params"]) for r in results] \
        == [(r["accuracy"], r["iterations"], r["params"]) for r in want]
    # the inspection helper reads the same file
    from pepper_tpu_torch.utils.hyperband_result import main
    assert main(["--results_file", str(results_file),
                 "--min_iterations", "1"]) == 0


def test_pepper_train_torch_help():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    for sub in ([], ["make_train_images"], ["train_model"], ["test_model"],
                ["run_hyperband"]):
        proc = subprocess.run(
            [sys.executable, "-m", "pepper_tpu_torch.cli.pepper_train_main",
             *sub, "--help"], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert ("--device" in proc.stdout) == (sub not in ([], [
            "make_train_images"])), (sub, proc.stdout)
    with open(os.path.join(ROOT, "pyproject.toml")) as fh:
        assert ('pepper_train_torch = "pepper_tpu_torch.cli.'
                'pepper_train_main:main"') in fh.read()


def test_cli_test_model_matches_jax_accuracy(tmp_path, capsys):
    from pepper_tpu_torch.cli.pepper_train_main import main

    tree = _tree(9, hidden=128)
    model = str(tmp_path / "model.npz")
    ckpt.save_checkpoint(model, tree, {})
    images, labels = _data(9, 2)
    image_dir = _write_store(str(tmp_path / "imgs"), images, labels)
    assert main(["test_model", "--test_image_dir", image_dir, "-m", model,
                 "-bs", "2", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    _, want = jax_pt.polish_accuracy(
        _jax_tree(tree), images.astype(np.float32), labels.astype(np.int32),
        batch_size=2)
    assert f"Accuracy: {want:.4f}" in printed


@pytest.mark.parametrize("argv", [
    ["train_model", "--train_image_dir", "x", "--test_image_dir", "y",
     "-o", "out"],
    ["test_model", "--test_image_dir", "x", "-m", "m.npz"],
    ["run_hyperband", "--train_image_dir", "x", "--test_image_dir", "y",
     "-o", "out"],
])
def test_cli_cuda_without_a_card_raises(argv, monkeypatch, tmp_path):
    from pepper_tpu_torch.cli.pepper_train_main import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert os.listdir(tmp_path) == []
