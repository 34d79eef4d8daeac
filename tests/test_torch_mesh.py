"""The port's device meshes (pepper_tpu_torch/parallel/mesh.py), the
sharded runners and the multi-device dry run, against the JAX package's, on
the CPU: a mesh of CPU entries runs the same sharded code as a mesh of
cards (parallel/mesh.py), as the JAX tests run on 8 virtual CPU devices.

Tolerances: the 4-entry-mesh runner equals the 1-device runner bitwise (f32
rows are independent on the CPU) and the JAX runner on its 8 devices within
2e-5 (the model bar, tests/test_models.py:85); the sharded vote function
equals the unsharded one (see its test for the CPU's small-matrix path).
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models.variant_model import init_variant_params as jax_init
from pepper_tpu.parallel import mesh as jax_mesh
from pepper_tpu.runtime.streaming import DeviceRunner as JaxDeviceRunner
from pepper_tpu_torch.models.polish_model import init_polish_params
from pepper_tpu_torch.ops import fused_lstm as fl
from pepper_tpu_torch.ops import pack_cache
from pepper_tpu_torch.parallel import mesh
from pepper_tpu_torch.parallel.dryrun import dryrun_multichip
from pepper_tpu_torch.polish.consensus import make_window_vote_fn
from pepper_tpu_torch.runtime.streaming import DeviceRunner, get_device_runner

CPU4 = ["cpu"] * 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain recurrences launch thousands of tiny ops; one thread per
    test worker keeps the file's run time the same under load as alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree():
    """The JAX package's full-width classifier init as a numpy tree."""
    return jax.tree_util.tree_map(np.asarray,
                                  jax_init(jax.random.PRNGKey(7)))


def _images(rng, n, window=33, features=26):
    x = rng.integers(-125, 126, (n, window, features))
    x[rng.random(x.shape) < 0.7] = 0
    return x.astype(np.int8)


# ------------------------------------------------------------ the mesh
def test_data_mesh_entries_and_no_card(monkeypatch):
    assert mesh.data_mesh(["cpu", torch.device("cpu")]) == \
        [torch.device("cpu")] * 2
    assert mesh.mesh_for("cpu") == [torch.device("cpu")]
    assert mesh.mesh_for(CPU4) == [torch.device("cpu")] * 4
    with pytest.raises(ValueError):
        mesh.data_mesh([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for bad in (lambda: mesh.data_mesh(), lambda: mesh.mesh_for("cuda"),
                lambda: mesh.data_mesh(["cuda:0", "cuda:0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bad()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_batch_blocks_match_jax_shards(n):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    y = np.arange(16, dtype=np.int32)
    got = mesh.shard_batch(["cpu"] * n, {"x": x, "y": y})
    jmesh = jax_mesh.data_mesh(jax.devices()[:n])
    want = jax_mesh.shard_batch(jmesh, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
    for key in ("x", "y"):
        shards = sorted(want[key].addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        assert len(got) == len(shards) == n
        for block, shard in zip(got, shards):
            np.testing.assert_array_equal(block[key].numpy(),
                                          np.asarray(shard.data))
    with pytest.raises(ValueError, match="split"):
        mesh.shard_batch(["cpu"] * 3, x)
    assert [mesh.pad_to_multiple(k, n) for k in range(1, 20)] == \
        [jax_mesh.pad_to_multiple(k, n) for k in range(1, 20)]


def test_replicate_gives_each_entry_its_own_copy():
    tree = {"a": torch.ones(3), "b": {"c": np.zeros((2, 2), np.float32)}}
    copies = mesh.replicate(CPU4, tree)
    assert len(copies) == 4
    for c in copies:
        assert torch.equal(c["a"], tree["a"]) and c["a"] is not tree["a"]
        assert c["a"].data_ptr() != tree["a"].data_ptr()
    assert len({c["b"]["c"].data_ptr() for c in copies}) == 4


def test_rank_block_and_local_rows_without_a_group():
    assert mesh.rank_block(10) == (0, 10)
    x = np.arange(8)
    (block,) = mesh.shard_batch_from_local(["cpu"], x)
    np.testing.assert_array_equal(block.numpy(), x)


def test_a_rank_feeds_its_block_and_runs_on_its_own_card(monkeypatch):
    """Under a process group (one process per card, as torchrun starts
    them) a rank takes its contiguous block of the global batch, and the
    runners' "cuda" is the rank's own card, not every visible card. The
    group and four cards are stood in for, so this runs on the CPU."""
    import torch.distributed as dist
    from pepper_tpu_torch.parallel import multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 3)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert mesh.mesh_for("cuda") == [torch.device("cuda", i)
                                     for i in range(4)]
    group = object()
    monkeypatch.setattr(multihost, "process_group", lambda: group)
    assert mesh.rank_block(10, group) == (7, 10)
    assert mesh.rank_block(12, group, exact=True) == (9, 12)
    with pytest.raises(ValueError, match="does not split"):
        mesh.rank_block(10, group, exact=True)
    assert mesh.mesh_for("cuda") == [torch.device("cuda", 3)]
    assert mesh.mesh_for("cuda:2") == [torch.device("cuda", 2)]
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.mesh_for("cuda") == [torch.device("cuda", 1)]


# ------------------------------------------------------ sharded runner
def test_mesh_runner_equals_one_device_and_the_jax_runner(tree,
                                                          monkeypatch):
    """The form of tests/test_e2e_model.py:100-118: the sharded runner
    against one device (bitwise) and against JAX's runner, which shards
    over the 8 virtual devices of the test process."""
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "64")
    monkeypatch.setenv("PEPPER_TPU_CACHE_DIR", "off")
    images = _images(np.random.default_rng(3), 50)
    sharded = DeviceRunner(tree, 60, device=CPU4)
    single = DeviceRunner(tree, 60, device="cpu")
    assert sharded.batch == 64 and single.batch == 64
    assert len(sharded.mesh) == 4 and sharded.dtype == torch.float32
    got = np.asarray(sharded.submit(images))
    np.testing.assert_array_equal(got, np.asarray(single.submit(images)))
    assert jax.local_device_count() >= 8
    want = np.asarray(JaxDeviceRunner(tree, 60).submit(images))
    np.testing.assert_allclose(got[:50], want[:50], atol=2e-5)
    # forward of a device tensor splits the same way
    x8 = torch.from_numpy(np.concatenate(
        [images, np.zeros((14, 33, 26), np.int8)]))
    np.testing.assert_array_equal(sharded.forward(x8).numpy(), got)


def test_runner_cache_key_includes_the_mesh(tree, tmp_path, monkeypatch):
    from pepper_tpu_torch.models.checkpoint import save_checkpoint
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "64")
    model = str(tmp_path / "m.npz")
    save_checkpoint(model, tree)
    one = get_device_runner(model, 64, "cpu")
    four = get_device_runner(model, 64, CPU4)
    assert one is not four and len(four.mesh) == 4
    assert get_device_runner(model, 64, list(CPU4)) is four


def test_mesh_runner_reserves_a_pack_per_replica_layer(tree, monkeypatch):
    """Hazard: the pack cache is keyed on the source tensors, and every
    replica's layers are tensors of their own. A runner reserves room for
    all of them, so the lookups of a second batch (the two layers of each
    replica, as the card's forward makes them) build no pack. Shown with a
    cache base size of 2, which 4 replicas would otherwise thrash."""
    monkeypatch.setattr(pack_cache, "CACHE_SIZE", 2)
    monkeypatch.setattr(pack_cache, "_reserved", {})
    monkeypatch.setattr(pack_cache, "_cache", type(pack_cache._cache)())

    def one_batch(replicas):
        before = fl.pack_builds
        for replica in replicas:
            for layer in ("encoder", "decoder"):
                fl.packed_layer(replica[layer], "generic")
        return fl.pack_builds - before

    layers = {k: tree[k] for k in ("encoder", "decoder")}
    unreserved = mesh.replicate(CPU4, layers)
    assert one_batch(unreserved) == 8 and one_batch(unreserved) == 8

    runner = DeviceRunner(tree, 64, device=CPU4)
    assert pack_cache.capacity() == 2 + 8
    assert one_batch(runner._replicas) == 8
    assert one_batch(runner._replicas) == 0

    # two live runners (the base and the HP pass) reserve room for both,
    # and a freed runner's reservation ends with it
    second = DeviceRunner(tree, 64, device=CPU4)
    assert pack_cache.capacity() == 2 + 16
    assert one_batch(second._replicas) == 8
    assert one_batch(runner._replicas) + one_batch(second._replicas) == 0
    del second
    gc.collect()
    assert pack_cache.capacity() == 2 + 8


# ------------------------------------------------------ sharded votes
@pytest.mark.parametrize("sequences", [32, 4])
def test_mesh_vote_function_equals_the_unsharded_one(sequences):
    """Labels equal; phred bitwise at 8 rows a block. With 1 row a block
    the CPU's BLAS takes its small-matrix path for the biGRU's products
    and rounds differently from the whole batch's: phred then within
    1e-5 (the card's kernels are row-independent: chip_smoke.py holds
    the sharded labels and phred there bitwise)."""
    params = init_polish_params(torch.Generator().manual_seed(5))
    tree = {g: {k: v.numpy() for k, v in leaves.items()}
            for g, leaves in params.items()}
    rng = np.random.default_rng(6)
    x = rng.integers(0, 255, (sequences, 1000, 10))
    x[rng.random(x.shape) < 0.5] = 0
    images = torch.from_numpy(x.astype(np.uint8))
    cpu = torch.device("cpu")
    want_labels, want_phred = make_window_vote_fn(tree, cpu,
                                                  torch.float32)(images)
    labels, phred = make_window_vote_fn(tree, cpu, torch.float32,
                                        mesh=mesh.data_mesh(CPU4))(images)
    assert labels.dtype == torch.int32 and labels.shape == (sequences, 1000)
    assert torch.equal(labels, want_labels)
    if sequences // 4 >= 8:
        assert torch.equal(phred, want_phred)
    else:
        torch.testing.assert_close(phred, want_phred, rtol=0, atol=1e-5)


# ------------------------------------------------------ the dry run
def test_dryrun_multichip_8_devices():
    """The port's counterpart of tests/test_train.py:36-41, at the
    production widths, on 8 CPU entries."""
    out = dryrun_multichip(8, device="cpu")
    assert out["mesh"] == ["cpu"] * 8 and np.isfinite(out["loss"])
    assert out["shapes"] == {"base": [16, 3], "hp": [16, 3],
                             "polish": [16, 1000]}


def test_dryrun_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
