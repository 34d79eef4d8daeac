"""The port's multi-host layer (pepper_tpu_torch/parallel/multihost.py) and
its data-parallel trainers against the JAX package's, on the CPU.

Two local processes stand in for two hosts (filesystem mode: striping, the
candidate gather through the shared output directory) or for two ranks of
a gloo group (the trainers' gradient all-reduce). The forms mirror
tests/test_multihost.py:

- striping, tags, the gather and `initialize`'s validation equal the JAX
  functions on the same inputs;
- a 2-host call_variant writes the 5 VCFs byte-identical to the port's
  1-host run; in dry mode (no model) also byte-identical to the JAX
  package's 1-host run; with a real model (random hidden-32 weights, f32)
  each record agrees with the JAX run's on every column and FORMAT field,
  AP within 1e-5 (the contract of tests/test_torch_call_variant.py: AP
  prints .6g and XLA and torch sum in different orders);
- 2 ranks of either trainer take 4 steps equal to one process at the JAX
  test's tolerances (parameters rtol 5e-3, atol 1e-4; losses rtol 1e-4),
  the ranks bit-identical. As in the JAX test, the one-process reference
  of the variant trainer runs over a mesh of the ranks' size: the port's
  two in-process replicas (dropout on) or the JAX package's step on a
  2-device mesh (dropout off; the JAX masks cannot be drawn in torch).
  Adam turns a near-zero gradient element into a step of about lr in the
  direction of its sign, and a sum over 64 rows in another order can flip
  that sign, so a reference that sums each block's gradient apart, as the
  ranks do, is held to the JAX test's bar. The polish reference is one
  process over all the rows.
"""
import glob
import gzip
import importlib
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepper_tpu.models.variant_model import init_variant_params as jax_init
from pepper_tpu.options import PipelineConfig as JaxPipelineConfig
from pepper_tpu.parallel import multihost as jax_mh
from pepper_tpu.parallel.mesh import data_mesh, replicate, shard_batch
from pepper_tpu.pipelines.call_variant import call_variant as jax_call_variant
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu.train import polish_train as jax_pt
from pepper_tpu.train import variant_train as jax_vt
from pepper_tpu_torch.models.checkpoint import save_checkpoint
from pepper_tpu_torch.models.polish_model import init_polish_params
from pepper_tpu_torch.models.variant_model import init_variant_params
from pepper_tpu_torch.parallel import multihost as mh
from pepper_tpu_torch.train import variant_train as vt
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset,
                                          write_truth_vcf)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# one intra-op thread per process: two ranks on the test worker's cores
ENV = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
           PYTHONPATH=ROOT)

_HOST_RUN = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines.call_variant import call_variant
from pepper_tpu_torch.presets import set_parameters

call_variant(set_parameters(PipelineConfig(**json.load(open(sys.argv[1])))))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs):
    for p in procs:
        try:
            _, err = p.communicate(timeout=TIMEOUT)
        finally:
            p.kill()
        assert p.returncode == 0, err.decode()[-3000:]


# ------------------------------------------------- striping, tags, gather
@pytest.mark.parametrize("hosts", [(3, 1), (2, 0), (2, 1), (4, 3),
                                   (None, None)])
def test_host_shard_and_tag_match_jax(monkeypatch, hosts):
    n, i = hosts
    for module in (mh, jax_mh):
        monkeypatch.setattr(module, "_num_hosts", n)
        monkeypatch.setattr(module, "_host_id", i)
    items = [("chr1", 10 * k, 10 * k + 10) for k in range(11)]
    assert mh.host_count() == jax_mh.host_count()
    assert mh.host_index() == jax_mh.host_index()
    assert mh.host_shard(items) == jax_mh.host_shard(items)
    assert mh.shard_intervals_by_host(items) == \
        jax_mh.shard_intervals_by_host(items)
    assert mh.host_tag() == jax_mh.host_tag()
    dicts = [{("chr1", 5): [1]}, {("chr1", 5): [2], ("chr2", 1): [3]}]
    assert mh.merge_candidate_dicts(dicts) == \
        jax_mh.merge_candidate_dicts(dicts)
    if n == 3:
        assert mh.host_shard(list(range(10))) == [1, 4, 7]
        assert mh.host_tag() == "host_1_"


def test_gather_candidate_lists_roundtrip_and_timeout(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(mh, "_num_hosts", 2)
    monkeypatch.setattr(mh, "_host_id", 1)
    m1 = [("chr1", 5, 6, "A", ["T"], [0, 1], 30, [10], 0.9, [0.1, 0.9, 0.0])]
    d1 = [("chr1", 5, 6, "A", ["T"], [0, 1], 30, [10], 0.9,
           [0.1, 0.9, 0.0], [0.9], False)]
    assert mh.gather_candidate_lists(str(tmp_path), m1, d1) is None
    assert os.path.exists(tmp_path / ".pepper_candidates_host_1.pkl")
    monkeypatch.setattr(mh, "_host_id", 0)
    m0, d0 = [("chr1", 2, 3, "C", ["G"], [1, 1], 25, [20], 0.8,
               [0.0, 0.1, 0.9])], []
    merged_m, merged_d = mh.gather_candidate_lists(str(tmp_path), m0, d0,
                                                   timeout=5)
    assert merged_m == m0 + m1 and merged_d == d1
    assert not list(tmp_path.glob(".pepper_candidates_host_*"))
    with pytest.raises(TimeoutError):
        mh.gather_candidate_lists(str(tmp_path), [], [], timeout=0.3)
    monkeypatch.setattr(mh, "_num_hosts", None)
    monkeypatch.setattr(mh, "_host_id", None)
    assert mh.gather_candidate_lists(str(tmp_path), m0, d0) == (m0, d0)


def test_multihost_cli_flags_parse():
    from pepper_tpu_torch.cli.pepper_variant_main import (build_parser,
                                                          config_from_args)
    args = build_parser().parse_args(
        ["call_variant", "-b", "x.bam", "-f", "x.fa", "-o", "out",
         "--ont_r9_guppy5_sup", "--num_hosts", "4", "--host_id", "2"])
    config = config_from_args(args)
    assert config.num_hosts == 4 and config.host_id == 2
    assert config.coordinator_address is None
    args = build_parser().parse_args(
        ["run_inference", "-i", "imgs", "-o", "out", "--num_hosts", "2",
         "--host_id", "0", "--coordinator_address", "10.0.0.1:29500"])
    config = config_from_args(args)
    assert config.coordinator_address == "10.0.0.1:29500"
    assert "torch.distributed" in build_parser()._subparsers._group_actions[
        0].choices["call_variant"].format_help()


@pytest.fixture
def fresh_multihost():
    """The module reloaded before and after: `initialize` keeps its first
    call's identity for the process."""
    importlib.reload(mh)
    yield mh
    importlib.reload(mh)


def test_initialize_validates_host_id(fresh_multihost, monkeypatch):
    monkeypatch.delenv("PEPPER_TPU_NUM_HOSTS", raising=False)
    monkeypatch.delenv("PEPPER_TPU_HOST_ID", raising=False)
    with pytest.raises(ValueError):
        mh.initialize(num_processes=2)               # missing host_id
    importlib.reload(mh)
    with pytest.raises(ValueError):
        mh.initialize(num_processes=2, process_id=5)  # out of range
    importlib.reload(mh)
    mh.initialize(num_processes=2, process_id=1)
    assert (mh.host_count(), mh.host_index()) == (2, 1)
    mh.initialize(num_processes=8, process_id=7)      # idempotent
    assert (mh.host_count(), mh.host_index()) == (2, 1)
    assert mh.process_group() is None
    importlib.reload(mh)
    monkeypatch.setenv("PEPPER_TPU_NUM_HOSTS", "3")
    with pytest.raises(RuntimeError, match="never called"):
        mh.host_count()
    monkeypatch.setenv("PEPPER_TPU_HOST_ID", "2")
    mh.initialize()
    assert (mh.host_count(), mh.host_index(), mh.host_tag()) == \
        (3, 2, "host_2_")


def test_a_group_needs_its_backend_and_a_failed_rendezvous_raises(
        fresh_multihost):
    assert mh.default_backend("cpu") == "gloo"
    assert mh.default_backend("cuda:1") == "nccl"
    with pytest.raises(ValueError, match="backend"):
        mh.initialize("127.0.0.1:1", 2, 1)
    importlib.reload(mh)
    with pytest.raises(ValueError, match="rank"):
        mh.initialize("127.0.0.1:1", backend="gloo")
    importlib.reload(mh)
    # rank 1 of 2 with nobody listening at the coordinator: no fallback
    with pytest.raises(RuntimeError):
        mh.initialize("127.0.0.1:1", 2, 1, backend="gloo", timeout_s=1)
    assert mh.process_group() is None


def test_torchrun_environment_joins_a_group():
    """No arguments under torchrun's environment: the counterpart of the
    TPU pod's auto-detection. Host identity then comes from the group."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from pepper_tpu_torch.parallel import multihost as mh\n"
        "mh.initialize(backend='gloo')\n"
        "assert mh.process_group() is not None\n"
        "print(mh.host_count(), mh.host_index(), repr(mh.host_tag()),\n"
        "      mh.host_shard([0, 1, 2, 3, 4]))\n")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", code],
        env=dict(ENV, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=TIMEOUT)
        finally:
            p.kill()
        assert p.returncode == 0, err.decode()[-3000:]
        outs.append(out.decode().strip())
    assert outs == ["2 0 'host_0_' [0, 2, 4]", "2 1 'host_1_' [1, 3]"]


# ------------------------------------------------ 2-host call_variant
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The 60 kb dataset of tests/test_multihost.py, with a random
    hidden-32 classifier."""
    tmp = str(tmp_path_factory.mktemp("torch_mh"))
    genome = random_genome(60000, seed=31)
    variants = plant_variants(dict(genome), 24, 6, 6, seed=32)
    records = simulate_reads(genome, variants, coverage=35, seed=33)
    fasta, bam = write_dataset(tmp, genome, records)
    truth = write_truth_vcf(os.path.join(tmp, "truth.vcf"), genome, variants)
    model = os.path.join(tmp, "model.npz")
    save_checkpoint(model, init_variant_params(
        torch.Generator().manual_seed(5), hidden=32))
    return dict(tmp=tmp, fasta=fasta, bam=bam, truth=truth, model=model)


def _fields(dataset, out_dir, dry):
    fields = dict(bam=dataset["bam"], fasta=dataset["fasta"],
                  output_dir=out_dir, sub_command="call_variant",
                  ont_r9_guppy5_sup=True, threads=1, region_size=10000)
    if dry:
        fields.update(dry=True, train_mode=True, truth_vcf=dataset["truth"],
                      random_draw_probability=1.0)
    else:
        fields.update(model_path=dataset["model"], threads=2,
                      batch_size=256)
    return fields


def _start_hosts(dataset, out_dir, dry, hosts):
    """Start the port's call_variant as `hosts` processes sharing out_dir
    (one process: no host flags)."""
    procs = []
    tag = os.path.basename(out_dir.rstrip("/"))
    for host in reversed(range(hosts)):
        cfg = _fields(dataset, out_dir, dry)
        cfg["device"] = "cpu"
        if hosts > 1:
            cfg.update(num_hosts=hosts, host_id=host)
        path = os.path.join(dataset["tmp"], f"cfg_{tag}_{host}.json")
        with open(path, "w") as fh:
            json.dump(cfg, fh)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _HOST_RUN.format(root=ROOT), path],
            env=dict(ENV, PEPPER_TPU_MIN_DEVICE_BATCH="256"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    return procs


def _vcf_bytes(out_dir):
    paths = sorted(glob.glob(os.path.join(out_dir, "*.vcf.gz")))
    assert len(paths) == 5, paths
    return {os.path.basename(p): open(p, "rb").read() for p in paths}


def _records(data: bytes):
    lines = gzip.decompress(data).decode().splitlines()
    return ([ln for ln in lines if ln.startswith("#")],
            [ln.split("\t") for ln in lines if not ln.startswith("#")])


def _assert_records_match(got: bytes, want: bytes, name: str) -> int:
    """Identical headers, record order, columns and FORMAT fields; AP
    within 1e-5 (see the module docstring)."""
    got_head, got_recs = _records(got)
    want_head, want_recs = _records(want)
    assert got_head == want_head, name
    assert len(got_recs) == len(want_recs), name
    for g, w in zip(got_recs, want_recs):
        assert g[:9] == w[:9], (name, g, w)
        keys = w[8].split(":")
        gs, ws = (dict(zip(keys, r[9].split(":"))) for r in (g, w))
        for key in keys:
            if key == "AP":
                np.testing.assert_allclose(
                    [float(v) for v in gs[key].split(",")],
                    [float(v) for v in ws[key].split(",")], atol=1e-5,
                    err_msg=f"{name} {g[:5]}")
            else:
                assert gs[key] == ws[key], (name, key, g, w)
    return len(want_recs)


@pytest.mark.parametrize("dry", [True, False], ids=["dry", "real_model"])
def test_two_host_call_variant_matches_one_host_and_jax(dataset, dry,
                                                        monkeypatch):
    tag = "dry" if dry else "model"
    out1 = os.path.join(dataset["tmp"], f"port_1host_{tag}/")
    out2 = os.path.join(dataset["tmp"], f"port_2host_{tag}/")
    procs = (_start_hosts(dataset, out1, dry, 1)
             + _start_hosts(dataset, out2, dry, 2))
    out_jax = os.path.join(dataset["tmp"], f"jax_1host_{tag}/")
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "256")
    monkeypatch.setenv("PEPPER_TPU_CACHE_DIR", "off")
    jax_call_variant(jax_set_parameters(
        JaxPipelineConfig(**_fields(dataset, out_jax, dry))))
    _wait(procs)
    single, double = _vcf_bytes(out1), _vcf_bytes(out2)
    assert single.keys() == double.keys()
    for name in single:
        assert single[name] == double[name], \
            f"{name} differs between the port's 1-host and 2-host runs"
    assert not glob.glob(os.path.join(out2, ".pepper_candidates_host_*"))
    want = _vcf_bytes(out_jax)
    assert want.keys() == double.keys()
    n_records = 0
    for name in want:
        if dry:
            assert double[name] == want[name], \
                f"{name} differs between the port's 2-host and JAX's runs"
        n_records += _assert_records_match(double[name], want[name], name)
    assert n_records >= 10


# ---------------------------------------- data-parallel trainers, 2 ranks
def _rank_cmd(model, data_dir, out, rank=0, world=1, port=None, extra=()):
    cmd = [sys.executable, "-m", "pepper_tpu_torch.parallel.dp_rehearsal",
           model, "--rank", str(rank), "--world", str(world), "--data",
           data_dir, "--steps", "4", "--out", out, "--device", "cpu",
           *extra]
    if world > 1:
        cmd += ["--coordinator", f"127.0.0.1:{port}"]
    return subprocess.Popen(cmd, env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE)


def _start_two_ranks(model, data_dir, tag, extra=()):
    """Start 2 ranks of the rehearsal; returns (processes, their outputs)."""
    port = _free_port()
    outs = [os.path.join(data_dir, f"{tag}_rank{r}.npz") for r in range(2)]
    return ([_rank_cmd(model, data_dir, outs[r], r, 2, port, extra)
             for r in range(2)], outs)


def _assert_ranks_match(ranks, want, what):
    """The JAX test's tolerances (tests/test_multihost.py:280-289); the
    ranks bit-identical."""
    keys = [k for k in want if not k.startswith("__")]
    assert len(keys) >= 16
    for k in keys:
        np.testing.assert_allclose(ranks[0][k], want[k], rtol=5e-3,
                                   atol=1e-4, err_msg=f"{what}: {k}")
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    np.testing.assert_allclose(ranks[0]["__losses__"], want["__losses__"],
                               rtol=1e-4, err_msg=what)
    np.testing.assert_array_equal(ranks[0]["__losses__"],
                                  ranks[1]["__losses__"])


@pytest.fixture(scope="module")
def variant_data(tmp_path_factory):
    """64 rows of 33x26 images (tests/test_multihost.py:252-255) and the
    JAX package's hidden-32 init, as a checkpoint both packages read."""
    data_dir = str(tmp_path_factory.mktemp("dp_variant"))
    rng = np.random.RandomState(17)
    np.save(data_dir + "/images.npy",
            rng.randint(-125, 126, (64, 33, 26)).astype(np.int8))
    np.save(data_dir + "/labels.npy", rng.randint(0, 3, 64))
    tree = jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(0), hidden=32))
    save_checkpoint(data_dir + "/init.npz", tree)
    return data_dir, tree


def test_two_rank_variant_training_with_dropout_matches_one_process(
        variant_data):
    data_dir, _ = variant_data
    procs, outs = _start_two_ranks(
        "variant", data_dir, "dropout",
        ["--dropout", "--init", data_dir + "/init.npz"])
    single = data_dir + "/dropout_single.npz"
    _wait(procs + [_rank_cmd("variant", data_dir, single, extra=[
        "--dropout", "--blocks", "2", "--init", data_dir + "/init.npz"])])
    ranks = [np.load(o) for o in outs]
    single = np.load(single)
    _assert_ranks_match(ranks, single, "2 ranks vs 1 process, dropout on")
    assert len(ranks[0]["__allreduce_ms__"]) == 4   # one per step


def test_two_rank_variant_training_matches_the_jax_step(variant_data):
    """Dropout off (the JAX test's masks cannot be drawn in torch): 2
    ranks of the port against the JAX package's one-process step over the
    global batch on a 2-device mesh (XLA's psum of the two blocks), from
    the same initial parameters."""
    data_dir, tree = variant_data
    procs, outs = _start_two_ranks("variant", data_dir, "nodrop",
                                   ["--init", data_dir + "/init.npz"])
    images = np.load(data_dir + "/images.npy")
    labels = np.load(data_dir + "/labels.npy")
    mesh = data_mesh(jax.devices()[:2])
    optimizer = jax_vt.make_optimizer(weight_decay=1e-6)
    params = replicate(mesh, jax.tree_util.tree_map(jnp.asarray, tree))
    opt_state = optimizer.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(1e-3)
    step = jax_vt.make_train_step(optimizer)
    losses = []
    for s in range(4):
        order = np.random.RandomState(100 + s).permutation(len(images))
        params, opt_state, loss = step(
            params, opt_state,
            shard_batch(mesh, jnp.asarray(images[order], jnp.float32)),
            shard_batch(mesh, jnp.asarray(labels[order], jnp.int32)), None)
        losses.append(float(loss))
    want = dict(vt.sorted_leaves(jax.tree_util.tree_map(np.asarray,
                                                        params)))
    want["__losses__"] = np.asarray(losses)
    _wait(procs)
    _assert_ranks_match([np.load(o) for o in outs], want,
                        "2 ranks vs the JAX step")


@pytest.fixture(scope="module")
def polish_data(tmp_path_factory):
    """8 sequences of 1000 with labels, and a hidden-32 polish model."""
    data_dir = str(tmp_path_factory.mktemp("dp_polish"))
    rng = np.random.default_rng(4)
    x = rng.integers(0, 60, (8, 1000, 10))
    x[rng.random(x.shape) < 0.5] = 0
    np.save(data_dir + "/images.npy", x.astype(np.uint8))
    np.save(data_dir + "/labels.npy",
            rng.integers(0, 5, (8, 1000)).astype(np.uint8))
    params = init_polish_params(torch.Generator().manual_seed(4), hidden=32)
    tree = {g: {k: v.numpy() for k, v in leaves.items()}
            for g, leaves in params.items()}
    save_checkpoint(data_dir + "/init.npz", tree)
    return data_dir, tree


def test_two_rank_polish_training_matches_one_process_and_jax(polish_data):
    """4 window steps, the hidden carried per rank: 2 ranks against the
    port's one process and against the JAX package's step over all 8
    sequences."""
    data_dir, tree = polish_data
    init = ["--init", data_dir + "/init.npz"]
    procs, outs = _start_two_ranks("polish", data_dir, "polish", init)
    single = data_dir + "/polish_single.npz"
    procs.append(_rank_cmd("polish", data_dir, single, extra=init))

    x = np.load(data_dir + "/images.npy").astype(np.float32)
    y = np.load(data_dir + "/labels.npy").astype(np.int32)
    optimizer = jax_vt.make_optimizer(weight_decay=1e-6)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = optimizer.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(1e-3)
    step = jax_pt.make_polish_train_step(optimizer)
    hidden = jnp.zeros((8, 2, 32), jnp.float32)
    losses = []
    for i in range(0, 200, 50):
        params, opt_state, hidden, loss = step(
            params, opt_state, jnp.asarray(x[:, i:i + 100]),
            jnp.asarray(y[:, i:i + 100]), hidden)
        losses.append(float(loss))
    want = dict(vt.sorted_leaves(jax.tree_util.tree_map(np.asarray,
                                                        params)))
    want["__losses__"] = np.asarray(losses)
    _wait(procs)
    ranks = [np.load(o) for o in outs]
    _assert_ranks_match(ranks, np.load(single), "2 ranks vs 1 process")
    _assert_ranks_match(ranks, want, "2 ranks vs the JAX step")


def test_torchrun_trains_the_variant_model_data_parallel(tmp_path):
    """`torchrun --nproc_per_node 2` of the trainer CLI on the CPU (gloo):
    the two ranks join one group, rank 0 alone writes the stats and the
    checkpoints, and the first step's loss (before any update: the global
    batch's summed loss) equals a one-process run's."""
    from pepper_tpu_torch.encode.region_encoder import CandidateBatch
    from pepper_tpu_torch.pipelines.datastore import ImageStore

    rng = np.random.default_rng(13)
    labels = rng.integers(0, 3, 64)
    images = rng.integers(-125, 126, (64, 5, 6)).astype(np.int8)
    images[:, :, 0] = (labels * 40)[:, None]
    with ImageStore(str(tmp_path / "imgs.hdf5"), "w") as store:
        for si, lo in enumerate(range(0, 64, 16)):
            n = 16
            store.write_summary(f"s{si}", CandidateBatch(
                "c1", np.arange(lo, lo + n), np.full(n, 30, np.int32),
                ["1A"] * n, np.full(n, 10, np.int32), images[lo:lo + n],
                np.zeros(n, np.int32), labels[lo:lo + n].astype(np.int32)),
                train_mode=True)
    args = ["-m", "pepper_tpu_torch.cli.pepper_variant_train_main",
            "train_model", "--train_image_dir", str(tmp_path),
            "--test_image_dir", str(tmp_path), "-bs", "16", "--epoch_size",
            "1", "--step_size", "2", "--device", "cpu"]
    runs = {"ranks": [sys.executable, "-m", "torch.distributed.run",
                      "--nproc_per_node", "2", "--master_port",
                      str(_free_port())],
            "single": [sys.executable]}
    procs = [subprocess.Popen(cmd + args + ["-o", str(tmp_path / tag)],
                              env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for tag, cmd in runs.items()]
    _wait(procs)
    losses = {}
    for tag in runs:
        stats = glob.glob(str(tmp_path / tag / "stats_*"))
        assert len(stats) == 1, stats           # rank 0 alone writes
        with open(os.path.join(stats[0], "train_loss.csv")) as fh:
            losses[tag] = [float(ln.split(",")[2]) for ln in fh]
        assert os.path.exists(tmp_path / tag / "PEPPER_VARIANT_BEST.npz")
    assert len(losses["ranks"]) == len(losses["single"]) == 2
    np.testing.assert_allclose(losses["ranks"][0], losses["single"][0],
                               rtol=1e-5)
