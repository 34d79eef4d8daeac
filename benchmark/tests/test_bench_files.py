"""The benchmark's files: BENCHMARK.json against the data files it names,
the metric readers' declarations, the configurations' weights, the frozen
arithmetic, and the isolation of the reference from the program."""
import ast
import json
import os
import re
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import harness, roofline  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = ([c["name"] for c in SPEC["configs"]] + CELLS + METRICS
             + [m["name"] for m in SPEC["end_to_end"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    work = harness.cell(cell)
    conf = harness.config(work["config"])
    assert conf["name"] == work["config"]
    assert hasattr(harness.entry(work["entry"]), "run")
    assert work["chips"] == 1 and len(work["why"]) <= 200
    assert work["metric"] in harness.reports(cell)
    assert "setup_s" in harness.reports(cell)
    assert harness.per_layer(cell), "every cell reports a per-layer metric"
    assert set(work["limits"]) and all(v >= 0 for v in
                                       work["limits"].values())


@pytest.mark.parametrize("name", METRICS)
def test_metric_files(name):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == name)
    reader = harness.metric_reader(name)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES,
            reader.WORKLOADS) == (entry["layer"], entry["unit"],
                                  entry["source"], entry["moves"],
                                  entry["workloads"])
    assert UNIT.match(entry["unit"])
    for cell in entry["workloads"]:
        assert entry["moves"] in harness.reports(cell), (name, cell)
    assert reader.read({}) is None, "a reader with nothing to read is silent"


@pytest.mark.parametrize("config", sorted(
    f[:-5] for f in os.listdir(os.path.join(ROOT, "benchmark", "configs"))))
def test_config_weights(config):
    """Every configuration file's weights (also those of a configuration
    no cell uses yet) load, match their sha256 and their stated size."""
    conf = harness.config(config)
    entry = next((c for c in SPEC["configs"] if c["name"] == config), None)
    if entry is not None:
        assert entry["file"] == f"benchmark/configs/{config}.json"
        assert entry["source"] == conf["source"]
        assert entry["reduced"] == conf["reduced"] == []
    weights = harness.load_weights(conf)
    assert sum(a.size for a in weights.values()) == conf["parameters"]
    assert all(a.dtype == np.float32 and np.isfinite(a).all()
               for a in weights.values())


def test_roofline_reproduces_the_recorded_bounds():
    """PERF.md's table of kernels: K1 0.827 ms at 16384 rows in bf16, 161.3
    MFLOP a classifier window."""
    r = roofline
    assert round(r.k1_bound_ms(16384, 33, 2, r.PEAK_BF16)[0], 3) == 0.827
    flops = r.forward_flops_per_window(
        r.classifier_shapes(26, 33, 256, 512, 5, 3), 33)
    assert round(flops / 1e6, 1) == 161.3


def test_planted_variants_spread_over_the_genome():
    """At Mbp scale the planted count is the whole genome's, split over the
    contigs, and each contig's share lies all along it."""
    from benchmark.traffic.synth import plant_variants, random_genome
    genome = dict(random_genome(400_000, seed=3, n_contigs=5))
    variants = plant_variants(genome, 3200, 400, 400, seed=4)
    assert len(variants) == 4000
    kinds = [v.kind for v in variants]
    assert (kinds.count("snp"), kinds.count("ins"), kinds.count("del")) \
        == (3200, 400, 400)
    for contig, seq in genome.items():
        pos = np.array([v.pos for v in variants if v.contig == contig])
        assert len(pos) == 800 and np.all(np.diff(pos) > 20)
        thirds = np.bincount(pos * 3 // len(seq), minlength=3)
        assert thirds.min() > 200, thirds


def test_variant_gaps_compare_the_open_ranges_alone():
    """A site the reference calls at an interval's first or last position,
    which `vcf_sites` leaves out of the program's records, is not compared;
    one inside the interval that the program lacks is."""
    from benchmark.reference import compare
    iv = ("c1", 100, 200)

    def site(nap):
        probs = np.array([1 - nap, nap, 0.0])
        return {"present": True, "record": None,
                "cands": [{"probs": probs, "nap": nap, "thr": 0.1,
                           "passed": True}]}
    edges = {iv: {100: site(0.9), 200: site(0.9)}}
    assert compare.variant_gaps({iv: {}}, edges)["site_gap"] == 0.0
    inside = {iv: {150: site(0.9)}}
    assert compare.variant_gaps({iv: {}}, inside)["site_gap"] \
        == pytest.approx(0.8)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("folder", ["reference", "traffic"])
def test_reference_imports_nothing_of_the_program(folder):
    base = os.path.join(ROOT, "benchmark", folder)
    for name in os.listdir(base):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(base,
                                                                   name))}
            assert not tops & {"pepper_tpu_torch", "pepper_tpu", "jax",
                               "jaxlib", "flax"}, (folder, name, tops)


@pytest.mark.parametrize("loaded,flagged", [
    (["pepper_tpu_torch", "pepper_tpu_torch.ops.fused_lstm"], []),
    (["pepper_tpu.models"], ["pepper_tpu"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["jax_helpers", "flaxen", "pepper_tpu_tools"], []),
    (["flax.linen"], ["flax"]),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, loaded,
                                                   flagged):
    fake = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in harness.FORBIDDEN}
    fake.update({name: object() for name in loaded})
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_loaded() == flagged


def test_sub_seeds_take_any_whole_number():
    for seed in (0, 1, 2 ** 31 + 5, 2 ** 40 + 3, 10 ** 12):
        s = harness.sub_seeds(seed, 4)
        assert len(s) == 4 and all(0 <= v < 2 ** 31 for v in s)
        assert s == harness.sub_seeds(seed, 4)
