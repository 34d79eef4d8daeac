"""The port's HP second pass (48-feature dual-haplotype images, 21x48
windows) against the JAX package's, on the CPU.

Mirrors of tests/test_hp.py (the feature index, HP routing of SNP supports,
positive indel counts, the dry pipeline recalling every planted variant)
and tests/test_native_encode.py's HP parity (the native HP encoder
bit-equal to the Python one), plus: the port's and JAX's Python
`RegionalSummaryHP` give bit-equal images on the same reads, and the
port's streamed `call_variant --use_hp_info` writes the same VCF records as
the JAX one with one 48-feature model (every column equal, AP allclose at
1e-5: AP prints probabilities with .6g and the two frameworks sum in
different orders).
"""
import glob
import gzip
import os

import numpy as np
import pytest
import torch

from pepper_tpu.encode.region_encoder_hp import \
    RegionalSummaryHP as JaxRegionalSummaryHP
from pepper_tpu.options import PipelineConfig as JaxPipelineConfig
from pepper_tpu.pipelines.call_variant import call_variant as jax_call_variant
from pepper_tpu.presets import set_parameters as jax_set_parameters
from pepper_tpu_torch.encode.region_encoder import TruthRecord
from pepper_tpu_torch.encode.region_encoder_hp import (RegionalSummaryHP,
                                                       _feature_index_hp)
from pepper_tpu_torch.io.bam_reader import BamReader, TrimmedRead
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.io.sam import FLAG_REVERSE, OP_D, OP_I, OP_M
from pepper_tpu_torch.io.vcf import get_truth_records, read_vcf
from pepper_tpu_torch.models.checkpoint import save_checkpoint
from pepper_tpu_torch.models.variant_model import init_variant_params
from pepper_tpu_torch.native import encoder
from pepper_tpu_torch.options import ImageOptionsHP, PipelineConfig
from pepper_tpu_torch.pipelines.call_variant import call_variant
from pepper_tpu_torch.presets import set_parameters
from pepper_tpu_torch.utils.synth import (plant_variants, random_genome,
                                          simulate_reads, write_dataset,
                                          write_truth_vcf)

BATCH = 8   # several flushes on a small genome

KW = dict(min_snp_baseq=1, min_indel_baseq=1, snp_freq_threshold=0.10,
          insert_freq_threshold=0.15, delete_freq_threshold=0.15,
          min_coverage_threshold=2, snp_candidate_freq_threshold=0.10,
          indel_candidate_freq_threshold=0.10,
          candidate_support_threshold=2, skip_indels=False)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain recurrences issue thousands of tiny ops; one thread per
    test worker keeps the file's run time the same under load as alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mk_hp_read(pos, seq, cigar, hp_tag, reverse=False, name="r"):
    ref_len = sum(n for op, n in cigar if op in (OP_M, OP_D))
    return TrimmedRead(query_name=name, pos=pos, pos_end=pos + ref_len,
                       sequence=seq, base_qualities=[30] * len(seq),
                       cigar_tuples=list(cigar), mapping_quality=60,
                       flags=FLAG_REVERSE if reverse else 0, hp_tag=hp_tag,
                       bad_indices=[])


def _summary(reads, ref, start, end):
    return RegionalSummaryHP("c1", start, end, ref).generate_summary(
        reads, candidate_region_start=0, candidate_region_end=10 ** 12,
        **KW)


def test_feature_index_hp_blocks():
    assert _feature_index_hp("A", "C", False, 1) == 9
    assert _feature_index_hp("A", "C", True, 1) == 20
    assert _feature_index_hp("A", "C", False, 2) == 31
    assert _feature_index_hp("A", "C", True, 2) == 42
    assert _feature_index_hp("N", "C", False, 1) == -1


def test_hp_routing_snp_supports():
    ref = "ACGT" * 25
    site = 50   # 'G'
    alt = ref[40:site] + "T" + ref[site + 1:70]
    reads = [mk_hp_read(40, alt, [(OP_M, 30)], hp_tag=1, name=f"h1_{i}")
             for i in range(3)]
    reads += [mk_hp_read(40, ref[40:70], [(OP_M, 30)], hp_tag=2,
                         name=f"h2_{i}") for i in range(3)]
    reads.append(mk_hp_read(40, alt, [(OP_M, 30)], hp_tag=0, name="h0"))
    out = _summary(reads, ref, 0, 99)
    assert len(out) == 1 and out[0].candidates == ["1T"]
    img, mid = out[0].image, 10   # window 21
    # HP1 fwd support: 3 hp1 reads + the untagged one; HP2: the untagged one
    assert img[mid, 5] == 4 and img[mid, 27] == 1
    assert img[mid, 16] == 0 and img[mid, 38] == 0
    # REFF of each block: its own reads plus the untagged one
    assert img[mid, 4] == -4 and img[mid, 26] == -4
    # the ref base's column counts only reads matching it (hp2's, block 2)
    assert img[mid, 32] == -3 and img[mid, 10] == 0


def test_hp_positive_indel_counts():
    ref = "ACGT" * 10
    anchor = 19
    seq = ref[5:anchor + 1] + "GG" + ref[anchor + 1:35]
    reads = [mk_hp_read(5, seq, [(OP_M, anchor + 1 - 5), (OP_I, 2),
                                 (OP_M, 35 - anchor - 1)], hp_tag=1,
                        name=f"i{i}") for i in range(4)]
    ins = [c for c in _summary(reads, ref, 0, 39)
           if c.candidates[0].startswith("2")]
    assert len(ins) == 1
    img, mid = ins[0].image, 10
    assert img[mid, 2] == 3           # allele length
    assert img[mid, 6] == 4           # HP1 fwd support
    assert img[mid, 28] == 0          # HP2 untouched
    assert img[mid, 12] == 4          # the insert count column is positive


@pytest.fixture(scope="module")
def hp_data(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_hp"))
    genome = random_genome(20000, seed=61)
    variants = plant_variants(dict(genome), 8, 4, 4, seed=62)
    records = simulate_reads(genome, variants, coverage=30, seed=63,
                             error_rate=0.05, hp_tags=True)
    fasta, bam = write_dataset(tmp, genome, records)
    truth = write_truth_vcf(tmp + "/truth.vcf", genome, variants)
    return dict(tmp=tmp, fasta=fasta, bam=bam, truth=truth,
                variants=variants)


def _python_hp_summaries(data, train, cls=RegionalSummaryHP):
    """(reads' region, summaries) of the whole contig through a Python HP
    encoder class, as tests/test_native_encode.py drives it."""
    start, end = 0, 19999
    fetch_stop = end + 1 if train else end
    with BamReader(data["bam"]) as bam, FastaReader(data["fasta"]) as fa:
        ref_seq = fa.get_reference_sequence("contig1", start, end + 1)
        reads = bam.get_reads("contig1", start, fetch_stop, False, 5, 1,
                              backend="python")
        hap1 = hap2 = []
        if train:
            h1, h2 = get_truth_records(data["truth"], "contig1", start, end)
            hap1 = [TruthRecord(*t) for t in h1]
            hap2 = [TruthRecord(*t) for t in h2]
        rs = cls("contig1", start, end, ref_seq)
        if train:
            rs.generate_labels(hap1, hap2)
        out = rs.generate_summary(
            reads, candidate_region_start=start + 100,
            candidate_region_end=end - 100, train_mode=train, **KW)
        ref_id = bam._ref_ids["contig1"]
        chunks = bam._index.chunks_for(ref_id, start, fetch_stop)
    return out, dict(chunks=chunks, ref_id=ref_id, ref_seq=ref_seq,
                     fetch_stop=fetch_stop, hap1=hap1, hap2=hap2)


def _assert_same_candidates(got, want, int8=False):
    assert len(got) == len(want) > 5
    for a, b in zip(got, want):
        assert (a.contig, a.position, a.depth, a.candidates,
                a.candidate_frequency, a.base_label, a.type_label) == \
            (b.contig, b.position, b.depth, b.candidates,
             b.candidate_frequency, b.base_label, b.type_label)
        ga, gb = np.asarray(a.image), np.asarray(b.image)
        assert ga.shape == (21, 48)
        if int8:   # the native encoder emits int8 (numpy astype wrap)
            ga = ga.astype(np.int8)
            assert gb.dtype == np.int8
        np.testing.assert_array_equal(ga, gb)


@pytest.mark.parametrize("train", [False, True])
def test_python_hp_encoder_matches_jax(hp_data, train):
    got, _ = _python_hp_summaries(hp_data, train)
    want, _ = _python_hp_summaries(hp_data, train, JaxRegionalSummaryHP)
    _assert_same_candidates(got, want)
    if train:
        assert any(c.type_label > 0 for c in got)


@pytest.mark.skipif(not encoder.available(), reason="native build failed")
@pytest.mark.parametrize("train", [False, True])
def test_hp_native_matches_python_oracle(hp_data, train):
    py, ctx = _python_hp_summaries(hp_data, train)
    nat = encoder.encode_region_native(
        hp_data["bam"], ctx["chunks"], ctx["ref_id"], "contig1", 0,
        ctx["fetch_stop"], 0, 19999, ctx["ref_seq"],
        include_supplementary=False, min_mapq=5, candidate_region_start=100,
        candidate_region_end=19899, train_mode=train, hap1=ctx["hap1"],
        hap2=ctx["hap2"], hp_mode=True,
        window_size=ImageOptionsHP.CANDIDATE_WINDOW_SIZE,
        feature_size=ImageOptionsHP.IMAGE_HEIGHT, **KW)
    _assert_same_candidates(py, nat, int8=True)


def test_hp_pipeline_end_to_end_dry(tmp_path):
    """The staged dry run (oracle predictions from the train labels) on 21x48
    images recalls every planted variant."""
    from pepper_tpu_torch.pipelines.datastore import ImageStore
    from pepper_tpu_torch.pipelines.find_candidates import process_candidates
    from pepper_tpu_torch.pipelines.make_images import generate_images
    from pepper_tpu_torch.runtime.inference import run_inference

    tmp = str(tmp_path)
    genome = random_genome(15000, seed=81)
    variants = plant_variants(dict(genome), 5, 2, 2, seed=82)
    fasta, bam = write_dataset(tmp, genome, simulate_reads(
        genome, variants, coverage=35, seed=83, hp_tags=True))
    truth = write_truth_vcf(tmp + "/truth.vcf", genome, variants)
    config = set_parameters(PipelineConfig(
        bam=bam, fasta=fasta, output_dir=tmp + "/out/",
        sub_command="call_variant", ont_r9_guppy5_sup=True, threads=1,
        dry=True, train_mode=True, truth_vcf=truth, use_hp_info=True,
        random_draw_probability=1.0, device="cpu",
        image_output_directory=tmp + "/images/"))
    generate_images(config)
    files = [f for f in os.listdir(tmp + "/images/") if "_hp" in f]
    assert files
    with ImageStore(tmp + "/images/" + files[0]) as store:
        s = store.read_summary(store.summary_names()[0])
        assert s["images"].shape[1:] == (21, 48)
    run_inference(config, tmp + "/images/", tmp + "/preds/")
    paths = process_candidates(config, tmp + "/preds/", tmp + "/out/")
    by_pos = {(r.contig, r.pos): r for r in read_vcf(paths["full"])}
    missed = [v for v in variants if (v.contig, v.pos) not in by_pos
              or v.alt not in by_pos[(v.contig, v.pos)].alts]
    assert not missed, missed


@pytest.fixture(scope="module")
def hp_model(hp_data):
    """One 48-feature classifier (21x48 windows, hidden 32) as a numpy tree
    in an .npz both packages load."""
    params = init_variant_params(torch.Generator().manual_seed(64),
                                 image_features=48, window=21, hidden=32)
    path = os.path.join(hp_data["tmp"], "hp_model.npz")
    save_checkpoint(path, {g: {k: v.numpy() for k, v in leaves.items()}
                           for g, leaves in params.items()}, {})
    return path


def _fields(data, model, out_dir):
    return dict(bam=data["bam"], fasta=data["fasta"], output_dir=out_dir,
                model_path=model, sub_command="call_variant",
                ont_r9_guppy5_sup=True, threads=2, region_size=10000,
                batch_size=BATCH, use_hp_info=True)


def _records(path):
    with gzip.open(path, "rt") as fh:
        lines = fh.read().splitlines()
    return ([ln for ln in lines if ln.startswith("#")],
            [ln.split("\t") for ln in lines if not ln.startswith("#")])


def test_streamed_hp_call_variant_matches_jax(hp_data, hp_model,
                                              monkeypatch):
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", str(BATCH))
    port_out = hp_data["tmp"] + "/port_hp/"
    jax_out = hp_data["tmp"] + "/jax_hp/"
    paths = call_variant(set_parameters(PipelineConfig(
        **_fields(hp_data, hp_model, port_out), device="cpu")))
    jax_call_variant(jax_set_parameters(JaxPipelineConfig(
        **_fields(hp_data, hp_model, jax_out))))
    assert set(paths) == {"full", "pepper", "vc", "vc_snp", "vc_indel"}
    names = sorted(os.path.basename(p)
                   for p in glob.glob(jax_out + "*.vcf.gz"))
    assert len(names) == 5
    n_records = 0
    for name in names:
        want_head, want = _records(jax_out + name)
        got_head, got = _records(port_out + name)
        assert got_head == want_head and len(got) == len(want), name
        for g, w in zip(got, want):
            assert g[:9] == w[:9], (name, g, w)
            keys = w[8].split(":")
            gs = dict(zip(keys, g[9].split(":")))
            ws = dict(zip(keys, w[9].split(":")))
            for key in keys:
                if key == "AP":
                    np.testing.assert_allclose(
                        [float(v) for v in gs[key].split(",")],
                        [float(v) for v in ws[key].split(",")], atol=1e-5)
                else:
                    assert gs[key] == ws[key], (name, key, g, w)
        n_records += len(want)
    assert n_records >= 10


def test_cli_call_variant_with_hp_info_on_the_cpu(hp_data, hp_model,
                                                  monkeypatch):
    from pepper_tpu_torch.cli.pepper_variant_main import main
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", str(BATCH))
    out = hp_data["tmp"] + "/port_hp_cli/"
    assert main(["call_variant", "-b", hp_data["bam"], "-f", hp_data["fasta"],
                 "-o", out, "-m", hp_model, "--ont_r9_guppy5_sup", "-t", "2",
                 "--region_size", "10000", "-bs", str(BATCH), "--use_hp_info",
                 "--device", "cpu"]) == 0
    full = read_vcf(out + "PEPPER_VARIANT_FULL.vcf.gz")
    assert len(full) >= 10


def test_make_train_images_with_hp_info_trains_a_48_feature_model(hp_data,
                                                                  tmp_path):
    """`pepper_variant_train make_train_images --use_hp_info` writes _hp
    image stores of 21x48 windows, and the trainer builds a 48-feature
    classifier from them (its first layer's W_ih is [1024, 48])."""
    from pepper_tpu_torch.cli.pepper_variant_train_main import main
    from pepper_tpu_torch.models.checkpoint import load_checkpoint
    from pepper_tpu_torch.pipelines.datastore import ImageStore

    images = str(tmp_path / "hp_images")
    assert main(["make_train_images", "-b", hp_data["bam"], "-f",
                 hp_data["fasta"], "-o", images, "-tv", hp_data["truth"],
                 "-p", "1.0", "--ont_r9_guppy5_sup", "--use_hp_info",
                 "--region_size", "10000"]) == 0
    files = sorted(glob.glob(os.path.join(images, "*_hp.hdf5")))
    assert files
    with ImageStore(files[0]) as store:
        s = store.read_summary(store.summary_names()[0], train_mode=True)
        assert s["images"].shape[1:] == (21, 48)
        assert "type_label" in s
    models = str(tmp_path / "models")
    assert main(["train_model", "--train_image_dir", images,
                 "--test_image_dir", images, "-o", models, "-bs", "8",
                 "--epoch_size", "1", "--step_size", "2",
                 "--device", "cpu"]) == 0
    params, meta = load_checkpoint(os.path.join(models,
                                                "PEPPER_VARIANT_BEST.npz"))
    assert params["encoder"]["weight_ih_l0"].shape == (1024, 48)
    assert params["linear_1"]["weight"].shape == (512, 2 * 256 * 21)
    assert meta["step"] == 2
