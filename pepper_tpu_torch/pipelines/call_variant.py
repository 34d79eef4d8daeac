"""End-to-end `call_variant` pipeline driver.

Parity: pepper_variant/modules/python/CallVariant.py:12-109 — validate
inputs, create run-id'd stage directories, run make-images -> inference ->
find-candidates. Every stage writes file artifacts so any stage can be
re-run standalone (the de-facto checkpoint/resume system).
"""
import os
import sys
import time
from datetime import datetime

from pepper_tpu_torch.options import PipelineConfig
from pepper_tpu_torch.pipelines.find_candidates import process_candidates
from pepper_tpu_torch.pipelines.make_images import generate_images
from pepper_tpu_torch.runtime.inference import run_inference
from pepper_tpu_torch.utils import streamstats


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def validate_inputs(config: PipelineConfig) -> None:
    """CallVariant.py:20-72."""
    if not os.path.isfile(config.bam):
        raise FileNotFoundError(f"BAM file {config.bam} does not exist")
    with open(config.bam, "rb") as fh:
        if fh.read(4) == b"CRAM":
            raise ValueError(
                f"{config.bam} is a CRAM file — CRAM input is not "
                f"supported (the reference accepts it via htslib's "
                f"auto-detection); convert it first with: samtools view "
                f"-b -o <out.bam> {config.bam}")
    if not os.path.isfile(config.bam + ".bai") and not os.path.isfile(
            config.bam.rsplit(".", 1)[0] + ".bai"):
        raise FileNotFoundError(f"BAM index {config.bam}.bai does not exist")
    if not os.path.isfile(config.fasta):
        raise FileNotFoundError(f"FASTA file {config.fasta} does not exist")
    if not os.path.isfile(config.fasta + ".fai"):
        raise FileNotFoundError(f"FASTA index {config.fasta}.fai does not exist")
    if not config.dry and config.model_path and not os.path.isfile(config.model_path):
        raise FileNotFoundError(f"Model file {config.model_path} does not exist")
    if config.train_mode and not config.truth_vcf:
        raise ValueError("train_mode requires --truth_vcf")


def call_variant(config: PipelineConfig) -> dict:
    """Run the 3-stage pipeline; returns the output VCF paths.

    The model forward runs on `config.device` ("cuda" by default); asking
    for CUDA where there is none raises before any stage starts. Several
    hosts (--num_hosts/--host_id, or a torch.distributed coordinator)
    each run their stripe of the regions and host 0 writes the VCFs after
    the candidate gather (parallel/multihost.py).

    The job is one accounting epoch of utils/streamstats.py: from entry to
    return the calling thread is in one `main.*` state at a time
    (`main.job_head` until the stream hands regions to its encode
    threads; a staged job, which has no stream, spends all of it there)."""
    stats = streamstats.reset()
    stats.state("main.job_head")
    try:
        vcf_paths = _call_variant(config, stats)
    finally:
        stats.state(None)
    _log("DISPATCH STATES (wall seconds): " + stats.summary(states=True))
    return vcf_paths


def _call_variant(config: PipelineConfig, stats) -> dict:
    from pepper_tpu_torch.parallel import multihost
    from pepper_tpu_torch.runtime.streaming import resolve_device

    start_time = time.time()
    multihost.initialize_from_config(config)
    validate_inputs(config)
    if not config.dry:
        resolve_device(config.device)
    timestr = time.strftime("%m%d%Y_%H%M%S")
    if multihost.host_count() > 1:
        # clocks may agree: keep per-host run dirs collision-free
        timestr += f"_host{multihost.host_index()}"
    output_dir = config.output_dir
    if not output_dir.endswith("/"):
        output_dir += "/"
    os.makedirs(output_dir, exist_ok=True)
    image_dir = output_dir + f"images_{timestr}/"
    prediction_dir = output_dir + f"predictions_{timestr}/"

    from pepper_tpu_torch.utils.profiling import stage

    _log(f"RUN-ID: {timestr}")
    if config.streaming and not config.dry and not config.train_mode:
        # fused stage 1+2: encode streams into device inference with no
        # file barrier (runtime/streaming.py); the chip never waits for the
        # full host encode. Replaces the staged file boundary of the
        # reference (CallVariant.py:84-104).
        from pepper_tpu_torch.pipelines.find_candidates import (
            StreamingCandidateCollector, finalize_candidates,
            log_candidate_totals, make_ordered_emitter)
        from pepper_tpu_torch.pipelines.make_images import build_intervals
        from pepper_tpu_torch.runtime.streaming import stream_inference

        _log("STEP 1+2+3/3 STREAMING IMAGES INTO INFERENCE AND CANDIDATES:")
        os.makedirs(prediction_dir, exist_ok=True)
        intervals = build_intervals(config)
        # lexicographic (contig, start) = the final VCF record order, so
        # the single-host stream can emit records at the watermark
        intervals.sort(key=lambda iv: (iv[0], iv[1]))
        if multihost.host_count() > 1:
            intervals = multihost.host_shard(intervals)
            _log(f"HOST {multihost.host_index()}/{multihost.host_count()}: "
                 f"{len(intervals)} INTERVALS IN SHARD")
        image_store_path = None
        if config.keep_image_artifacts:
            os.makedirs(image_dir, exist_ok=True)
            image_store_path = image_dir + "pepper_variants_images_" \
                + multihost.host_tag() + "streamed.hdf5"
        prediction_path = prediction_dir + (
            f"pepper_predictions_{multihost.host_tag()}0.hdf"
            if multihost.host_count() > 1 else "pepper_predictions.hdf")
        # stage 3 consumes prediction batches as they flush — the gates run
        # on a collector thread behind the device. Single host: final VCF
        # records are emitted behind the device too (interval watermark) —
        # nothing remains after the stream but closing the files.
        # Multi-host: the cross-host gather + host-0 write remain.
        emitter = None
        if multihost.host_count() == 1:
            emitter = make_ordered_emitter(config, output_dir, intervals)
        collector = StreamingCandidateCollector(config, emitter)
        # per-region resume journal: lives in the STABLE output dir (the
        # prediction dir is run-stamped), one per host; deleted only after
        # the VCFs are fully written
        journal_path = None
        if getattr(config, "resume", True):
            journal_path = (output_dir + "pepper_stream_"
                            + multihost.host_tag() + "resume.journal")
        t3 = time.time()
        try:
            with stage("stream_encode_inference"):
                stream_inference(config, intervals, prediction_path,
                                 image_store_path,
                                 candidate_collector=collector,
                                 resume_journal=journal_path)
            # the stream returns in main.stage3_drain
            margin_all, dv_all = collector.finish()
        except BaseException:
            # a crashed stream must not leave truncated .vcf.gz files with
            # no .tbi looking like real output — delete the partials (the
            # resume journal survives for the next run). Order matters:
            # stop the collector FIRST so nothing is mid-write into the
            # native sink when abort() frees its file handles.
            collector.abort()
            if emitter is not None:
                emitter.abort()
            raise
        stats.state("main.vcf_close")
        with stage("find_candidates"):
            if emitter is not None:
                totals, vcf_paths = emitter.finish()
                log_candidate_totals(totals, t3)
            else:
                vcf_paths = finalize_candidates(config, output_dir,
                                                margin_all, dv_all, t3)
        stats.state("main.job_rest")
        if journal_path and os.path.exists(journal_path):
            os.remove(journal_path)   # run complete: nothing to resume
    else:
        _log("STEP 1/3 GENERATING IMAGES:")
        config.image_output_directory = image_dir
        with stage("make_images"):
            generate_images(config)

        _log("STEP 2/3 RUNNING INFERENCE")
        with stage("inference"):
            run_inference(config, image_dir, prediction_dir)

        _log("STEP 3/3 FINDING CANDIDATES")
        with stage("find_candidates"):
            vcf_paths = process_candidates(config, prediction_dir,
                                           output_dir)

    elapsed = time.time() - start_time
    _log(f"TOTAL ELAPSED TIME: {int(elapsed // 60)} Min {int(elapsed % 60)} Sec")
    return vcf_paths
