"""Fused polish stages 1+2: pileup encode on host threads WHILE the
device runs the consensus window/vote loop.

The staged driver (polish/pipeline.py) materializes every pileup image
HDF5 before consensus starts — the device idles for the whole host
encode, exactly the barrier the variant side's runtime/streaming.py
removed. Here
producer threads run the fused native polish encoder (GIL released:
fetch + downsample + realign + pileup in one C++ call), a bounded queue
feeds fixed-shape device batches of 1000-length sequences
(polish/consensus.py ConsensusRunner: uint8 from pinned memory, one CUDA
stream, labels back by an event-completed copy), and the prediction store
is written behind the device. The stitch streams too:
flushed predictions feed stitch.StreamingStitcher, which writes each
contig to the FASTA as soon as its last interval flushes (contig
watermark) — by the stream's end only the final contig's write remains.
The streamed and staged pipelines produce identical polished FASTAs
(CI-enforced, tests/test_polish.py).

Image HDF5s become optional artifacts (`image_store_path`), as on the
variant side — kept for stage re-runnability, never a barrier. Without h5py
the prediction artifact is skipped (loudly): the polished FASTA does not
depend on it, since the stitcher gets the predictions directly.
"""
import os
import queue
import sys
import threading
import time
from datetime import datetime
from typing import List, Optional

import numpy as np

from pepper_tpu_torch.io.bam_reader import BamReader
from pepper_tpu_torch.io.fasta import FastaReader
from pepper_tpu_torch.pipelines.datastore import h5py_available
from pepper_tpu_torch.polish.datastore import (PolishImageStore,
                                               PolishPredictionStore)
from pepper_tpu_torch.polish.make_images import (
    build_polish_intervals, create_polish_summaries_multi,
    split_position_index)
from pepper_tpu_torch.utils import streamstats


def _log(msg: str) -> None:
    sys.stderr.write("[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
                     + "] INFO: " + msg + "\n")
    sys.stderr.flush()


def _chunk_meta(region, positions_i, chunk_id):
    """Flat chunk metadata tuple with (position, index) arrays."""
    position, index = split_position_index(positions_i)
    contig, start, end = region
    return (contig, start, end, chunk_id, position, index)


def stream_polish(bam_file: str, draft_file: str, model_path: str,
                  prediction_path: str,
                  image_store_path: Optional[str] = None,
                  region: Optional[str] = None, threads: int = 1,
                  batch_size: int = 128,
                  realignment_flag: bool = True,
                  stitcher=None,
                  resume_journal: Optional[str] = None,
                  device="cuda") -> int:
    """Encode 1kb draft intervals and run consensus inference concurrently;
    writes the prediction store consumed by perform_stitch. Returns the
    number of 1000-length sequences inferred.

    stitcher: optional StreamingStitcher — flushed predictions also feed
    the contig-watermark stitch, so the polished FASTA is written behind
    the device and the post-hoc store-read stitch pass disappears.

    resume_journal: optional path to a crash-safe per-interval journal
    (runtime/resume.py, "pseq" records): a killed run resumes by
    replaying completed intervals' consensus sequences from the journal
    instead of re-encoding them; the polished FASTA is byte-identical to
    an uninterrupted run. The caller deletes the file on success.

    device: torch device of the consensus model ("cuda" by default; "cuda"
    with no CUDA device raises)."""
    from pepper_tpu_torch.polish.consensus import (ConsensusRunner,
                                                   pad_consensus_batch)
    from pepper_tpu_torch.runtime.inference import _load_model_params

    runner = ConsensusRunner(_load_model_params(model_path), device)

    intervals = build_polish_intervals(draft_file, bam_file, region)
    _log(f"TOTAL INTERVALS: {len(intervals)}")

    journal = None
    skip: dict = {}
    replayed: list = []
    if resume_journal is not None:
        from pepper_tpu_torch.runtime import resume as rj
        inputs = (bam_file, draft_file)
        # a journal written on another dtype or with the other realignment
        # flag is not replayed
        setting = rj.run_setting(runner.dtype, 1,
                                 realignment_flag=realignment_flag)
        loaded = rj.load_journal(resume_journal, intervals, model_path,
                                 inputs, setting)
        if loaded is not None:
            totals_j, recs = loaded
            skip = rj.completed_polish_intervals(totals_j, recs)
            replayed = [r for r in recs
                        if r[0] == "pseq" and r[1] in skip]
            # drop stale partial records before any new appends (same
            # double-count hazard as the variant journal)
            rj.compact_journal(resume_journal, intervals, model_path,
                               inputs, skip, replayed, setting)
            if skip:
                _log(f"RESUME: {len(skip)}/{len(intervals)} INTERVALS "
                     f"REPLAYED FROM JOURNAL")
        elif os.path.isfile(resume_journal):
            os.remove(resume_journal)   # stale/incompatible journal
        journal = rj.ResumeJournal(resume_journal, intervals, model_path,
                                   inputs, setting)

    stats = streamstats.reset()   # per-component accounting for this run
    n_threads = max(1, threads)
    # producers take GROUPS of contiguous same-contig intervals: one BAM
    # fetch + decode per group (polish_encode_multi) instead of one per
    # 1 kb interval — reads are ~8-10x longer than an interval, so the
    # per-interval fetch decoded every read ~9 times
    group_cap = int(os.environ.get("PEPPER_TPU_POLISH_GROUP", "48"))
    work: "queue.Queue" = queue.Queue()
    cur: list = []
    for idx, iv in enumerate(intervals):
        if idx in skip:
            continue
        if cur and (iv[0] != cur[-1][1][0] or len(cur) >= group_cap):
            work.put(cur)
            cur = []
        cur.append((idx, iv))
    if cur:
        work.put(cur)
    results: "queue.Queue" = queue.Queue(maxsize=2 * n_threads)
    errors: List[BaseException] = []
    stop = threading.Event()   # set when the consumer exits: unblocks puts

    def _put_result(item) -> None:
        # checked put: if the consumer loop died (device error, HDF5 write
        # failure), producers must not block forever against the bounded
        # queue — they give up once `stop` is set (mirrors
        # runtime/streaming.py's variant-side stream)
        while not stop.is_set():
            try:
                results.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def producer():
        # share-nothing per thread: own BAM/FASTA handles; the fused
        # native encoder releases the GIL for fetch+realign+pileup
        try:
            with BamReader(bam_file) as bam, \
                    FastaReader(draft_file) as fasta:
                while not stop.is_set():
                    try:
                        group = work.get_nowait()
                    except queue.Empty:
                        return
                    chr_name = group[0][1][0]
                    ivs = [(s, e) for _i, (_c, s, e) in group]
                    with stats.span("encode", cpu=True):
                        res_list = create_polish_summaries_multi(
                            bam, fasta, chr_name, ivs,
                            realignment_flag=realignment_flag)
                    # empty intervals are reported too: the streamed
                    # stitcher's contig watermark accounts every interval
                    for (idx, iv), res in zip(group, res_list):
                        images, labels, positions, chunk_ids = res
                        _put_result((idx, iv, images, labels, positions,
                                     chunk_ids))
        except BaseException as exc:  # fail loudly, never silently drop
            errors.append(exc)
            raise
        finally:
            _put_result(None)  # one sentinel per producer

    producers = [threading.Thread(target=producer, daemon=True)
                 for _ in range(n_threads)]
    t0 = time.time()
    for t in producers:
        t.start()

    image_store = PolishImageStore(image_store_path, "w") \
        if image_store_path else None
    store = None
    if h5py_available():
        store = PolishPredictionStore(prediction_path, "w")
    else:
        _log("WARNING: h5py IS NOT INSTALLED — THE STREAMED POLISH SKIPS THE "
             f"PREDICTION ARTIFACT {prediction_path} (THE POLISHED FASTA "
             "DOES NOT DEPEND ON IT)")
    metas: list = []
    images_buf: list = []
    pending: list = []   # (metas, device_labels) in flight
    done_sentinels = 0
    total = 0

    def submit(batch_metas, batch_images):
        with stats.span("batch_submit", cpu=True):
            labels = runner.submit(pad_consensus_batch(batch_images,
                                                       batch_size))
        return batch_metas, labels

    crash_after = int(os.environ.get(
        "PEPPER_TPU_TEST_CRASH_AFTER_POLISH_FLUSH", "0"))
    flushed_seqs = [0]

    def flush(batch_metas, labels, journal_recs: bool = True):
        with stats.span("d2h_wait"):
            labels = np.asarray(labels)[:len(batch_metas)]
        for meta, base_labels in zip(batch_metas, labels):
            contig, start, end, chunk_id, position, index, idx = meta
            if store is not None:
                with stats.span("store_write", cpu=True):
                    store.write_prediction(contig, start, end, chunk_id,
                                           position, index, base_labels)
            if stitcher is not None:
                with stats.span("stitch_feed", cpu=True):
                    stitcher.add(contig, start, end, chunk_id, position,
                                 index, base_labels)
            if journal is not None and journal_recs:
                with stats.span("journal", cpu=True):
                    journal.append(("pseq", idx, start, end, chunk_id,
                                    position, index, base_labels))
                flushed_seqs[0] += 1
                if crash_after and flushed_seqs[0] >= crash_after:
                    os._exit(9)   # test hook: kill -9 mid-stream

    # a dedicated flusher owns the device sync + per-sequence HDF5 group
    # writes + stitcher feed (~600 h5py group creations per 300 kb were
    # serializing the consumer loop); mirrors the variant-side flusher
    flush_q: "queue.Queue" = queue.Queue(maxsize=6)

    def flusher():
        try:
            while True:
                item = flush_q.get()
                if item is None:
                    return
                flush(*item)
        except BaseException as exc:
            errors.append(exc)
            raise

    flush_thread = threading.Thread(target=flusher, daemon=True)

    # Replay completed intervals BEFORE the flusher starts (store +
    # stitcher single-threaded until then): their sequences feed the
    # fresh prediction store and the contig-watermark stitcher without
    # touching the encoder or the device.
    if skip:
        by_idx: dict = {}
        for rec in replayed:
            by_idx.setdefault(rec[1], []).append(rec)
        for idx in skip:
            contig = intervals[idx][0]
            if stitcher is not None:
                stitcher.note_interval(contig, skip[idx])
            for (_tag, _i, start, end, chunk_id, position, index,
                 bases) in by_idx.get(idx, []):
                meta = (contig, start, end, chunk_id, position, index, idx)
                flush([meta], np.asarray(bases)[None, :],
                      journal_recs=False)
                total += 1

    flush_thread.start()

    def _put_flush(item) -> None:
        # never block forever on a dead flusher: surface its error instead
        while True:
            if errors:
                raise RuntimeError(
                    f"polish streaming shard failed: {errors[0]}") \
                    from errors[0]
            try:
                flush_q.put(item, timeout=1.0)
                return
            except queue.Full:
                continue

    try:
        while done_sentinels < n_threads:
            item = results.get()
            if item is None:
                done_sentinels += 1
                continue
            (interval_idx, region_tuple, imgs, labels_unused, positions,
             chunk_ids) = item
            if stitcher is not None:
                stitcher.note_interval(region_tuple[0], len(imgs))
            if journal is not None:
                journal.append(("total", interval_idx, len(imgs)))
            if not imgs:
                continue
            for i, image in enumerate(imgs):
                meta = _chunk_meta(region_tuple, positions[i],
                                   chunk_ids[i]) + (interval_idx,)
                if image_store is not None:
                    contig, start, end = region_tuple
                    name = f"{contig}_{start}_{end}_{chunk_ids[i]}"
                    image_store.write_summary(region_tuple, image,
                                              labels_unused[i], meta[4],
                                              meta[5], chunk_ids[i], name)
                metas.append(meta)
                images_buf.append(np.asarray(image, np.uint8))
                total += 1
                if len(metas) == batch_size:
                    pending.append(submit(metas, images_buf))
                    metas, images_buf = [], []
                    while len(pending) > 2:
                        _put_flush(pending.pop(0))
        if metas and not errors:
            pending.append(submit(metas, images_buf))
        for batch in pending:
            _put_flush(batch)
    finally:
        stop.set()   # consumer exiting (normally or not): unblock producers
    for t in producers:
        t.join()
    # checked sentinel delivery (a dead flusher may leave flush_q full)
    while flush_thread.is_alive():
        try:
            flush_q.put(None, timeout=0.2)
            break
        except queue.Full:
            continue
    flush_thread.join()
    if journal is not None:
        journal.close()   # caller deletes the file after the FASTA closes
    if errors:
        raise RuntimeError(f"polish streaming shard failed: {errors[0]}") \
            from errors[0]
    if store is not None:
        store.close()
    if image_store is not None:
        image_store.close()
    _log(f"STREAMED PILEUP+CONSENSUS: {total} SEQUENCES "
         f"[{time.time() - t0:.1f}s]")
    _log("POLISH STREAM BREAKDOWN (core-seconds): " + stats.summary())
    return total
