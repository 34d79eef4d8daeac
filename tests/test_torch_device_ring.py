"""The device runner's pinned ring (runtime/streaming.py): its bookkeeping
with fake events, the one copy of a batch's image chunks into a slot, and
the CPU runner fed chunks. The card's side (the graphed forward against the
eager one) is in tests/test_torch_kernels_cuda.py.

A slot is never handed out while a batch that has not been read holds it,
nor before the events of its last batch have completed; a batch dropped
unread gives its slot back; a short batch's padded rows are zero whatever
the slot held before.
"""
import gc

import numpy as np
import pytest
import torch

from pepper_tpu_torch.runtime import streaming
from pepper_tpu_torch.runtime.streaming import (_MetaBuffer, _PendingBatch,
                                                _PinnedRing, _Slot, _stage)
from pepper_tpu_torch.utils import streamstats

ROWS, WINDOW = 6, (3, 2)


class FakeEvent:
    """A CUDA event that completes when the test says so, or when waited
    on; `log` records the order of waits and hand-outs."""

    def __init__(self, log, name):
        self.log, self.name, self.complete = log, name, False

    def synchronize(self):
        self.log.append(("sync", self.name))
        self.complete = True

    def elapsed_time(self, end):
        return 2.0   # ms


def _ring(slots=2):
    made = []

    def make_slot():
        slot = _Slot(torch.full((ROWS,) + WINDOW, 7, dtype=torch.int8),
                     torch.full((ROWS, 3), len(made), dtype=torch.float32))
        made.append(slot)
        return slot
    return _PinnedRing(make_slot, slots), made


def test_ring_hands_out_a_slot_only_after_its_events_complete():
    log = []
    ring, made = _ring(2)
    a, b = ring.acquire(), ring.acquire()
    assert {id(a), id(b)} == {id(s) for s in made}
    ea = FakeEvent(log, "a")
    ring.release(a, [ea])
    got = ring.acquire()
    assert got is a and ea.complete and log == [("sync", "a")]
    assert got.events == ()
    # a slot whose events already completed is not waited on again
    ring.release(b, ())
    assert ring.acquire() is b and log == [("sync", "a")]


def test_ring_never_hands_out_a_held_slot_and_grows_instead():
    ring, made = _ring(2)
    held = [ring.acquire() for _ in range(5)]
    assert len({id(s) for s in held}) == 5 and len(made) == 5
    for slot in held[::-1]:
        ring.release(slot, ())
    # oldest release first
    assert [ring.acquire() for _ in range(5)] == held[::-1]


def test_pending_batch_releases_its_slot_once_read():
    log = []
    ring, made = _ring(1)
    streamstats.reset()
    slot = ring.acquire()
    slot.probs[:] = np.arange(ROWS * 3, dtype=np.float32).reshape(ROWS, 3)
    done, started = [FakeEvent(log, "done")], [FakeEvent(log, "start")]
    batch = _PendingBatch(slot, done, started, ring)
    # unread: the next batch gets a new slot, never this one
    other = ring.acquire()
    assert other is not slot and len(made) == 2
    probs = np.asarray(batch)[:4].astype(np.float64)
    assert log == [("sync", "done")] and done[0].complete
    assert streamstats.CURRENT.seconds["(device)"] == pytest.approx(0.002)
    assert (probs == np.arange(12).reshape(4, 3)).all()
    # read: the probabilities were copied out and the slot went back
    assert ring.acquire() is slot
    slot.probs[:] = -1
    assert (np.asarray(batch)[:4] == np.arange(12).reshape(4, 3)).all()
    assert np.asarray(batch, np.float64).dtype == np.float64
    assert streamstats.CURRENT.seconds["(device)"] == pytest.approx(0.002)
    ring.release(other, ())


def test_a_batch_dropped_unread_gives_its_slot_back_after_its_events():
    log = []
    ring, made = _ring(1)
    slot = ring.acquire()
    done = [FakeEvent(log, "done")]
    batch = _PendingBatch(slot, done, ring=ring)
    del batch
    gc.collect()
    got = ring.acquire()
    assert got is slot and log == [("sync", "done")] and len(made) == 1


def test_ring_under_threads_never_hands_out_a_held_slot():
    """More threads than cores take and give back slots with a switch
    interval of a microsecond: no slot is ever held by two at once."""
    import sys
    import threading

    ring, made = _ring(3)
    holders, lock, errors = {}, threading.Lock(), []

    def worker(k):
        for _ in range(300):
            slot = ring.acquire()
            with lock:
                if id(slot) in holders:
                    errors.append((k, holders[id(slot)]))
                holders[id(slot)] = k
            slot.images[0, 0, 0] = k
            with lock:
                del holders[id(slot)]
            ring.release(slot, ())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(made) <= 16


def test_a_batch_outside_any_ring_reads_its_own_slot():
    """The form the polish runner uses (polish/consensus.py): its own
    pinned input and output, no ring; reading waits on the event and
    copies the output out."""
    log = []
    slot = _Slot(torch.zeros((2, 4), dtype=torch.uint8),
                 torch.arange(8, dtype=torch.int32).reshape(2, 4))
    batch = _PendingBatch(slot, [FakeEvent(log, "done")])
    got = np.asarray(batch)
    assert log == [("sync", "done")]
    assert got.dtype == np.int32 and (got == np.arange(8).reshape(2, 4)).all()
    slot.probs[:] = 0
    assert (np.asarray(batch) == np.arange(8).reshape(2, 4)).all()


@pytest.mark.parametrize("sizes", [[6], [2, 3], [1, 1, 1], [4]])
def test_staging_copies_the_chunks_once_and_zeros_the_padding(sizes):
    rng = np.random.default_rng(len(sizes))
    blocks = [rng.integers(-9, 9, (k,) + WINDOW).astype(np.int8)
              for k in sizes]
    out = np.full((ROWS,) + WINDOW, 5, np.int8)   # the slot's last batch
    _stage(out, blocks)
    n = sum(sizes)
    assert (out[:n] == np.concatenate(blocks)).all()
    assert not out[n:].any()


def test_meta_buffer_takes_image_chunks_in_row_order():
    rng = np.random.default_rng(3)
    buf = _MetaBuffer()
    rows = []
    for k, n in enumerate((4, 7, 2, 5)):
        img = rng.integers(-9, 9, (n,) + WINDOW).astype(np.int8)
        rows.append(img)
        buf.add("chr1", np.arange(n) + 10 * k, np.full(n, k),
                [("1A",)] * n, np.full(n, k), img, interval_idx=k)
    want = np.concatenate(rows)
    got, taken = [], 0
    while buf.rows:
        meta, buf = buf.take(min(6, buf.rows))
        chunks = meta[5]
        assert isinstance(chunks, list)
        assert sum(len(c) for c in chunks) == len(meta[1])
        got.append(np.concatenate(chunks))
        assert (meta[1] == np.concatenate(
            [np.arange(n) + 10 * k for k, n in enumerate((4, 7, 2, 5))])
            [taken:taken + len(meta[1])]).all()
        taken += len(meta[1])
    assert (np.concatenate(got) == want).all()


def test_cpu_runner_takes_chunks_as_it_takes_one_array(monkeypatch):
    from pepper_tpu_torch.models.variant_model import numpy_variant_params
    monkeypatch.setenv("PEPPER_TPU_MIN_DEVICE_BATCH", "8")
    tree = numpy_variant_params(5, window=5, hidden=8)
    runner = streaming.DeviceRunner(tree, 8, device="cpu")
    assert runner.batch == 8
    rng = np.random.default_rng(4)
    images = rng.integers(-50, 50, (7, 5, 26)).astype(np.int8)
    whole = np.asarray(runner.submit(images))
    chunks = np.asarray(runner.submit([images[:3], images[3:]]))
    assert whole.shape == (8, 3) and (whole == chunks).all()
    padded = np.zeros((8, 5, 26), np.int8)
    padded[:7] = images
    with torch.inference_mode():
        want = runner.forward(torch.from_numpy(padded)).numpy()
    assert (whole == want).all()
