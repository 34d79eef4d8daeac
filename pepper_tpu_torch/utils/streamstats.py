"""Per-component time accounting inside the streamed pipelines, on the
profiler's clock.

Every stage of the stream opens a span here (`StreamStats.span`, one add
per region/flush: negligible overhead) and the drivers log one breakdown
line at the end of the run. On an N-core host the streamed wall clock is
roughly (sum of component core-seconds) / N once the device is hidden, so
these numbers attribute the gap directly.

While a torch profiler runs, each span is also a profiler record (what
`torch.profiler.record_function` opens) named `pepper.<key>` over the same
interval, on whatever thread opened it, so it lies on the profiler's
timeline beside the card's kernels and copies. With no profiler running a
span reads one flag and opens no record.

The thread that runs a job (the dispatching thread) is always in exactly
one state, a key under `main.` (`state()`): states do not nest, and their
wall seconds tile the job from `call_variant`'s entry to its return. They
are wall seconds, not core-seconds, so `summary()` and `total()` leave them
out; `summary(states=True)` lists them alone.
"""
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _profiler

STATES = "main."   # key prefix of the dispatching thread's states


def _record(key: str):
    """A profiler record for `key`, not yet entered, while a torch profiler
    runs, else None. It is `record_function`'s C++ form: `record_function`
    enters and exits through the dispatcher, which releases the interpreter
    lock, so under contention one state's record would end milliseconds
    before the next one starts. This form keeps the lock."""
    if not _profiler._is_profiler_enabled:
        return None
    return torch._C._profiler._RecordFunctionFast("pepper." + key)


class StreamStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self._state = None   # (key, start, record) of the dispatching thread

    def add(self, key: str, dt: float) -> None:
        """Add seconds to `key`. Spans and states add here; so does the
        card's batch span ("(device)", CUDA events), which has no interval
        on the host's clock and so no profiler record."""
        with self._lock:
            self.seconds[key] += dt

    @contextmanager
    def span(self, key: str, cpu: bool = False):
        """A timed section. Wall clock (the default) for WAIT states
        (device sync, queue backpressure), where elapsed time is the
        meaningful number. `cpu=True` counts the thread's CPU time, for
        BUSY work: on a saturated host, wall time inflates with scheduling
        pressure from the other threads; thread CPU time is the
        component's true core-seconds (it also counts time spent inside
        GIL-released native calls)."""
        clock = time.thread_time if cpu else time.perf_counter
        record = _record(key)
        if record is not None:
            record.__enter__()
        t0 = clock()
        try:
            yield
        finally:
            self.add(key, clock() - t0)
            if record is not None:
                record.__exit__(None, None, None)

    @property
    def state_key(self) -> Optional[str]:
        return self._state[0] if self._state else None

    def state(self, key: Optional[str]) -> None:
        """The dispatching thread leaves its current state (adding its wall
        seconds) and enters `key` (None: enters none). Only that thread
        calls this."""
        now = time.perf_counter()
        old = self._state
        if old is not None:
            self.add(old[0], now - old[1])
        record = None if key is None else _record(key)
        if record is not None:
            # the next record opens before the last one closes: on the
            # profiler's clock two states share the hand-over's few
            # microseconds, and no moment of the job lies outside a state
            record.__enter__()
        if old is not None and old[2] is not None:
            old[2].__exit__(None, None, None)
        self._state = None if key is None else (key, now, record)

    def summary(self, states: bool = False) -> str:
        """The components' seconds, largest first; `states=True`: the
        dispatching thread's states instead."""
        with self._lock:
            items = sorted(((k, v) for k, v in self.seconds.items()
                            if k.startswith(STATES) == states),
                           key=lambda kv: -kv[1])
        return " | ".join(f"{k} {v:.2f}s" for k, v in items)

    def total(self) -> float:
        # keys in parentheses are nested inside another timed section
        # (e.g. "(native_batch)" inside "vcf_emit") — skip them so the
        # total is not double-counted; states are wall seconds
        with self._lock:
            return sum(v for k, v in self.seconds.items()
                       if not k.startswith(("(", STATES)))


CURRENT = StreamStats()


def reset() -> StreamStats:
    """Start a fresh accounting epoch (one per job or standalone stream)."""
    global CURRENT
    CURRENT = StreamStats()
    return CURRENT
