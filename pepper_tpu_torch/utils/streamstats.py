"""Per-component time accounting inside the streamed pipelines.

VERDICT r4: ~2.9 s of streamed e2e wall sat above the encode bound with
no committed measurement saying where. Every stage of the stream now
accumulates its busy time here (thread-safe, one add per region/flush —
negligible overhead), and the drivers log one breakdown line at the end
of the run. On an N-core host the streamed wall clock is roughly
(sum of component core-seconds) / N once the device is hidden, so these
numbers attribute the gap directly.
"""
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class StreamStats:
    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def add(self, key: str, dt: float, n: int = 1) -> None:
        with self._lock:
            self.seconds[key] += dt
            self.counts[key] += n

    @contextmanager
    def timed(self, key: str):
        """Wall-clock section — use for WAIT states (device sync, queue
        backpressure), where elapsed time is the meaningful number."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(key, time.perf_counter() - t0)

    @contextmanager
    def timed_cpu(self, key: str):
        """Thread-CPU section — use for BUSY work. On a saturated host,
        wall time inflates with scheduling pressure from the other
        threads; thread CPU time is the component's true core-seconds
        (it also counts time spent inside GIL-released native calls)."""
        t0 = time.thread_time()
        try:
            yield
        finally:
            self.add(key, time.thread_time() - t0)

    def summary(self) -> str:
        with self._lock:
            items = sorted(self.seconds.items(), key=lambda kv: -kv[1])
        return " | ".join(f"{k} {v:.2f}s" for k, v in items)

    def total(self) -> float:
        # keys in parentheses are nested inside another timed section
        # (e.g. "(native_batch)" inside "vcf_emit") — skip them so the
        # total is not double-counted
        with self._lock:
            return sum(v for k, v in self.seconds.items()
                       if not k.startswith("("))


CURRENT = StreamStats()


def reset() -> StreamStats:
    """Start a fresh accounting epoch (one per streamed run)."""
    global CURRENT
    CURRENT = StreamStats()
    return CURRENT
