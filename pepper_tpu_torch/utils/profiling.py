"""Stage timing (SURVEY.md §5.1 aux parity).

The reference's observability is timestamped stderr logging with elapsed
times per stage; this module keeps that contract. Device trace capture
(torch.profiler) is not ported yet (ROADMAP M9).
"""
import contextlib
import sys
import time
from datetime import datetime


@contextlib.contextmanager
def stage(name: str):
    """Log a stage's wall time."""
    t0 = time.time()
    yield
    sys.stderr.write(
        "[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
        + f"] INFO: STAGE {name} TOOK {time.time() - t0:.2f}s\n")
    sys.stderr.flush()
