"""Stage tracing (SURVEY.md §5.1 aux parity).

The reference's observability is timestamped stderr logging with elapsed
times per stage; this module keeps that contract and adds an opt-in trace,
as the JAX package's does (pepper_tpu/utils/profiling.py): set
PEPPER_TPU_PROFILE=/path/dir to capture a torch.profiler trace of each
stage into /path/dir/<stage name>/ (a Chrome trace, `*.pt.trace.json`, that
TensorBoard's profiler plugin and chrome://tracing read). The trace holds
the host's operators and, when a CUDA device is there, the card's kernels
and copies.
"""
import contextlib
import os
import sys
import time
from datetime import datetime


def _trace(path: str):
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(path))


@contextlib.contextmanager
def stage(name: str):
    """Log a stage's wall time; capture a torch.profiler trace when
    PEPPER_TPU_PROFILE names a directory."""
    profile_dir = os.environ.get("PEPPER_TPU_PROFILE")
    t0 = time.time()
    if profile_dir:
        with _trace(os.path.join(profile_dir, name)):
            yield
    else:
        yield
    sys.stderr.write(
        "[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
        + f"] INFO: STAGE {name} TOOK {time.time() - t0:.2f}s\n")
    sys.stderr.flush()
