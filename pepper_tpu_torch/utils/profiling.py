"""Stage tracing (SURVEY.md §5.1 aux parity).

The reference's observability is timestamped stderr logging with elapsed
times per stage; this module keeps that contract and adds an opt-in trace,
as the JAX package's does (pepper_tpu/utils/profiling.py): set
PEPPER_TPU_PROFILE=/path/dir to capture a torch.profiler trace of each
stage into /path/dir/<stage name>/ (a Chrome trace, `*.pt.trace.json`, that
TensorBoard's profiler plugin and chrome://tracing read), one trace per
stage. The trace holds the host's operators and, when a CUDA device is
there, the card's kernels and copies, on one clock with the streamed
pipelines' spans (utils/streamstats.py): `pepper.encode` on each encode
thread, `pepper.d2h_wait`, `pepper.store_write`, `pepper.collector_put` and
`pepper.journal` on the flusher, `pepper.gates` and `pepper.vcf_emit` on
the gate thread, and the dispatching thread's states `pepper.main.*`.

It records every thread of the process (`profile_all_threads`). A torch
without that option records only the thread that entered the stage, which
then shows the dispatching thread's states and no worker's spans. The
dispatching thread's state is split where a stage's trace starts and ends,
so each trace holds the states that cover it.
"""
import contextlib
import os
import sys
import time
from datetime import datetime


def _all_threads():
    """The profiler's option to record every thread, where torch has it."""
    from torch.profiler import _ExperimentalConfig
    try:
        return {"experimental_config":
                _ExperimentalConfig(profile_all_threads=True)}
    except TypeError:   # a torch older than the option
        return {}


def _split_state():
    """Split the dispatching thread's open state here (a no-op where no
    job runs): a profiler that has just started records the state from
    here on, and one about to stop sees it end inside its trace."""
    from pepper_tpu_torch.utils import streamstats
    stats = streamstats.CURRENT
    if stats.state_key is not None:
        stats.state(stats.state_key)


def _trace(path: str):
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(path),
                   **_all_threads())


@contextlib.contextmanager
def stage(name: str):
    """Log a stage's wall time; capture a torch.profiler trace of every
    thread when PEPPER_TPU_PROFILE names a directory."""
    profile_dir = os.environ.get("PEPPER_TPU_PROFILE")
    t0 = time.time()
    if profile_dir:
        with _trace(os.path.join(profile_dir, name)):
            _split_state()
            yield
            _split_state()
    else:
        yield
    sys.stderr.write(
        "[" + datetime.now().strftime("%m-%d-%Y %H:%M:%S")
        + f"] INFO: STAGE {name} TOOK {time.time() - t0:.2f}s\n")
    sys.stderr.flush()
