"""Device traces with ``torch.profiler``.

Counterpart of ``cv_diffusion_tpu/utils/profiling.py::trace``
(``jax.profiler``): ``with trace(logdir): f()`` records the host's calls
and, on a CUDA device, its kernels, and writes them as a Chrome trace
(``chrome://tracing``, Perfetto) into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Trace the block; yields the path of the Chrome trace written when it
    ends, ``<logdir>/trace_<pid>_<ms since the epoch>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
