"""Profiler spans and traces (counterpart of solr_tpu/utils/profiling.py).

* :func:`render_phase` is the port's one span: ``with
  render_phase("net"):`` records ``solr/net`` in an active
  ``torch.profiler`` session, as a host event on the clock of the
  session's kernels and copies.  The spans nest on the host thread, so a
  span's parent is the innermost span around it; ``solr/frame`` encloses
  one sample.  With no session active it does nothing.
* :func:`trace` profiles the CPU, and the card when there is one, for
  the duration of a ``with`` block and writes a Chrome trace (viewable
  in Perfetto or chrome://tracing) into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["render_phase", "trace"]

_OFF = contextlib.nullcontext()


def render_phase(name: str):
    """The span ``solr/<name>`` around a ``with`` block::

        with render_phase("closest"):
            hit = _scene_closest_hit_raw(...)

    A FUNCTION-scope record function (``_RecordFunctionFast``): unlike a
    ``record_function`` range (USER_SCOPE), kineto does not mirror it
    onto the card's stream as a ``gpu_user_annotation``, so the device
    side of a trace holds kernels and copies only.  Without an active
    profiler it returns a shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast("solr/" + name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write ``trace-<pid>-<ns>.json`` (a
    Chrome trace) into ``log_dir``.  Yields the profiler, whose
    ``key_averages()`` stays readable after the block."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
