"""Profiler scopes and traces (counterpart of solr_tpu/utils/profiling.py).

* :func:`render_phase` names a render phase ("raygen", "traverse",
  "shade", ...) as a ``torch.profiler`` range, ``solr/<name>``, so it
  shows up in profiler tables and timelines.
* :func:`trace` profiles the CPU, and the card when there is one, for
  the duration of a ``with`` block and writes a Chrome trace (viewable
  in Perfetto or chrome://tracing) into a directory.
* :func:`cost_summary` is the reference's XLA cost analysis
  (``Compiled.cost_analysis()``); PyTorch has no compiled program to ask,
  so it raises.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["render_phase", "trace", "cost_summary"]


def render_phase(name: str):
    """Scope a render phase for the profiler::

        with render_phase("traverse"):
            hit = scene_closest_hit(...)
    """
    return torch.profiler.record_function(f"solr/{name}")


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


def cost_summary(fn, *args, **kwargs):
    """Not available: the reference reads FLOPs and bytes from XLA's
    ``Compiled.cost_analysis()``, and eager PyTorch compiles no program
    that could report them."""
    raise NotImplementedError(
        "cost_summary reads XLA's Compiled.cost_analysis(); PyTorch runs "
        "eagerly and has no compiled program to analyse")
