"""The program's spans, and its net counters split by query, as the
per-layer readers use them.

The program names its layers with spans ``solr/<name>``
(``solr_tpu_torch.utils.profiling.render_phase``): host events of the
traced run's profiler, on the clock of its kernels and copies, nested on
the host thread.  Each function returns nothing where the run has
nothing to read: another mode, no trace, or a program without spans or
split counters."""

from __future__ import annotations

import bisect

from solbench.devtrace import union_s

PREFIX = "solr/"
# The CUDA runtime calls that wait on the device.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def traced(inputs, mode: str):
    """The trace of a run of ``mode`` whose program records spans."""
    if inputs.mode != mode or inputs.trace is None or not inputs.units:
        return None
    if not any(n.startswith(PREFIX) for n, _, _ in inputs.trace.host):
        return None
    return inputs.trace


def intervals(trace, name: str) -> list:
    """(start_us, end_us) of the spans ``solr/<name>``."""
    return [(s, e) for n, s, e in trace.host if n == PREFIX + name]


def merged(spans) -> list:
    """The union of (start_us, end_us) intervals as disjoint sorted
    intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def within(spans, outer) -> list:
    """The intervals of ``spans`` that start inside the union of
    ``outer``."""
    runs = merged(outer)
    starts = [r[0] for r in runs]
    out = []
    for s, e in spans:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < runs[i][1]:
            out.append((s, e))
    return out


def span_ms(inputs, mode: str, name: str):
    """ms per profiled unit of the union of the spans ``solr/<name>``;
    spans of one name nested in each other count once."""
    trace = traced(inputs, mode)
    if trace is None:
        return None
    return union_s(intervals(trace, name)) * 1e3 / inputs.units


def idle_ms(inputs, mode: str, name: str):
    """ms per profiled unit under ``solr/<name>`` spans in which no
    kernel or copy ran on the device: the union of the spans and the
    device's activity, less the activity."""
    trace = traced(inputs, mode)
    if trace is None:
        return None
    busy = [(s, e) for _, s, e in trace.activity]
    both = union_s(intervals(trace, name) + busy)
    return (both - union_s(busy)) * 1e3 / inputs.units


def syncs_per_unit(inputs, mode: str):
    """Host syncs (:data:`SYNCS` runtime calls) per profiled unit that
    start inside a span of the program."""
    trace = traced(inputs, mode)
    if trace is None:
        return None
    spans = [(s, e) for n, s, e in trace.host if n.startswith(PREFIX)]
    calls = [(s, e) for n, s, e in trace.host if n in SYNCS]
    return len(within(calls, spans)) / inputs.units


def needy_shadow_per_frame(inputs):
    """The net's needy shadow rays per frame of the window, primary and
    later bounces (``traverse.NET_STATS``); nothing where the program
    does not split them or the net never ran."""
    net = inputs.counters.get("net", {})
    keys = ("needy_primary_shadow", "needy_later_shadow")
    if inputs.mode != "frames" or not net.get("calls") or \
            not all(k in net for k in keys):
        return None
    return sum(net[k] for k in keys) / inputs.window_units
