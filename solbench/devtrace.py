"""Device activity from a ``torch.profiler`` session: the kernels and
copies of the profiled frames or steps, their busy time as the union of
their intervals (overlapping kernels count once), and the breakdown of
the traced line: the device operations that took the most time and the
longest idle gaps, each named by the innermost host operation that was
running in the middle of it."""

from __future__ import annotations

import dataclasses

import numpy as np

_COPIES = ("Memcpy", "Memset")
_GAPS_NAMED = 256  # the longest idle gaps that are attributed
_TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    kernels: list  # [(name, start_us, end_us)], kernels only
    activity: list  # [(name, start_us, end_us)], kernels and copies
    host: list  # [(name, start_us, end_us)], host-side events
    window_s: float  # the profiled span on the host clock

    @property
    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.activity])


def from_profiler(prof, window_s: float) -> DeviceTrace:
    """The session's raw events (kineto's, without building PyTorch's
    event tree, which takes minutes for a few hundred thousand ops)."""
    from torch.autograd import DeviceType

    activity, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-3
        item = (ev.name(), start, start + ev.duration_ns() * 1e-3)
        if ev.device_type() == DeviceType.CUDA:
            activity.append(item)
        else:
            host.append(item)
    activity.sort(key=lambda x: x[1])
    kernels = [a for a in activity if not a[0].startswith(_COPIES)]
    return DeviceTrace(kernels, activity, host, window_s)


def union_s(intervals) -> float:
    """Length in seconds of the union of (start_us, end_us) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total * 1e-6


def _gaps(intervals):
    """Idle gaps (start_us, end_us) between the merged intervals."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def breakdown(trace: DeviceTrace) -> dict:
    by_op = {}
    for name, s, e in trace.activity:
        by_op[name] = by_op.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:_TOP]
    gaps = sorted(_gaps([(s, e) for _, s, e in trace.activity]),
                  key=lambda g: g[0] - g[1])[:_GAPS_NAMED]
    named = {}
    if gaps and trace.host:
        names = [h[0] for h in trace.host]
        hs = np.asarray([h[1] for h in trace.host])
        he = np.asarray([h[2] for h in trace.host])
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = ("(no host op)" if inside.size == 0 else
                    names[inside[np.argmin(he[inside] - hs[inside])]])
            named[name] = named.get(name, 0.0) + (e - s) * 1e-6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:_TOP]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n[:160], v] for n, v in idle]}
