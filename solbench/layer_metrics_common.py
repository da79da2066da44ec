"""What several per-layer readers share: kernel time and count per
profiled frame or step, and the device's idle share.  Each returns
nothing where the run has nothing to read (another mode, no trace, no
matching kernel)."""

from __future__ import annotations


def net_per_frame(inputs, key: str) -> float | None:
    """``traverse.NET_STATS[key]`` per frame of the window; nothing
    where the net never ran."""
    net = inputs.counters.get("net", {})
    if inputs.mode != "frames" or not net.get("calls"):
        return None
    return net[key] / inputs.window_units


def _trace(inputs, mode):
    if inputs.mode != mode or inputs.trace is None or not inputs.units:
        return None
    return inputs.trace


def kernel_ms(inputs, mode: str, names) -> float | None:
    """Device ms per unit of the kernels whose names hold one of
    ``names``."""
    trace = _trace(inputs, mode)
    if trace is None:
        return None
    spans = [e - s for n, s, e in trace.kernels if any(k in n for k in names)]
    return sum(spans) * 1e-3 / inputs.units if spans else None


def kernels_per_unit(inputs, mode: str) -> float | None:
    trace = _trace(inputs, mode)
    if trace is None or not trace.kernels:
        return None
    return len(trace.kernels) / inputs.units


def idle_pct(inputs, mode: str) -> float | None:
    trace = _trace(inputs, mode)
    if trace is None or not trace.activity or trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
