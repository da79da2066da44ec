"""One run of one cell: set-up, the timed window, the traced frames or
steps (``--trace 1``), the check against the plain reference, and the
result line.

Set-up (``setup_s``, from the process's start): imports, CUDA, the
inputs made from the seed, the scene built, one warm-up frame (frame
cells) or the first ``followed_steps`` steps (gradient cells), which
build every kernel of the cell.  The window is a closed loop: each frame
or step starts when the one before it has synced, until ``--seconds``
have passed; the last one finishes after that, and the rates are taken
over every frame or step and up to its sync.  With ``--trace 1`` the
first ``trace_units`` frames or steps of the window run under
``torch.profiler`` and the line carries the per-layer metrics instead of
the end-to-end ones.  A gradient cell's notes also give each step of the
window on the host's clock (``step_note``); the line does not.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from solbench import check, devtrace, manifest, systems

FORBIDDEN = ("jax", "jaxlib", "flax", "solr_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class LayerInputs:
    """What a per-layer reader reads."""

    mode: str  # "frames" or "grad"
    units: int  # frames or steps profiled
    window_units: int  # frames or steps of the whole window
    trace: devtrace.DeviceTrace | None
    counters: dict  # the program's counters over the window
    scene_build_s: float


class _Clock:
    """Per-frame times on the device's clock (CUDA events), or on the
    host's off the card."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span(self, start):
        self.marks.append((start, self.mark()))

    def ms(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


def frame_rays(cell) -> int:
    """The rays of one frame: per pixel, sample, eye and bounce, one
    closest-hit ray and, per light, one shadow ray per shadow sample (the
    transmittance queries the shading traces).  Samples and soft shadows
    need a key (a keyed cell), else the program takes one sample and
    hard shadows; an anaglyph traces two eyes; post-processing is
    screen-space and traces none."""
    w, s = cell.workload, cell.settings
    spp = cell.spp if cell.keyed else 1
    soft = s.get("shadow_samples", 1) if cell.keyed else 1
    shadow_rays = cell.lights * max(soft, 1) if s.get("shadows", True) else 0
    eyes = 2 if s.get("camera_mode") == "ANAGLYPH" else 1
    return (w["width"] * w["height"] * spp * eyes * w["bounces"]
            * (1 + shadow_rays))


def _digest(img) -> float:
    """The frame's digest; reading it on the host syncs the device."""
    return float(img[..., :3].double().sum())


def _percentile(values, q: int) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class _Window:
    """The closed loop of one run and its optional profiler."""

    def __init__(self, device, seconds: float, trace_units: int):
        self.device, self.seconds = device, seconds
        self.trace_units = trace_units
        self.prof = self.trace = None
        self.units = 0

    def run(self, one):
        """Call ``one()`` (which ends in a sync) until the window has
        passed and the profiled units are done: (results, seconds)."""
        out = []
        t0 = time.perf_counter()
        while True:
            if self.trace_units and self.units == 0:
                self._start()
            out.append(one())
            self.units += 1
            now = time.perf_counter()
            if self.prof is not None and self.units == self.trace_units:
                self._stop(now)
            if now - t0 >= self.seconds and self.prof is None:
                return out, now - t0

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._tp0 = time.perf_counter()

    def _stop(self, now):
        self.prof.__exit__(None, None, None)
        self.trace = devtrace.from_profiler(self.prof, now - self._tp0)
        self.prof = None


def _note(text: str, notes=None):
    print(text, file=sys.stderr, flush=True)
    if notes is not None:
        notes.append(text)


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if \
        device.type == "cuda" else 0


def _run_frames(cell, raw, seed, device, seconds, trace, t_start,
                make_system, notes):
    w = cell.workload
    system = make_system(cell, raw, device, seed)
    _digest(system.frame())  # warm-up: every kernel of the frame is built
    system.reset_counters()
    setup_s = time.perf_counter() - t_start
    clock = _Clock(device)
    window = _Window(device, seconds, w["trace_units"] if trace else 0)
    last = {}

    def one():
        start = clock.mark()
        img = system.frame()
        clock.span(start)
        last["img"] = img
        return _digest(img)

    digests, elapsed = window.run(one)
    peak = _peak(device)
    frame_ms = clock.ms()
    checked = last.pop("img")[..., :3].reshape(-1, 3).detach().clone()
    counters, build_s = system.counters(), system.build_s
    system.close()
    del system
    _free(device)
    t_ref = time.perf_counter()
    scene = cell.reference_kind.reference_scene(raw, cell.config, device,
                                                torch.float64)
    ref_rgb = systems.reference_frame(cell, scene, seed).reshape(-1, 3)
    _note(f"setup {setup_s:.3f} s, {len(digests)} frames in {elapsed:.3f} s, "
          f"reference {time.perf_counter() - t_ref:.3f} s", notes)
    numbers = check.frame_numbers(checked, ref_rgb, digests,
                                  w["check"]["pixel_tolerance"])
    limit = w["check"]["limits"]["digest_gap"]
    failed = sum(1 for g in digests if not abs(g - digests[-1])
                 <= limit * max(abs(digests[-1]), 1e-30))
    e2e = {"setup_s": setup_s,
           "rays_per_s": frame_rays(cell) * len(digests) / elapsed,
           "frame_ms_p95": _percentile(frame_ms, 95)}
    samples = {"rays_per_s": len(digests), "frame_ms_p95": len(frame_ms)}
    layer = LayerInputs("frames", w["trace_units"], len(digests),
                        window.trace, counters, build_s)
    return dict(attempted=len(digests), failed=failed, e2e=e2e,
                samples=samples, layer=layer, numbers=numbers, peak=peak)


HEAD_STEPS = 5  # the window's first steps, summed apart from the rest
STEPS = "window steps "  # the note's prefix; JSON follows


def step_note(step_ms: list, cpu_s: float) -> str:
    """The window's step times (host clock, ms) and the process's CPU
    seconds over it, as one line of JSON for the run's notes."""
    head, rest = step_ms[:HEAD_STEPS], step_ms[HEAD_STEPS:]
    summary = {"count": len(step_ms),
               "median_ms": statistics.median(step_ms),
               "p10_ms": _percentile(step_ms, 10),
               "p90_ms": _percentile(step_ms, 90), "max_ms": max(step_ms),
               "head_mean_ms": statistics.fmean(head),
               "rest_mean_ms": statistics.fmean(rest) if rest else None,
               "cpu_s": cpu_s, "step_ms": [round(x, 3) for x in step_ms]}
    return STEPS + json.dumps(summary)


def _run_grad(cell, raw, seed, device, seconds, trace, t_start, make_system,
              notes):
    w = cell.workload
    target = systems.make_target(w, seed, device)
    system = make_system(cell, raw, device, target)
    record = check.StepRecord(system)
    for _ in range(w["followed_steps"]):
        record.step(system)
    record.release()
    system.reset_counters()
    setup_s = time.perf_counter() - t_start
    window = _Window(device, seconds, w["trace_units"] if trace else 0)
    step_ms = []

    def one():
        start = time.perf_counter()  # each step ends in a sync: its loss
        loss = system.step()
        step_ms.append((time.perf_counter() - start) * 1e3)
        return loss

    cpu0 = time.process_time()
    losses, elapsed = window.run(one)
    cpu_s = time.process_time() - cpu0
    peak = _peak(device)
    counters, build_s = system.counters(), system.build_s
    system.close()
    del system
    _free(device)
    t_ref = time.perf_counter()
    reference = systems.RefGrad(cell, raw, device, torch.float64,
                                target.double())
    ref_record = check.StepRecord(reference)
    for _ in range(w["followed_steps"]):
        ref_record.step(reference)
    counted, moved = check.counted_leaves(ref_record,
                                          w["check"]["leaf_floor"],
                                          w["check"]["change_floor"])
    _note(step_note(step_ms, cpu_s), notes)
    _note(f"setup {setup_s:.3f} s, {len(losses)} steps in {elapsed:.3f} s, "
          f"reference {time.perf_counter() - t_ref:.3f} s; losses "
          f"{record.losses} / {ref_record.losses}; gradient gaps by leaf "
          f"{check.leaf_gaps(record.grad, ref_record.grad, counted)}; "
          f"change gaps by leaf "
          f"{check.leaf_gaps(record.change, ref_record.change, moved)}",
          notes)
    numbers = check.grad_numbers(record, ref_record,
                                 w["check"]["leaf_floor"],
                                 w["check"]["change_floor"])
    failed = sum(1 for x in losses if not math.isfinite(x))
    e2e = {"setup_s": setup_s,
           "grad_step_ms": elapsed / len(losses) * 1e3}
    layer = LayerInputs("grad", w["trace_units"], len(losses), window.trace,
                        counters, build_s)
    return dict(attempted=len(losses), failed=failed, e2e=e2e,
                samples={"grad_step_ms": len(losses)}, layer=layer,
                numbers=numbers, peak=peak)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        make_system=None, notes=None) -> dict:
    """One run of ``cell`` (a :class:`manifest.Cell`): the result line as
    a dict.  ``make_system`` replaces the program (the control, the
    faults of the tests); ``notes``, a list, collects the run's notes."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    raw = cell.scene_kind.make_inputs(cell.config, seed)
    mode = cell.workload["mode"]
    if mode == "frames":
        out = _run_frames(cell, raw, seed, device, seconds, trace, t_start,
                          make_system or systems.PortFrames, notes)
    elif mode == "grad":
        out = _run_grad(cell, raw, seed, device, seconds, trace, t_start,
                        make_system or systems.PortGrad, notes)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    correct, rows = check.verdict(out["numbers"], cell.workload["check"]["limits"])
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": out["peak"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        layer = out["layer"]
        metrics = {}
        for m in cell.per_layer:
            value = manifest.reader(m["name"]).read(layer)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        if layer.trace is not None:
            dev["busy_s"] = layer.trace.busy_s
            dev["window_s"] = layer.trace.window_s
            result["breakdown"] = devtrace.breakdown(layer.trace)
    else:
        # A metric's name up to its first dot names the quantity; what
        # follows names a group of cells with a bound of its own.
        result["metrics"] = {}
        for m in cell.end_to_end:
            base = m["name"].split(".")[0]
            result["metrics"][m["name"]] = {
                "value": out["e2e"][base], "unit": m["unit"],
                **({"samples": out["samples"][base]}
                   if base in out["samples"] else {})}
    result["device"] = dev
    result["check"] = rows
    return result


def _card() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m solbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True,
                    help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the timed window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    if args.seed < 0:
        print("--seed must be a whole number >= 0", file=sys.stderr)
        return 2
    try:
        cell = manifest.Cell(args.workload)
    except (OSError, KeyError, ValueError) as err:
        print(f"cannot load workload {args.workload!r}: {err!r}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{args.workload} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 t_start)
    found = loaded_forbidden()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(f"card: {_card()}", file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
