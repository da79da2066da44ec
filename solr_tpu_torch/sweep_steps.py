"""Times the staged sweep kernels of ``csrc/sweep.cu`` step by step on
the card, at the shapes ``chip_smoke.py`` times them at.

    python -m solr_tpu_torch.sweep_steps [--parent DIR] [--out FILE]

Each step is the shipped source with some of its shape constants (each
staged kernel's warps per strip, occupancy hint and lanes per shared
load, and ``kLongestFirst``) set to other values; ``--parent DIR`` adds
the ``csrc/sweep.cu`` of another checkout of the repository (the parent
commit, whose entries take no launch order) as step 0.  Every variant
is compiled with the port's nvcc flags, all of them at once, and called
through ``sweep.launch_closest`` / ``launch_transmittance`` on the same
inputs: B1 and B2 on the bench frame's primary and shadow selections
(1M triangles, 512x512, BLOCK=512), B1 and B2 again on the molecule
frame's ground (BLOCK=256), B3 and B5 on the molecule frame's primary
selection and B4 and B6 on its shadow selection (100k atoms,
BLOCK=256); B2 and B6 with the scene's factors and with fractional
ones.  No step changes B3 and B4, the warp-per-strip kernels: their
times show the noise between variants.  Every
variant's outputs must be bit-equal to the plain versions'.  The
variants are timed in order and then in reverse order (CUDA events,
mean of 5 calls after a warm-up), on one card in one process, and both
passes are reported.  A variant with ``kLongestFirst`` false launches
no order kernel; for each call the launch order alone is timed too, as
the order kernel computes it and as ``torch.argsort`` would.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.kernel_shapes import (fractional, primary_tiles,
                                          shadow_rays, sweep_args, time_ms,
                                          triangle_hits)
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.traverse import scene_closest_hit

# The steps in the order the design was built: (name, constants that
# differ from the shipped source).  B1 and B6 keep their shapes in every
# step but the last.
_ID_ORDER = dict(kLongestFirst="false")
_B2_ENTRY = dict(kB2Warps=4, kB2MinCtas=4, kB2LaneVec=4)
STEPS = (
    ("1 B2, B5 staged on the entry's shape (closest 8 warps / 3 CTAs, "
     "shadow 4 / 4, 4 lanes per load), strips in id order",
     dict(_ID_ORDER, **_B2_ENTRY, kB5Warps=8, kB5MinCtas=3, kB5LaneVec=4)),
    ("2 B5 at 4 warps / 4 CTAs",
     dict(_ID_ORDER, **_B2_ENTRY, kB5LaneVec=4)),
    ("3 B5 at 8 warps / 2 CTAs",
     dict(_ID_ORDER, **_B2_ENTRY, kB5Warps=8, kB5MinCtas=2, kB5LaneVec=4)),
    ("4 B5 at 2 warps / 8 CTAs",
     dict(_ID_ORDER, **_B2_ENTRY, kB5Warps=2, kB5MinCtas=8, kB5LaneVec=4)),
    ("5 B5 at 4 warps / 5 CTAs",
     dict(_ID_ORDER, **_B2_ENTRY, kB5MinCtas=5, kB5LaneVec=4)),
    ("6 B5 at 4 warps / 4 CTAs, 2 lanes per load",
     dict(_ID_ORDER, **_B2_ENTRY)),
    ("7 B2 at 8 warps / 2 CTAs",
     dict(_ID_ORDER, kB2MinCtas=2, kB2LaneVec=4)),
    ("8 B2 at 4 warps / 3 CTAs", dict(_ID_ORDER, kB2Warps=4, kB2LaneVec=4)),
    ("9 B2 at 6 warps / 4 CTAs",
     dict(_ID_ORDER, kB2Warps=6, kB2MinCtas=4, kB2LaneVec=4)),
    ("10 B2 at 8 warps / 3 CTAs", dict(_ID_ORDER, kB2LaneVec=4)),
    ("11 B2 at 8 warps / 3 CTAs, 2 lanes per load", _ID_ORDER),
    ("12 + strips with the longest lists first (order kernel), all four "
     "staged kernels (shipped)", {}),
    ("alt: B2 at 4 lanes per load, longest first", dict(kB2LaneVec=4)),
    ("alt: B5 at 4 lanes per load, longest first", dict(kB5LaneVec=4)),
    ("alt: B5 at 8 warps / 2 CTAs, longest first",
     dict(kB5Warps=8, kB5MinCtas=2)),
    ("alt: B6 at 2 lanes per load, longest first", dict(kB6LaneVec=2)),
)
REPS = 5


def variant_source(src: str, consts: dict) -> str:
    """``src`` with each named constexpr constant set to its new value."""
    for name, value in consts.items():
        src, n = re.subn(rf"(constexpr (?:int|bool) {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"constant {name} not found once in the source")
    return src


def parent_library(path):
    """The library built from a parent checkout's ``sweep.cu``, whose
    entries take no launch order, behind the current entries, which
    drop it."""
    lib = ctypes.CDLL(str(path))
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    lib.solr_sweep_closest.argtypes = [
        i32, vp, i32, vp, vp, vp, vp, vp, vp, vp, i64, i32, f32, vp, vp, vp, vp]
    lib.solr_sweep_transmittance.argtypes = [
        i32, vp, i32, vp, vp, vp, vp, vp, vp, i64, i32, f32, vp, vp, vp]
    return types.SimpleNamespace(
        solr_sweep_closest=lambda *a: lib.solr_sweep_closest(*a[:10],
                                                             *a[11:]),
        solr_sweep_transmittance=lambda *a: lib.solr_sweep_transmittance(
            *a[:9], *a[10:]))


def _inputs(device):
    """The kernel calls of chip_smoke.py: [(label, entry, prim,
    args)]."""
    calls = []
    with torch.no_grad():
        scene, cam, cfg = bench_scene(1_000_000, block=512, width=512,
                                      height=512, bounces=2, device=device)
        accel = scene.tri_accel
        o_t, d_t, live = primary_tiles(cam, cfg)
        args = sweep_args(accel, o_t, d_t, live, cfg, True)
        calls.append(("B1 bench", "sweep_closest", "tri", args))
        t_t, i_t, _ = sweep.sweep_closest_plain(*args)
        so_t, sd_t, tm_t, slive = shadow_rays(scene, o_t, d_t,
                                              triangle_hits(t_t, i_t))
        args = sweep_args(accel, so_t, sd_t, slive, cfg, False, tm_t)
        calls.append(("B2 bench", "sweep_transmittance", "tri", args))
        calls.append(("B2 bench fractional", "sweep_transmittance", "tri",
                      (fractional(args[0]),) + args[1:]))
        del scene, accel, args
        scene, cam, cfg = molecule_scene(100_000, 128, width=512, height=512,
                                         bounces=2, block=256, device=device)
        o_t, d_t, live = primary_tiles(cam, cfg)
        calls.append(("B1 molecule ground", "sweep_closest", "tri",
                      sweep_args(scene.tri_accel, o_t, d_t, live, cfg, True)))
        calls.append(("B3 molecule", "sweep_closest", "sphere",
                      sweep_args(scene.sph_accel, o_t, d_t, live, cfg, True)))
        calls.append(("B5 molecule", "sweep_closest", "cyl",
                      sweep_args(scene.cyl_accel, o_t, d_t, live, cfg, True)))
        spec =(cfg.packet_rays, cfg.packet_max_blocks, cfg.packet_tile_cand,
                cfg.packet_exact)
        hit = scene_closest_hit(scene, o_t.reshape(-1, 3), d_t.reshape(-1, 3),
                                packet=spec)
        so_t, sd_t, tm_t, slive = shadow_rays(scene, o_t, d_t, hit)
        calls.append(("B2 molecule ground", "sweep_transmittance", "tri",
                      sweep_args(scene.tri_accel, so_t, sd_t, slive, cfg,
                                 False, tm_t)))
        calls.append(("B4 molecule", "sweep_transmittance", "sphere",
                      sweep_args(scene.sph_accel, so_t, sd_t, slive, cfg,
                                 False, tm_t)))
        args = sweep_args(scene.cyl_accel, so_t, sd_t, slive, cfg, False,
                          tm_t)
        calls.append(("B6 molecule", "sweep_transmittance", "cyl", args))
        calls.append(("B6 molecule fractional", "sweep_transmittance", "cyl",
                      (fractional(args[0]),) + args[1:]))
    return calls


def _launcher(entry):
    return sweep.launch_closest if entry == "sweep_closest" \
        else sweep.launch_transmittance


def _registers(log: str) -> dict:
    """Registers and spill bytes per staged kernel from ``-Xptxas -v``:
    {"closest_staged<WoopT>": "80 regs, 0 spill", ...}."""
    out, name, spill = {}, None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _demangle(m[1])
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m[1]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m[1]} regs, {spill} spill"
            name = None
    return out


def _demangle(mangled: str) -> str:
    """closest_staged<CylT> or order_kernel from its mangled name, else
    the name."""
    for kernel in ("closest_staged", "trans_staged", "closest_kernel",
                   "trans_kernel", "order_kernel"):
        if kernel in mangled:
            prim = next((p for p in ("WoopT", "SphereT", "CylT")
                         if p in mangled), None)
            return f"{kernel}<{prim}>" if prim else kernel
    return mangled


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of another checkout whose "
                    "solr_tpu_torch/csrc/sweep.cu is timed as the first step")
    ap.add_argument("--out", default="chiprun_out/sweep_steps.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_steps: no CUDA device visible", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()

    src = sweep._SRC.read_text()
    variants = [("0 parent", Path(a.parent) / "solr_tpu_torch" / "csrc"
                 / "sweep.cu")] if a.parent else []
    variants += [(name, variant_source(src, c)) for name, c in STEPS]
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(
            lambda v: sweep.compile_library(
                (v[1].read_text() if isinstance(v[1], Path) else v[1]).encode(),
                stem="libsolr_sweep_variant", verbose=True), variants))
    libs = [parent_library(p) if isinstance(v[1], Path)
            else sweep.load_library(p) for v, (p, _) in zip(variants, built)]
    build_s = time.time() - t0
    ptxas = {name: _registers(log) for (name, _), (_, log) in
             zip(variants, built)}

    device = torch.device("cuda:0")
    calls = _inputs(device)
    shipped = sweep._library()
    rec = {"nvidia_smi": smi, "torch": torch.__version__, "build_s": build_s,
           "ptxas": ptxas, "calls": {}, "steps": []}
    with torch.no_grad():
        for label, entry, prim, args in calls:
            plain = getattr(sweep, entry + "_plain")(*args, prim=prim)
            torch.cuda.synchronize()
            counts, k_max = args[6], int(args[5].shape[2])
            # The launch order alone: the order kernel that each staged
            # launch runs first, and torch.argsort, which it replaces.
            rec["calls"][label] = dict(
                strips=int(counts.numel()), block=int(args[0].shape[2]),
                mean_list=float(counts.float().mean()),
                max_list=int(counts.max()), visits=int(plain[-1].sum()),
                tests=int(plain[-1].sum()) * 32 * int(args[0].shape[2]),
                order_kernel_ms=time_ms(lambda: sweep.launch_order(
                    shipped, counts, k_max), REPS),
                argsort_ms=time_ms(lambda: sweep.longest_first(counts), REPS))
            for (name, _), lib in zip(variants, libs):
                got = _launcher(entry)(lib, *args, prim=prim)
                if not all(torch.equal(x, y) for x, y in zip(got, plain)):
                    raise AssertionError(f"{name} differs from the plain "
                                         f"version on {label}")
        times = {name: {label: [] for label, *_ in calls}
                 for name, _ in variants}
        order = list(zip(variants, libs))
        for sweep_order in (order, order[::-1]):
            for (name, _), lib in sweep_order:
                for label, entry, prim, args in calls:
                    launch = _launcher(entry)
                    times[name][label].append(time_ms(
                        lambda: launch(lib, *args, prim=prim), REPS))
    for name, _ in variants:
        rec["steps"].append({"step": name, "ms": times[name]})
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(f"card: {smi}; {len(variants)} variants built in {build_s:.1f} s")
    for label in rec["calls"]:
        print(f"{label}: {rec['calls'][label]}")
    for name, regs in ptxas.items():
        print(f"{name}: {regs}")
    for step in rec["steps"]:
        cells = "  ".join(f"{label} {ms[0]:.3f}/{ms[1]:.3f}"
                          for label, ms in step["ms"].items())
        print(f"{step['step']}: {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
