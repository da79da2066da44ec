"""Times the sweep kernels of ``csrc/sweep.cu`` step by step on the
card, at the shapes ``chip_smoke.py`` times them at.

    python -m solr_tpu_torch.sweep_steps [--parent DIR] [--out FILE]

Each step is the shipped source with some of its constants set to
other values (a kernel's warps per strip, occupancy hint and lanes per
shared load, ``kLongestFirst``), and some steps with a piece of it
replaced: ``SphereT::hit`` with every root computed, as before its root
skip.  ``--parent DIR`` adds the ``csrc/sweep.cu`` of another checkout
of the repository with the same C interface (the parent commit) as
step 0.  Every variant is compiled with the port's nvcc flags, all of
them at once, and called through ``sweep.launch_closest`` /
``launch_transmittance`` on the same inputs: B1 and B2 on the bench
frame's primary and shadow selections (1M triangles, 512x512,
BLOCK=512), B1 and B2 again on the molecule frame's ground (BLOCK=256),
B3 and B5 on the molecule frame's primary selection and B4 and B6 on
its shadow selection (100k atoms, BLOCK=256); B2 and B6 with the
scene's factors and with fractional ones.  The steps change B3 and B4,
the sphere kernels.  A step whose strips run in id order takes all six
kernels out of the launch order; apart from that B1, B2, B5 and B6 are
the same code in every step, and their times show the noise between
variants.  Every variant's outputs must be bit-equal to the plain
versions'.  The variants are timed in order and then in reverse order
(CUDA events, mean of 5 calls after a warm-up), on one card in one
process, and both passes are reported, with each kernel's registers
and spills from ``-Xptxas -v``.  A variant with ``kLongestFirst`` false
launches no order kernel; for each call the launch order alone is timed
too, as the order kernel computes it and as ``torch.argsort`` would.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import itertools
import json
import re
import sys
import time
from pathlib import Path

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.kernel_shapes import (fractional, primary_tiles,
                                          shadow_rays, sweep_args, time_ms,
                                          triangle_hits)
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import cudalib, sweep
from solr_tpu_torch.ops.traverse import scene_closest_hit
from solr_tpu_torch.utils.card import card_name

# The steps in the order the design was chosen: (name, constants that
# differ from the shipped source, (shipped text, its replacement) pairs).
# B1, B2, B5 and B6 keep their shapes in every step.  The shapes are
# compared with the root skip and the launch order on, as they ship.
_ID_ORDER = dict(kLongestFirst="false")
# SphereT::hit's roots with and without the root skip: the second is
# the body before it, which computes the square root on every test.
_ALL_ROOTS = ((
    """    float t = kTFar;
    if (valid) {
      const float sq = sqrtf(disc);
      const float lo = -b - sq, hi = -b + sq;
      t = fminf(lo > t_min ? lo : kTFar, hi > t_min ? hi : kTFar);
    }
    return t;
""", """    const float sq = sqrtf(valid ? disc : 1.0f);
    const float lo = -b - sq, hi = -b + sq;
    const float t1 = (valid && lo > t_min) ? lo : kTFar;
    const float t2 = (valid && hi > t_min) ? hi : kTFar;
    return fminf(t1, t2);
"""),)


def _sphere_shape(warps, ctas, lanes):
    """B3's and B4's shapes both set to warps / CTAs / lanes per load."""
    return dict(kB3Warps=warps, kB3MinCtas=ctas, kB3LaneVec=lanes,
                kB4Warps=warps, kB4MinCtas=ctas, kB4LaneVec=lanes)


# B3 as B1 (8 warps / 3 CTAs / 4 lanes per load), B4 as B2 (8 / 3 / 2).
_ENTRY_SHAPES = dict(kB3Warps=8, kB3MinCtas=3, kB3LaneVec=4,
                     kB4Warps=8, kB4MinCtas=3, kB4LaneVec=2)
STEPS = (
    ("1 B3, B4 staged on the entries' shapes (B3 as B1: 8 warps / 3 "
     "CTAs / 4 lanes per load; B4 as B2: 8 / 3 / 2), strips in id order, "
     "every root computed", dict(_ID_ORDER, **_ENTRY_SHAPES), _ALL_ROOTS),
    ("2 + roots only where a ray of the warp meets the sphere",
     dict(_ID_ORDER, **_ENTRY_SHAPES), ()),
    ("3 + strips with the longest lists first", _ENTRY_SHAPES, ()),
    *((f"{i} B3, B4 at {w} / {c} / {v}", _sphere_shape(w, c, v), ())
      for i, (w, c, v) in enumerate(
          itertools.product((4, 8), (4, 6, 8), (2, 4)), 4)),
    ("16 B3 at 4 / 4 / 4, B4 at 4 / 6 / 4 (shipped)", {}, ()),
    ("alt: the shipped shapes, every root computed", {}, _ALL_ROOTS),
    ("alt: the shipped shapes, strips in id order", _ID_ORDER, ()),
)
REPS = 5


def variant_source(src: str, consts: dict, patches=()) -> str:
    """``src`` with each named constexpr constant set to its new value
    and each (text, replacement) of ``patches`` applied."""
    for name, value in consts.items():
        src, n = re.subn(rf"(constexpr (?:int|bool) {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"constant {name} not found once in the source")
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"text not found once in the source: {old!r}")
        src = src.replace(old, new)
    return src


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
        spec = (cfg.packet_rays, cfg.packet_max_blocks, cfg.packet_tile_cand,
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
    """Registers and spill bytes per kernel from ``-Xptxas -v``:
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
    """closest_staged<CylT> or order_kernel from its mangled name (also
    the warp-per-strip kernels of commits before the staged design), else
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
    smi = card_name("cuda:0")

    src = sweep.LIBRARY.src.read_text()
    variants = [("0 parent", Path(a.parent) / "solr_tpu_torch" / "csrc"
                 / "sweep.cu")] if a.parent else []
    variants += [(name, variant_source(src, c, p))
                 for name, c, p in STEPS]
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(
            lambda v: cudalib.compile_library(
                (v[1].read_text() if isinstance(v[1], Path) else v[1]).encode(),
                "libsolr_sweep_variant", verbose=True), variants))
    libs = [sweep.load_library(p) for p, _ in built]
    build_s = time.time() - t0
    ptxas = {name: _registers(log) for (name, _), (_, log) in
             zip(variants, built)}

    device = torch.device("cuda:0")
    calls = _inputs(device)
    shipped = sweep.LIBRARY.load()
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
