"""Times the staged sweep design of ``csrc/sweep.cu`` step by step on the
card, for B1 (``sweep_closest``, tri) and B6 (``sweep_transmittance``,
cyl) at the shapes ``chip_smoke.py`` times them at.

    python -m solr_tpu_torch.sweep_steps [--parent DIR] [--out FILE]

Each step is the shipped source with its shape constants (warps per
strip, occupancy hints, ``kLaneVec``, ``kStages``, ``kDeriveOnStage``)
set to other values, and with or without CylT's branch around its side
roots; ``--parent DIR`` adds the ``csrc/sweep.cu`` of another
checkout of the repository (the warp-per-strip design of the parent
commit) as the first step.  Every variant is compiled with the port's
nvcc flags, all of them at once, and called through
``sweep.launch_closest`` / ``launch_transmittance`` on the same inputs:
B1 on the bench frame's primary selection (1M triangles, 512x512,
BLOCK=512) and on the molecule frame's ground (BLOCK=256), B6 on the
molecule frame's shadow selection (100k atoms, BLOCK=256), with the
scene's factors and with fractional ones; B1 bench and B6 again with
the tiles of the longest lists launched first (a launch order the
kernels do not take yet).  Every variant's outputs must be bit-equal to
the plain versions'.  The variants are timed in
order and then in reverse order (CUDA events, mean of 5 calls after a
warm-up), on one card in one process, and both passes are reported.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.kernel_shapes import (fractional, primary_tiles,
                                          shadow_rays, sweep_args, time_ms)
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import sweep
from solr_tpu_torch.ops.traverse import scene_closest_hit

# The steps in the order the design was built: (name, constants that
# differ from the shipped source, whether CylT skips its side roots when
# no thread of the warp needs them).
_FIRST = dict(kClosestWarps=1, kTransWarps=1, kClosestMinCtas=1,
              kTransMinCtas=1, kLaneVec=1, kStages=1, kDeriveOnStage="false")
STEPS = (
    ("1 rows staged in shared memory, 1 warp per strip, 1 buffer",
     _FIRST, False),
    ("2 + double buffer (next block's rows in flight)",
     dict(_FIRST, kStages=2), False),
    ("3 + per-primitive terms computed while staging",
     dict(_FIRST, kStages=2, kDeriveOnStage="true"), False),
    ("4 + 4 warps per strip, one lane slice each",
     dict(kClosestWarps=4, kClosestMinCtas=1, kTransMinCtas=1, kLaneVec=1),
     False),
    ("5 + 8 warps per strip for closest hits",
     dict(kClosestMinCtas=1, kTransMinCtas=1, kLaneVec=1), False),
    ("6 + 4 lanes per 16-byte shared load",
     dict(kClosestMinCtas=1, kTransMinCtas=1), False),
    ("7 + occupancy hints (3 closest, 4 shadow CTAs per SM)", {}, False),
    ("8 + cylinder side roots only where a ray needs them (shipped)", {},
     True),
    ("alt: 16 warps per strip for closest hits",
     dict(kClosestWarps=16, kClosestMinCtas=1), True),
    ("alt: 8 warps per strip for shadows",
     dict(kTransWarps=8, kTransMinCtas=2), True),
    ("alt: 2 lanes per shared load", dict(kLaneVec=2), True),
)
# CylT's side roots, with and without the branch that skips them.
_SIDE_BRANCH = """    float t_side = kTFar;
    if (base) {
      const float sq = sqrtf(disc);
      float t1 = (-b - sq) / safe_a;
      float t2 = (-b + sq) / safe_a;
      const float s1 = oc_a + t1 * d_a;
      const float s2 = oc_a + t2 * d_a;
      t1 = (s1 >= 0.0f && s1 <= h2 && t1 > t_min) ? t1 : kTFar;
      t2 = (s2 >= 0.0f && s2 <= h2 && t2 > t_min) ? t2 : kTFar;
      t_side = fminf(t1, t2);
    }
"""
_SIDE_ALWAYS = """    const float sq = sqrtf(base ? disc : 1.0f);
    float t1 = (-b - sq) / safe_a;
    float t2 = (-b + sq) / safe_a;
    const float s1 = oc_a + t1 * d_a;
    const float s2 = oc_a + t2 * d_a;
    t1 = (base && s1 >= 0.0f && s1 <= h2 && t1 > t_min) ? t1 : kTFar;
    t2 = (base && s2 >= 0.0f && s2 <= h2 && t2 > t_min) ? t2 : kTFar;
    const float t_side = fminf(t1, t2);
"""
REPS = 5


def variant_source(src: str, consts: dict, side_branch: bool = True) -> str:
    """``src`` with each named constexpr constant set to its new value,
    and CylT's side roots computed for every pair unless
    ``side_branch``."""
    if not side_branch:
        if src.count(_SIDE_BRANCH) != 1:
            raise ValueError("CylT's side-root branch not found once")
        src = src.replace(_SIDE_BRANCH, _SIDE_ALWAYS)
    for name, value in consts.items():
        src, n = re.subn(rf"(constexpr (?:int|bool) {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
        if n != 1:
            raise ValueError(f"constant {name} not found once in the source")
    return src


def _inputs(device):
    """The B1 and B6 calls of chip_smoke.py: [(label, entry, prim,
    args)]."""
    calls = []
    with torch.no_grad():
        scene, cam, cfg = bench_scene(1_000_000, block=512, width=512,
                                      height=512, bounces=2, device=device)
        o_t, d_t, live = primary_tiles(cam, cfg)
        calls.append(("B1 bench", "sweep_closest", "tri",
                      sweep_args(scene.tri_accel, o_t, d_t, live, cfg, True)))
        del scene
        scene, cam, cfg = molecule_scene(100_000, 128, width=512, height=512,
                                         bounces=2, block=256, device=device)
        o_t, d_t, live = primary_tiles(cam, cfg)
        calls.append(("B1 molecule ground", "sweep_closest", "tri",
                      sweep_args(scene.tri_accel, o_t, d_t, live, cfg, True)))
        spec = (cfg.packet_rays, cfg.packet_max_blocks, cfg.packet_tile_cand,
                cfg.packet_exact)
        hit = scene_closest_hit(scene, o_t.reshape(-1, 3), d_t.reshape(-1, 3),
                                packet=spec)
        so_t, sd_t, tm_t, slive = shadow_rays(scene, o_t, d_t, hit)
        args = sweep_args(scene.cyl_accel, so_t, sd_t, slive, cfg, False,
                          tm_t)
        calls.append(("B6 molecule", "sweep_transmittance", "cyl", args))
        calls.append(("B6 molecule fractional", "sweep_transmittance", "cyl",
                      (fractional(args[0]),) + args[1:]))
    # The same work launched with the tiles of the longest lists first.
    for label, entry, prim, args in [calls[0], calls[2]]:
        calls.append((label + ", longest tiles first", entry, prim,
                      longest_first(args)))
    return calls


def longest_first(args):
    """The arguments of a sweep call with the tiles permuted so that
    those with the most listed blocks come first."""
    order = torch.argsort(args[6].sum(1), descending=True, stable=True)
    return tuple(x[order] if isinstance(x, torch.Tensor) and i > 0 else x
                 for i, x in enumerate(args))


def _launcher(entry):
    return sweep.launch_closest if entry == "sweep_closest" \
        else sweep.launch_transmittance


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
    variants = [("0 parent: warp per strip", Path(a.parent) / "solr_tpu_torch"
                 / "csrc" / "sweep.cu")] if a.parent else []
    variants += [(name, variant_source(src, c, b)) for name, c, b in STEPS]
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        paths = list(pool.map(
            lambda v: sweep.compile_library(
                (v[1].read_text() if isinstance(v[1], Path) else v[1]).encode(),
                stem="libsolr_sweep_variant")[0], variants))
    libs = [sweep.load_library(p) for p in paths]
    build_s = time.time() - t0

    device = torch.device("cuda:0")
    calls = _inputs(device)
    rec = {"nvidia_smi": smi, "torch": torch.__version__, "build_s": build_s,
           "calls": {}, "steps": []}
    with torch.no_grad():
        for label, entry, prim, args in calls:
            plain = getattr(sweep, entry + "_plain")(*args, prim=prim)
            torch.cuda.synchronize()
            counts = args[6]
            rec["calls"][label] = dict(
                strips=int(counts.numel()), block=int(args[0].shape[2]),
                mean_list=float(counts.float().mean()),
                max_list=int(counts.max()), visits=int(plain[-1].sum()),
                tests=int(plain[-1].sum()) * 32 * int(args[0].shape[2]))
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
    for step in rec["steps"]:
        cells = "  ".join(f"{label} {ms[0]:.3f}/{ms[1]:.3f}"
                          for label, ms in step["ms"].items())
        print(f"{step['step']}: {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
