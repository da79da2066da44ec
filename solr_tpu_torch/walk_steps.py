"""Times the walk kernels of ``csrc/bvh_walk.cu`` in variants on the
card, on the calls ``chip_smoke.py`` times them on.

    python -m solr_tpu_torch.walk_steps [--out FILE]

Each step is the shipped source with some of its constants set to other
values (``kThreads``) or some of its text replaced (the closest hit's
child order, an occupancy hint, the cylinder and sphere rows' derived
terms computed by the kernel, a 16-byte sphere row), and, where its
leaf test reads another layout, that layout's rows.  Every variant is
compiled with the port's nvcc flags, all of them at once, and called
through ``bvh.launch_closest`` (in the dispatch's order,
``bvh.walks_near_first``) / ``launch_transmittance`` on the first
triangle calls of the bench frame at 1920x1080 (1M triangles, 2
bounces) and of the textured frame (``render(textured_scene(1920,
1080), key, spp=4)``), and on the first sphere and cylinder calls of
the molecule frame with traversal="while" (100,000 atoms, 512x512).
Every variant's t and idx, and tr, visits and tests of the shadow walk,
must be bit-equal to the shipped kernel's; a variant with another
closest-hit order reports its own visits and tests.  The variants are
timed in order and then in reverse order (CUDA events, mean of 5 calls
after a warm-up), on one card in one process, and both passes are
reported, with each kernel's registers and stack from ``-Xptxas -v``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from solr_tpu_torch.bench_scene import bench_scene
from solr_tpu_torch.kernel_shapes import first_walk_calls, ptxas_usage, time_ms
from solr_tpu_torch.molecule_scene import molecule_scene
from solr_tpu_torch.ops import bvh, sweep
from solr_tpu_torch.ops.render import render, render_sample
from solr_tpu_torch.ops.rng import Key
from solr_tpu_torch.sweep_steps import variant_source
from solr_tpu_torch.textured_scene import textured_scene

_HEADS = ("__global__ void __launch_bounds__(kThreads)\n    closest_pairs(",
          "__global__ void __launch_bounds__(kThreads)\n    trans_pairs(")


def _min_ctas(n: int):
    """Both packed kernels with an occupancy hint of n CTAs per SM."""
    return tuple((h, h.replace("(kThreads)", f"(kThreads, {n})"))
                 for h in _HEADS)


# Both kernels' stacks as one 16-byte entry per level (ref, count, tn or
# the pending count) instead of three arrays.
_INT4_STACK = (
    ("""  int32_t st_ref[kMaxStack], st_cnt[kMaxStack];
  float st_tn[kMaxStack];""", "  int4 st[kMaxStack];"),
    ("""          st_ref[sp] = right ? r0 : r1;
          st_cnt[sp] = right ? c0 : c1;
          st_tn[sp] = right ? tn0 : tn1;""",
     """          st[sp] = right ? make_int4(r0, c0, __float_as_int(tn0), 0)
                         : make_int4(r1, c1, __float_as_int(tn1), 0);"""),
    ("""      if (st_tn[sp] <= limit) {
        ref = st_ref[sp];
        cnt = st_cnt[sp];""", """      const int4 e = st[sp];
      if (__int_as_float(e.z) <= limit) {
        ref = e.x;
        cnt = e.y;"""),
    ("  int32_t st_ref[kMaxStack], st_cnt[kMaxStack], st_pend[kMaxStack];",
     "  int4 st[kMaxStack];"),
    ("""            st_ref[sp] = r1;
            st_cnt[sp] = c1;
            st_pend[sp] = pend;""",
     "            st[sp] = make_int4(r1, c1, pend, 0);"),
    ("""    pend = st_pend[sp];
    ref = st_ref[sp];
    cnt = st_cnt[sp];""", """    const int4 e = st[sp];
    pend = e.z;
    ref = e.x;
    cnt = e.y;"""),
)

# The cylinder test computing |axis|^2, 1/max(|axis|^2, 1e-8) and r*r
# itself, in the plain test's association, instead of reading them from
# its row.
_CYL_TERMS_IN_KERNEL = (
    ("""    const float ax = b.x, ay = b.y, az = b.z, h2 = b.w;
    const float inv_h2 = c.x, rad_sq = c.y;""",
     """    const float ax = b.x, ay = b.y, az = b.z;
    const float h2 = (ax * ax + ay * ay) + az * az;
    const float inv_h2 = 1.0f / clamp_min(h2, kIntersectEps);
    const float rad_sq = rad * rad;"""),
)

# The sphere test computing r*r itself instead of reading it from its
# row (the closest hit then reads 16 of the row's 32 bytes).
_SPH_R2_IN_KERNEL = (
    ("    const float rad = a.w, rad_sq = b.x;",
     "    const float rad = a.w, rad_sq = rad * rad;"),)

# The sphere test on one 16-byte row (center, r) per sphere, r*r
# computed, and the shadow factor read from a side array (stored
# reversed just before the rows: _sphere_rows16) only for a lane that
# hits.
_SPH_ROW16 = (
    ("    const float4 a = __ldg(rows + 2 * j), b = __ldg(rows + 2 * j + 1);\n"
     "    const float rad = a.w, rad_sq = b.x;\n"
     "    factor = b.y;\n",
     "    const float4 a = __ldg(rows + j);\n"
     "    const float rad = a.w, rad_sq = rad * rad;\n"),
    ("    return fminf(lo > t_min ? lo : kTFar, hi > t_min ? hi : kTFar);\n"
     "  }\n};\n\n// Capped cylinder",
     "    const float t = fminf(lo > t_min ? lo : kTFar, "
     "hi > t_min ? hi : kTFar);\n"
     "    if (t < kTFar)\n"
     "      factor = __ldg(reinterpret_cast<const float*>(rows) - 1 - j);\n"
     "    return t;\n  }\n};\n\n// Capped cylinder"),
)


def _sphere_rows16(scene):
    """_SPH_ROW16's rows: (center, r) per sphere, (N, 4) float32, a view
    into a buffer that holds the shadow factors reversed (and padded to
    16 bytes) just before them, factor j at the rows' float -1 - j."""
    p = scene.spheres
    n = p.radius.shape[0]
    factor = bvh._shadow_factor(p.material, scene.materials)
    side = torch.cat([torch.zeros_like(factor[:(-n) % 4]), factor.flip(0)])
    rows = torch.cat([p.center.to(torch.float32),
                      p.radius.to(torch.float32)[:, None]], 1)
    return torch.cat([side, rows.reshape(-1)])[side.numel():].view(n, 4)


_RIGHT = "const bool right = kNearFirst && tn1 < tn0;"

# (name, constants that differ from the shipped source, (shipped text,
# its replacement) pairs, the sphere rows it reads or None for the
# shipped ones), in the order the design was chosen.
STEPS = (
    ("1 packed nodes and rows, every closest hit in DFS order (left "
     "child first)", {}, ((_RIGHT, "const bool right = false;"),), None),
    ("2 shipped: triangles near child first, spheres and cylinders left "
     "child first", {}, (), None),
    ("3 + spheres and cylinders near child first too", {},
     ((_RIGHT, "const bool right = tn1 < tn0;"),), None),
    ("4 cylinders: h2, 1/h2 and r*r computed in the kernel, not read",
     {}, _CYL_TERMS_IN_KERNEL, None),
    ("5 spheres: r*r computed in the kernel, not read", {},
     _SPH_R2_IN_KERNEL, None),
    ("6 spheres: one 16-byte row (c, r), r*r computed, the factor read "
     "from a side array only for a lane that hits", {}, _SPH_ROW16,
     _sphere_rows16),
    ("alt: 64 threads per CTA", dict(kThreads=64), (), None),
    ("alt: 256 threads per CTA", dict(kThreads=256), (), None),
    ("alt: at least 12 CTAs per SM (40 registers)", {}, _min_ctas(12),
     None),
    ("alt: at least 16 CTAs per SM (32 registers)", {}, _min_ctas(16),
     None),
    ("alt: one 16-byte stack entry", {}, _INT4_STACK, None),
)
REPS = 5


def _calls(device):
    """[(label, scene, recorded call)] of both triangle walks on the
    1080p bench frame and the textured frame, and of both sphere and
    both cylinder walks on the molecule frame with traversal="while"."""
    out = []
    scene, cam, cfg = bench_scene(1_000_000, block=512, width=1920,
                                  height=1080, bounces=2, device=device)
    calls = first_walk_calls(lambda: render_sample(scene, cam, cfg))
    out += [(f"{e} bench 1080p", scene, calls[f"{e}_tri"])
            for e in bvh.ENTRIES]
    tex, tcam, tcfg = textured_scene(1920, 1080, device=device)
    calls = first_walk_calls(lambda: render(tex, tcam, tcfg,
                                            Key.seed(0, device), spp=4))
    out += [(f"{e} textured", tex, calls[f"{e}_tri"]) for e in bvh.ENTRIES]
    del tex, calls
    mol, mcam, mcfg = molecule_scene(100_000, 128, width=512, height=512,
                                     bounces=2, block=256, device=device)
    calls = first_walk_calls(lambda: render_sample(
        mol, mcam, dataclasses.replace(mcfg, traversal="while")))
    out += [(f"{e} molecule {p}", mol, calls[f"{e}_{p}"])
            for p in ("sphere", "cyl") for e in bvh.ENTRIES]
    return out


def _rows(make, scene, call):
    """A step's own sphere rows for a sphere call (``make(scene)``), else
    None: the shipped rows."""
    return make(scene) if make is not None and call[1] == "sphere" else None


def _launch(lib, scene, call, rows=None):
    """One launch of ``lib``'s kernel on a recorded call, the closest hit
    in the dispatch's order, on ``rows`` where given."""
    entry, prim, tree, o, d, t_min, t_max = call
    if entry == "bvh_closest_hit":
        return bvh.launch_closest(
            lib, scene, tree, prim, o, d, t_min, t_max,
            near_first=bvh.walks_near_first(scene, tree, prim), rows=rows)
    return bvh.launch_transmittance(lib, scene, tree, prim, o, d, t_min,
                                    t_max, rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/walk_steps.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_steps: no CUDA device visible", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()

    src = bvh._SRC.read_text()
    variants = [(name, variant_source(src, c, p)) for name, c, p, _ in STEPS]
    layouts = {name: rows for name, _, _, rows in STEPS}
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: sweep.compile_library(
            v[1].encode(), stem="libsolr_bvh_walk_variant", verbose=True),
            variants))
    libs = [bvh.load_library(p) for p, _ in built]
    build_s = time.time() - t0
    ptxas = {name: {k: u for k, u in ptxas_usage(log).items()
                    if "_pairs" in k} for (name, _), (_, log) in
             zip(variants, built)}

    device = torch.device("cuda:0")
    calls = _calls(device)
    shipped = bvh._library()
    rec = {"nvidia_smi": smi, "torch": torch.__version__, "build_s": build_s,
           "ptxas": ptxas, "calls": {}, "steps": []}
    counts = {name: {} for name, _ in variants}
    with torch.no_grad():
        for label, scene, call in calls:
            want = _launch(shipped, scene, call)
            rec["calls"][label] = dict(rays=int(call[3].shape[0]))
            for (name, _), lib in zip(variants, libs):
                got = _launch(lib, scene, call,
                              _rows(layouts[name], scene, call))
                same = got[:2] if call[0] == "bvh_closest_hit" else got
                if not all(torch.equal(x, y) for x, y in zip(same, want)):
                    raise AssertionError(f"{name} differs from the shipped "
                                         f"kernel on {label}")
                n = got[0].numel()
                counts[name][label] = dict(
                    visits_per_ray=int(got[-2].sum()) / n,
                    tests_per_ray=int(got[-1].sum()) / n)
        times = {name: {label: [] for label, *_ in calls}
                 for name, _ in variants}
        order = list(zip(variants, libs))
        for sweep_order in (order, order[::-1]):
            for (name, _), lib in sweep_order:
                for label, scene, call in calls:
                    rows = _rows(layouts[name], scene, call)
                    times[name][label].append(time_ms(
                        lambda: _launch(lib, scene, call, rows), REPS))
    for name, _ in variants:
        rec["steps"].append({"step": name, "ms": times[name],
                             "counts": counts[name]})
    out = Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(f"card: {smi}; {len(variants)} variants built in {build_s:.1f} s")
    for name, usage in ptxas.items():
        print(f"{name}: {usage}")
    for step in rec["steps"]:
        cells = "  ".join(f"{label} {ms[0]:.3f}/{ms[1]:.3f}"
                          for label, ms in step["ms"].items())
        print(f"{step['step']}: {cells}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
