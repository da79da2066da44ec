"""Runs of one cell in turns from two checkouts, as a check runs parent
and change: ``python -m solbench.pairs --trees A B --workload <cell>
--seeds s1,s2,... [--warm a] [--out FILE]``.

Every seed runs tree A then tree B, then every seed again, tree B then
tree A.  A run is one process, ``python3 -m solbench --workload <cell>
--seed <s> --seconds <run_seconds> --trace 0`` from the tree's root
(``run_seconds`` from tree A's ``BENCHMARK.json``), with a ``HOME``,
``XDG_CACHE_HOME`` and ``TMPDIR`` of the tree's own beside it.
``--warm`` names the trees (``a``, ``b``) that run once first,
uncounted, so that their kernels are built before the pairs; a tree
left cold builds in its first counted run.  Each run's record (its
metrics, the window's step summary where the run notes one, the load
average before it) goes to ``--out`` as one line of JSON as it ends; at
the end one summary line per tree: the median of the cell's end-to-end
metrics, the spread a check reads (max - min, leaving out the run
farthest from the median), and the quartile distance over the median.
An A/A run gives both trees one commit."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from solbench.harness import STEPS

TIMEOUT_S = 1200  # a run's limit, its first (which builds) included


def check_spread(values: list) -> float:
    """max - min, leaving out the value farthest from the median where
    that narrows it."""
    med = statistics.median(values)
    if len(values) < 3:
        return max(values) - min(values)
    rest = sorted(values, key=lambda v: abs(v - med))[:-1]
    return max(rest) - min(rest)


def quartile_share(values: list) -> float:
    """The distance between the first and third quartiles over the
    median, as ``statistics.quantiles(n=4)`` gives them."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def summary(values: list) -> dict:
    med = statistics.median(values)
    return {"n": len(values), "median": med, "min": min(values),
            "max": max(values), "check_spread": check_spread(values),
            "check_spread_share": check_spread(values) / med,
            "quartile_share": quartile_share(values)}


def _env(tree: str) -> dict:
    """A HOME, XDG_CACHE_HOME and TMPDIR of the tree's own, beside it."""
    env = dict(os.environ)
    base = os.path.abspath(tree) + ".env"
    for key, sub in (("HOME", "home"), ("XDG_CACHE_HOME", "cache"),
                     ("TMPDIR", "tmp")):
        env[key] = os.path.join(base, sub)
        os.makedirs(env[key], exist_ok=True)
    return env


def run_once(tree: str, workload: str, seed: int, seconds: int) -> dict:
    cmd = [sys.executable, "-m", "solbench", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"]
    load = os.getloadavg()[0]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=tree, env=_env(tree), capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    rec = {"rc": res.returncode, "wall_s": time.perf_counter() - t0,
           "load1": load}
    lines = res.stdout.strip().splitlines()
    try:
        line = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        rec["stderr_tail"] = res.stderr[-2000:]
        return rec
    rec["correct"] = line["correct"]
    rec["metrics"] = {k: v["value"] for k, v in line["metrics"].items()}
    rec["check"] = {k: v["value"] for k, v in line["check"].items()}
    for text in res.stderr.splitlines():
        if text.startswith(STEPS):
            rec["steps"] = json.loads(text[len(STEPS):])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--warm", default="", help="a, b or ab")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    trees = dict(zip("ab", args.trees))
    seeds = [int(s) for s in args.seeds.split(",")]
    with open(os.path.join(trees["a"], "BENCHMARK.json")) as f:
        seconds = json.load(f)["run_seconds"]
    turns = [("warm", side, seeds[0]) for side in args.warm]
    for order in ("ab", "ba"):
        turns += [(order, side, seed) for seed in seeds for side in order]
    values = {"a": {}, "b": {}}
    for i, (order, side, seed) in enumerate(turns):
        rec = {"turn": i, "order": order, "tree": side, "seed": seed,
               **run_once(trees[side], args.workload, seed, seconds)}
        line = json.dumps(rec)
        print(line[:400], flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if order != "warm" and rec["rc"] == 0:
            for name, value in rec["metrics"].items():
                values[side].setdefault(name, []).append(value)
    for side, by_metric in values.items():
        print(json.dumps({"tree": side, "path": trees[side],
                          **{name: summary(v) for name, v in
                             by_metric.items() if len(v) >= 2}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
