"""The port's headline benchmark (``python -m solr_tpu_torch.bench``) on
the CPU at a small size: its packet diagnostics and frame digest against
bench.py's (run in a child process: bench.py reads its settings from the
environment and sets SOLR_PACKET_BLOCK at import), the command's summary
line, the regression guard and a failing attempt."""

import json
import os
import subprocess
import sys

import pytest
import torch

from solr_tpu_torch import bench
from solr_tpu_torch.ops.render import render_sample

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(HERE, "data"))
import torch_reference as tr  # noqa: E402

# Several test workers share the cores: keep each one's intra-op pool small.
torch.set_num_threads(2)
CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="2")
CHILD_TIMEOUT_S = 300
REF_DIGEST_RTOL = 1e-5  # the digest against bench.py's (f32 sum, FMA contraction)
FLAGS = ["--tris", str(tr.BENCH_DIAG["tris"]),
         "--width", str(tr.BENCH_DIAG["width"]),
         "--height", str(tr.BENCH_DIAG["height"]),
         "--bounces", str(tr.BENCH_DIAG["bounces"]),
         "--block", str(tr.BENCH_DIAG["block"])]
RAYS = tr.BENCH_DIAG["width"] * tr.BENCH_DIAG["height"]


@pytest.fixture(scope="module")
def reference():
    """bench.py's diagnostics and digest for every case, computed by
    solr_tpu in a child process (Pallas in interpret mode)."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {os.path.join(HERE, 'data')!r})\n"
            "import torch_reference as tr\n"
            "print(json.dumps(tr.bench_diag_records()))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(CHILD_ENV, **tr.BENCH_DIAG_ENV),
                         capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _run_bench(*flags, metrics):
    res = subprocess.run(
        [sys.executable, "-m", "solr_tpu_torch.bench", *FLAGS, *flags,
         "--device", "cpu", "--metrics", str(metrics)], cwd=ROOT,
        env=CHILD_ENV, capture_output=True, text=True,
        timeout=CHILD_TIMEOUT_S)
    return res, json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(tr.BENCH_DIAG_CASES))
def test_diagnostics_and_digest_equal_bench_py(reference, case):
    widths = tr.BENCH_DIAG_CASES[case]
    args = bench.parse_args(FLAGS + ["--k", str(widths["k"]),
                                     "--kt", str(widths["kt"])])
    scene, cam, cfg = bench.build_scene(args, device="cpu")
    got = bench.packet_diagnostics(scene, cam, cfg)
    want = reference["cases"][case]
    assert set(bench.DIAGNOSTICS) <= set(got)
    assert bench.diagnostics_mismatch(got, want["packet"], RAYS) == {}
    # The committed copy for the card is what bench.py gives today.
    with open(tr.BENCH_DIAG_REF_FILE) as f:
        assert json.load(f)["cases"][case]["packet"] == want["packet"]
    with torch.no_grad():
        digest = float(render_sample(scene, cam, cfg)[0].double().sum())
    assert digest == pytest.approx(want["digest"], rel=REF_DIGEST_RTOL)
    if case == "tight":  # lists this narrow leave rays to the net
        assert got["net_ray_rate"] > bench.NET_RATE_BUDGET and "warning" in got


def test_diagnostics_mismatch_allowances():
    want = {"blocks": 128, "strips_per_tile": 8, "mean_strip_candidates": 6.06,
            "max_strip_candidates": 22, "mean_strip_visits": 5.75,
            "mean_visits": 2.87, "net_ray_rate": 0.0, "strip_drop_rate": 0.0}
    assert bench.diagnostics_mismatch(dict(want), want, 1024) == {}
    inside = dict(want, mean_strip_visits=5.78, mean_visits=2.9,
                  net_ray_rate=0.00195, strip_drop_rate=0.0019)
    assert bench.diagnostics_mismatch(inside, want, 1024) == {}
    outside = dict(want, blocks=129, mean_strip_candidates=6.07,
                   mean_strip_visits=5.8, mean_visits=2.92,
                   net_ray_rate=0.003, strip_drop_rate=0.0031)
    assert sorted(bench.diagnostics_mismatch(outside, want, 1024)) == sorted(
        set(want) - {"strips_per_tile", "max_strip_candidates"})


def test_command_on_cpu(tmp_path):
    res, out = _run_bench(metrics=tmp_path / "m.jsonl")
    assert res.returncode == 0, res.stderr[-3000:]
    assert set(out["paths"]) == {"packet", "while"}
    assert out["traversal"] == max(out["paths"],
                                   key=lambda p: out["paths"][p]["value"])
    assert out["value"] == max(p["value"] for p in out["paths"].values())
    assert out["rays"] == 32 * 32 * 2 * 2
    assert out["launches"] == {}  # the CPU takes the plain versions
    assert out["paths"]["packet"]["launches"] == {}
    assert out["device"] == "cpu" and out["unit"] == "rays/s"
    for rec in [out] + list(out["paths"].values()):
        assert len(rec["frame_ms_runs"]) == 3
        assert rec["frame_ms"] == min(rec["frame_ms_runs"])
        assert rec["frame_ms_mean"] == pytest.approx(
            sum(rec["frame_ms_runs"]) / 3, abs=0.01)
    assert out["path_digest_rel_diff"] <= bench.DIGEST_RTOL
    assert "warning" not in out and "errors" not in out
    assert set(bench.DIAGNOSTICS) <= set(out["packet"])
    assert out["net"]["frames"] == 3
    # No committed BENCH_r*.json names this device.
    assert out["best_prev_rays_s"] == 0 and out["regression_vs_best_prev"] == 0
    events = [json.loads(line).get("event")
              for line in open(tmp_path / "m.jsonl")]
    assert events == [None, None, "bench_summary"]


def test_best_previous_counts_only_this_card(tmp_path):
    card = "NVIDIA H100 80GB HBM3, 700.00 W"

    def record(name, value, device):
        with open(tmp_path / f"BENCH_{name}.json", "w") as f:
            json.dump({"parsed": {"unit": "rays/s", "value": value,
                                  "device": device}}, f)

    record("r01", 4.8e6, "TPU v5 lite0")
    record("r02", 0.0, None)
    assert bench._best_previous(card, str(tmp_path)) == 0.0
    record("r03", 2.5e7, card)
    record("r04", 3.0e7, "NVIDIA H100 80GB HBM3, 350.00 W")
    assert bench._best_previous(card, str(tmp_path)) == 2.5e7
    assert bench._best_previous("cpu", ROOT) == 0.0


def test_failed_attempts_exit_1(tmp_path):
    res, out = _run_bench("--attempt-timeout", "1",
                          metrics=tmp_path / "m.jsonl")
    assert res.returncode == 1
    assert out["value"] == 0.0 and "paths" not in out
    assert set(out["errors"]) == {"packet", "while"}
    assert all("timed out" in e for e in out["errors"].values())
    # No smaller scale runs in the failed attempts' place.
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert [(r.get("event"), r.get("traversal")) for r in recs] == [
        ("bench_attempt_failed", "packet"), ("bench_attempt_failed", "while"),
        ("bench_summary", None)]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(FLAGS + ["--attempt", "--traversal", "while"])
