"""On the card: one short run of each cell through the command line, as
the benchmark runs it.  Skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from solbench import manifest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  manifest.benchmark()["workloads"]])
def test_cell_runs_and_is_correct(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "solbench", "--workload", name, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
