"""One run of each cell on the card, in the contract's form (skips
without a card)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card(cuda, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 7), "--seconds", "30", "--trace", str(trace)],
        capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "check" and res["correct"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == want
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10
