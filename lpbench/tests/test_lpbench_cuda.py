"""On the card: a short run of each cell is correct and prints the
contract's line (marked ``cuda``; skipped without a card)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from lpbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(cuda_card, workload, traced):
    out = subprocess.run([sys.executable, str(harness.LPBENCH / "run.py"), "--workload", workload,
                          "--seed", str(2**31 + 17), "--seconds", "3", "--trace", str(traced)],
                         capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    cell = harness.load_cell(workload)
    wanted = cell.per_layer if traced else cell.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    else:
        assert set(line["metrics"]) == {m["name"] for m in wanted}
