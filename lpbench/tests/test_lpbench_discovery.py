"""A configuration, a mix, a metric and a cell added as new files are found
by their names, with no file of the harness edited."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from lpbench import harness


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(harness.LPBENCH, tmp_path / "lpbench", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "lpbench").rglob("*") if p.is_file()}

    config = json.loads((harness.LPBENCH / "configs" / "resnet50_ctx_2view.json").read_text())
    config["name"] = "resnet50_ctx_3view"
    config["config"]["data"]["view_names"] = ["top", "bot", "side"]
    (tmp_path / "lpbench" / "configs" / "resnet50_ctx_3view.json").write_text(json.dumps(config))
    mix = dict(json.loads((harness.LPBENCH / "mixes" / "predict_video.json").read_text()), session_frames=300)
    (tmp_path / "lpbench" / "mixes" / "short_sessions.json").write_text(json.dumps(mix))
    (tmp_path / "lpbench" / "metrics" / "calls.predict.py").write_text("def read(run):\n    return run.attempted\n")
    bench["configs"].append(dict(bench["configs"][0], name="resnet50_ctx_3view",
                                 file="lpbench/configs/resnet50_ctx_3view.json"))
    bench["workloads"].append({"name": "ctx3v.short", "config": "resnet50_ctx_3view", "traffic": "short_sessions",
                               "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "calls.predict", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "video_fps",
                               "workloads": ["ctx3v.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = """
import sys
sys.path.insert(0, sys.argv[1])
from lpbench import harness
from lpbench.harness import Run
cell = harness.load_cell("ctx3v.short")
print(cell.config["config"]["data"]["view_names"], cell.mix["session_frames"], cell.mix["driver"])
print(sorted(m["name"] for m in cell.per_layer), sorted(m["name"] for m in cell.end_to_end))
print(harness.load_module("metrics", "calls.predict").read(Run({}, {}, 7, 0)))
print(harness.load_module("drivers", cell.mix["driver"]).Session.__name__)
"""
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "['top', 'bot', 'side'] 300 predict_video"
    assert lines[1] == "['calls.predict'] ['peak_mem_gib', 'setup_s']"
    assert lines[2:] == ["7", "Session"]
    # no file that was there was edited
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
