"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 lpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, synthetic data and weights from ``--seed``, the model
loaded, every shape of the cell's traffic run once) is ``setup_s``. The
window then runs the cell's traffic for ``--seconds``. After it, the
outputs are held to the plain reference. The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device`` and, traced, ``breakdown``; ``checks``, each compared
number beside its limit, comes last, and the same numbers end standard
error. Without an NVIDIA card, or with fewer than the cell asks for, it
exits with 3 and prints no result; with JAX or the JAX package loaded, 4.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import lpbench  # noqa: E402

lpbench.use_checkout_caches()

from lpbench import harness  # noqa: E402


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """Set up, run the window and check the outputs of ``cell`` on
    ``device``. Returns the driver's :class:`~lpbench.harness.Run`, the
    set-up seconds, the peak memory, the checks, the calls whose answers
    were malformed (``failed``) and whether the checks passed."""
    import torch

    from lpbench import compare

    driver = harness.load_module("drivers", cell.mix["driver"])
    workdir = Path(tempfile.gettempdir()) / "lpbench" / cell.name
    session = driver.Session(cell, seed, workdir, device)
    try:
        session.setup()
        setup_s = time.perf_counter() - T0
        cuda = torch.device(device).type == "cuda"
        if cuda:
            for i in range(cell.chips):
                torch.cuda.reset_peak_memory_stats(i)
        run = session.window(seconds, workdir / "trace" if trace else None)
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(cell.chips)) if cuda else 0
        numbers, malformed = session.check()
    finally:
        session.cleanup()
    correct, checks = compare.judge(numbers, cell.limits)
    return {"run": run, "setup_s": setup_s, "peak": peak, "checks": checks, "phases": session.phases,
            "failed": malformed, "correct": correct and malformed == 0}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    try:
        cell = harness.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"lpbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"lpbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    run = out["run"]
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        values = {}
        for metric in cell.per_layer:
            value = harness.load_module("metrics", metric["name"]).read(run)
            if value is not None:
                values[metric["name"]] = value
    else:
        values = dict(run.metrics)
        values["setup_s"] = out["setup_s"]
        values["peak_mem_gib"] = out["peak"] / 2**30
        values = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(out["peak"])}
    result = {"correct": out["correct"], "attempted": run.attempted, "failed": out["failed"],
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()}, "device": device}
    if args.trace:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s()
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(), "idle_gaps": run.trace.idle_gaps()}
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"lpbench: JAX or the JAX package was loaded: {', '.join(leaked)}", file=sys.stderr)
        return 4
    result["checks"] = out["checks"]
    print(f"lpbench: {cell.name} seed {args.seed} on {harness.card_line()}; seconds by stage "
          + json.dumps({k: round(v, 3) for k, v in out["phases"].items()}), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
