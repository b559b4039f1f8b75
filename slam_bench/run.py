"""Run one benchmark cell of vision_slam_frontend_tpu_torch once.

    python3 slam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in BENCHMARK.json (its configuration, traffic and
limits files, found by name under slam_bench/), and runs the driver of its
traffic's `kind` (slam_bench/drivers/<kind>.py, found by name): it sets up
and warms up the port on the card, measures for `--seconds`, then checks
what the timed path produced against the plain reference in
slam_bench/reference/. Prints notes,
then the JSON result as the last line of stdout; each compared number with
its limit is the last lines of stderr. With `--trace 1` the metrics are the
cell's per-layer metrics (readers in slam_bench/layer_metrics/, one file
each, found by name) from host spans and a bounded torch.profiler slice.

Exits non-zero and prints no result without a CUDA device (or fewer than
the cell asks for), when a file it needs is missing, or when the process
holds jax, jaxlib, flax or the JAX package after the window.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_bench import common  # noqa: E402


def read_layer_metric(name: str, ctx: dict, bench_dir: Path = common.BENCH_DIR):
    """The reader slam_bench/layer_metrics/<name>.py applied to the run; None
    when it finds nothing to read."""
    return common.load_module(bench_dir, "layer_metrics", name).read(ctx)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench_dir: Path = common.BENCH_DIR) -> dict:
    """One run of cell `name`; returns the result object (and prints
    nothing). `device="cpu"` skips the card (tests only)."""
    cell = common.load_cell(name, bench_dir)
    driver = common.load_module(bench_dir, "drivers", cell["traffic"]["kind"])
    if device == "cuda":
        common.require_cuda(cell["cell"]["chips"])
    common.cache_dirs()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = driver.run(cell, seed, seconds, trace, T_PROCESS0, device=device)
    ctx = out["ctx"]
    ctx["config"], ctx["traffic"] = cell["config"], cell["traffic"]
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = read_layer_metric(m["name"], ctx, bench_dir)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": units[m["name"]]}
    checks = common.judge(out["numbers"], cell["limits"])
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics}
    if device == "cuda":
        result["device"] = common.device_info(cell["cell"]["chips"], out["peak"])
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    rec = ctx.get("slice")
    if trace and rec is not None:
        from slam_bench import devtrace

        result["device"]["busy_s"] = rec["busy_s"]
        result["device"]["window_s"] = rec["window_s"]
        result["breakdown"] = devtrace.breakdown(rec, ctx["spans"], ctx["main_thread"])
    result["checks"] = checks
    result["notes"] = out["notes"]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
        bad = common.forbidden_modules()
        if bad:
            raise common.Refused(f"the process holds forbidden modules after the window: {bad}")
    except common.Refused as e:
        print(f"slam_bench: {e}", file=sys.stderr)
        return 2
    for line in result.pop("notes"):
        print(line)
    checks = result.pop("checks")
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    common.print_checks(checks)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
