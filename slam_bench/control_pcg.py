"""The control of the PCG-route BA cells (traffic kind `ba_offline_pcg`):
slam_bench/reference/ba_pcg_ref computed one precision step below what the
configuration states (residuals, Jacobians and costs in bfloat16, sums and
the solve in float32), put in the program's place and judged by the run's
own numbers against ba_pcg_ref in float64 (its exact step, and the CG
iterations the configuration states for the `route_` numbers), as
control.py does for the dense route's cell with ba_ref.

    python3 slam_bench/control_pcg.py --workload <name> --seeds <s> ...

prints each seed's numbers beside the cell's limits. The benchmark's runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_bench import ba_problem, common  # noqa: E402
from slam_bench.reference import ba_pcg_ref  # noqa: E402


def numbers(name: str, seed: int, device, bench_dir: Path = common.BENCH_DIR) -> dict:
    import torch

    cell = common.load_cell(name, bench_dir)
    config, traffic = cell["config"], cell["traffic"]
    max_iterations, cg = config["max_iterations"], config["cg_iterations"]  # as the cell's driver takes them
    cam = ba_problem.camera(config)
    prob = ba_problem.make(config, traffic, seed, device)
    arrays = ba_problem.program_arrays(prob)
    inputs = dict(prob, poses_t=arrays["poses_t"], poses_q=arrays["poses_q"], landmarks=arrays["landmarks"],
                  pixel=prob["pixel"].astype(np.float32), pixel_right=prob["pixel_right"].astype(np.float32),
                  odom_t=arrays["odom_t"], odom_q=arrays["odom_q"])
    out = {}
    for prefix, iterations in (("", None), ("route_", cg)):
        ref = ba_pcg_ref.Problem(inputs, cam, device, cg_iterations=iterations)
        rt, _, rl, rcost, _ = ba_pcg_ref.solve(ref, max_iterations)
        ctl = ba_pcg_ref.Problem(inputs, cam, device, dtype=torch.bfloat16, cg_iterations=iterations)
        ct, cq, cl, ccost, _ = ba_pcg_ref.solve(ctl, max_iterations)
        f64 = lambda x: x.to(torch.float64)
        c = ref.cost(f64(ct), f64(cq), f64(cl))
        out[prefix + "cost_gap"] = abs(c - rcost) / rcost
        if not prefix:
            out["reported_cost_gap"] = abs(ccost - c) / c if math.isfinite(ccost) else math.inf
        out[prefix + "pose_gap_m"] = float((f64(ct) - rt).abs().max())
        out[prefix + "landmark_gap_m"] = float(np.percentile((f64(cl) - rl).norm(dim=-1).cpu().numpy(), 99))
        del ref, ctl
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    limits = common.load_cell(args.workload)["limits"]["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = numbers(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got, "seconds": time.perf_counter() - t0,
                          "fails": sorted(k for k, v in got.items() if k in limits and not v <= limits[k])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
