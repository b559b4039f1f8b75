"""The control of every cell: the plain reference computed one precision
step below what the configuration states, put in the program's place and
judged by the run's own numbers against the reference as it stands.

  frontend cells  image arithmetic (blur, resize) and undistortion in
                  bfloat16, the triangulation in float32 (frontend_ref's
                  `lowp`); with local BA, the window solves in bfloat16
  BA cell         residuals, Jacobians and costs in bfloat16, sums and the
                  solve in float32 (ba_ref)

    python3 slam_bench/control.py --workload <name> --frames <n> --seeds <s> ...

prints each seed's numbers beside the cell's limits. The benchmark's runs do
not run it; test_slam_bench_control.py runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slam_bench import ba_problem, common, scene  # noqa: E402
from slam_bench.drivers.frontend import Stream, frontend_settings, rig_calib  # noqa: E402
from slam_bench.reference import ba_ref, compare_frontend, frontend_ref, local_ba_ref  # noqa: E402


def frontend_numbers(cell: dict, seed: int, frames: int, device) -> dict:
    config, traffic = cell["config"], cell["traffic"]
    settings = frontend_settings(config)
    calib, _ = rig_calib(config)
    stream = Stream(config, traffic, seed)
    images = scene.Renderer(config, traffic, seed, device).loop_frames()
    ref = frontend_ref.ReferenceFrontend(settings, calib, device)
    kfs = ref.keyframes(stream.events(frames))
    res, win = ref.run(kfs, lambda i: images[i], batch=traffic.get("reference_batch", 8))
    ctl = frontend_ref.ReferenceFrontend(settings, calib, device, lowp=True)
    cres, cwin = ctl.run(kfs, lambda i: images[i], batch=traffic.get("reference_batch", 8))
    nodes = [dict(idx=k, timestamp=kf["timestamp"], loc=kf["loc"].astype(np.float64),
                  angle=kf["angle"].astype(np.float64), pixels=r["pixels"], right=r["right"], points=r["points"],
                  track_id=r["track_id"].astype(np.int64)) for k, (kf, r) in enumerate(zip(kfs, cres))]
    window = lambda w: (w.desc.cpu().numpy(), w.valid.cpu().numpy(), w.frame_id.cpu().numpy())
    lba = traffic.get("local_ba_window", 0)
    out = compare_frontend.compare(nodes, compare_frontend.reference_matches(cres), kfs, res,
                                   settings["max_features"], settings["frame_life"], window(cwin), window(win),
                                   poses=not lba)
    if lba:
        import torch

        def solved(results, dtype):
            nd = [dict(loc=kf["loc"], angle=kf["angle"], pixels=r["pixels"], right=r["right"], points=r["points"])
                  for kf, r in zip(kfs, results)]
            m = compare_frontend.reference_matches(results)
            return local_ba_ref.run(nd, [m[k] for k in range(len(nd))], [kf.get("odom") for kf in kfs], calib,
                                    device, dtype, window=lba)

        a, b = solved(cres, torch.bfloat16), solved(res, torch.float64)
        out["local_ba_pose_gap_m"] = max(float(np.abs(x["loc"] - y["loc"]).max()) for x, y in zip(a, b))
        out["local_ba_rotation_gap"] = max(
            float(1.0 - abs(np.dot(x["angle"].astype(np.float64), y["angle"].astype(np.float64)))) for x, y in zip(a, b))
    return out


def ba_numbers(cell: dict, seed: int, device) -> dict:
    import torch

    config, traffic = cell["config"], cell["traffic"]
    cam = ba_problem.camera(config)
    prob = ba_problem.make(config, traffic, seed, device)
    arrays = ba_problem.program_arrays(prob)
    inputs = dict(prob, poses_t=arrays["poses_t"], poses_q=arrays["poses_q"], landmarks=arrays["landmarks"],
                  pixel=prob["pixel"].astype(np.float32), pixel_right=prob["pixel_right"].astype(np.float32),
                  odom_t=arrays["odom_t"], odom_q=arrays["odom_q"])
    ref = ba_ref.Problem(inputs, cam, device)
    rt, _, rl, rcost, _ = ba_ref.solve(ref)
    ctl = ba_ref.Problem(inputs, cam, device, dtype=torch.bfloat16)
    ct, cq, cl, ccost, _ = ba_ref.solve(ctl)
    f64 = lambda x: x.to(torch.float64)
    c = ref.cost(f64(ct), f64(cq), f64(cl))
    return dict(cost_gap=abs(c - rcost) / rcost, reported_cost_gap=abs(ccost - c) / c if math.isfinite(ccost) else math.inf,
                pose_gap_m=float((f64(ct) - rt).abs().max()),
                landmark_gap_m=float(np.percentile((f64(cl) - rl).norm(dim=-1).cpu().numpy(), 99)))


def numbers(name: str, seed: int, frames: int, device, bench_dir: Path = common.BENCH_DIR) -> dict:
    cell = common.load_cell(name, bench_dir)
    if cell["traffic"]["kind"] == "ba_offline":
        return ba_numbers(cell, seed, device)
    return frontend_numbers(cell, seed, frames, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=0, help="stereo frames a frontend control replays")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    limits = common.load_cell(args.workload)["limits"]["limits"]
    for seed in args.seeds:
        got = numbers(args.workload, seed, args.frames, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": got,
                          "fails": sorted(k for k, v in got.items() if k in limits and not v <= limits[k])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
