"""Multi-process smoke: an observation-sharded BA solve across processes
(port of parallel/multihost_smoke.py).

Run once per process: each process joins a `torch.distributed` process group
(parallel/mesh.initialize_distributed; gloo on the CPU, NCCL on GPUs), takes
one rank of the shard group, and runs a short observation-sharded LM solve on
the same synthetic problem, whose all-reduces cross the process boundary.

    python -m vision_slam_frontend_tpu_torch.parallel.multihost_smoke \\
        --coordinator localhost:12345 --num_processes 2 --process_id 0 --device cpu &
    python -m vision_slam_frontend_tpu_torch.parallel.multihost_smoke \\
        --coordinator localhost:12345 --num_processes 2 --process_id 1 --device cpu

On success every process prints one `MULTIHOST_OK {...}` JSON line (world
size, initial and final cost, the final poses). With --bench_iters it then
times that many sharded LM iterations at the --poses/--landmarks shape and
prints a `MULTIHOST_BENCH` line whose collective calls and bytes per
iteration are the shard group's counts.

The port runs one rank per process, on one device: `--local_devices` (the
JAX package's count of virtual CPU devices per process) is accepted so its
command lines run, and is ignored. `--device cuda` puts rank r on GPU r
modulo the GPUs visible, over NCCL; `--device cpu` runs gloo.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--local_devices", type=int, default=1,
                    help="the JAX package's virtual devices per process; ignored (one rank per process)")
    ap.add_argument("--device", default="cuda", help="torch device type of every rank (default cuda)")
    ap.add_argument(
        "--bench_iters", type=int, default=0,
        help="after the smoke, time this many sharded LM iterations at the --poses/--landmarks shape and "
        "print a MULTIHOST_BENCH line",
    )
    ap.add_argument("--poses", type=int, default=128)
    ap.add_argument("--landmarks", type=int, default=50_000)
    ap.add_argument("--obs_per_lm", type=int, default=5)
    ap.add_argument("--cg_iters", type=int, default=32)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from vision_slam_frontend_tpu_torch.backend import ba
    from vision_slam_frontend_tpu_torch.io.synthetic import make_problem, synthetic_ba_problem
    from vision_slam_frontend_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from vision_slam_frontend_tpu_torch.parallel.sharded_ba import optimize_sharded, pad_observations, shard_ba_problem
    from vision_slam_frontend_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", args.process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
    if not initialize_distributed(args.coordinator, args.num_processes, args.process_id, device=device):
        raise RuntimeError("initialize_distributed returned False with explicit arguments")
    try:
        mesh = make_mesh(args.num_processes, device)
        # The same problem on every process, from one seed.
        cam, problem, _, _ = synthetic_ba_problem(P=16, L=1024, obs_per_lm=4, seed=0, stereo=True, pose_noise=0.03,
                                                  device=device)
        opt, info = optimize_sharded(
            pad_observations(problem, mesh.size), mesh, cam=cam,
            solver=ba.BASolverConfig(max_iterations=2, cg_iterations=8, trim_threshold=0.0),
        )
        final_t = opt.poses_t.cpu().numpy()
        if not np.isfinite(final_t).all():
            raise RuntimeError("non-finite poses after the sharded solve")
        if not info["cost"] < info["history"][0]:
            raise RuntimeError(f"multi-process sharded BA did not reduce cost: {info['history']}")
        print("MULTIHOST_OK " + json.dumps({
            "process_id": args.process_id,
            "num_processes": args.num_processes,
            "world_size": mesh.size,
            "backend": dist.get_backend(),
            "device": str(device),
            "local_devices": 1,
            "cost_initial": float(info["history"][0]),
            "cost_final": float(info["cost"]),
            "poses_t": final_t.tolist(),
        }), flush=True)

        if args.bench_iters > 0:
            prob = make_problem(args.poses, args.landmarks, args.obs_per_lm, device=device)
            sh = shard_ba_problem(pad_observations(prob, mesh.size), mesh)
            hd, wt, wr = (ba._round_f32(x) for x in (4.0, 30.0, 60.0))
            lam = ba._round_f32(1e-3)

            def one_iter(p):
                d_pose, d_lm, _ = ba._solve_schur_pcg_sharded(*ba._linearize(cam, p, hd, wt, wr, True), p, lam,
                                                              args.cg_iters, True, mesh)
                return ba._apply_step(p, d_pose, d_lm)

            p = one_iter(sh)  # warm-up
            _ = p.poses_t.cpu()
            mesh.reset_counts()
            t0 = time.perf_counter()
            for _ in range(args.bench_iters):
                p = one_iter(p)
            _ = p.poses_t.cpu()
            dt = (time.perf_counter() - t0) / args.bench_iters
            print("MULTIHOST_BENCH " + json.dumps({
                "process_id": args.process_id,
                "num_processes": args.num_processes,
                "device": str(device),
                "P": args.poses,
                "L": args.landmarks,
                "N": args.landmarks * args.obs_per_lm,
                "cg_iters": args.cg_iters,
                "sec_per_lm_iter": dt,
                "collective_bytes_per_iter": mesh.bytes / args.bench_iters,
                "collective_count_per_iter": mesh.calls / args.bench_iters,
            }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
