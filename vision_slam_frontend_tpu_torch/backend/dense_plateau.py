"""The dense-BA plateau study (ROADMAP C): at the BA benchmark's shape
(P=500, L=100k, clean), the port's dense LM with a float32 coupling stopped
after 14 of 25 iterations, above the cost the JAX package reaches. The
solver now takes the JAX package's coupling arithmetic (ba._coupling_blocks);
the former assembly stays here as an ablation.

Six measurements, on the device the caller names:
- `first_step`: the first dense LM step at lambda 1e-3 in float32 against
  the same step with every tensor in float64 (the solver's arithmetic path);
- `ridge_trial`: dense LM under each rule of RIDGES for the equilibrated
  ridge (ba._dense_solve_core's fixed 1e-3), in float32 and float64. The
  rules are tried on a copy of the solve; the solver itself keeps 1e-3.
- `floor_trial`: dense LM under each of FLOORS for the landmarks' damping
  floor (ba._schur_terms' fixed 1e-5 of each landmark block's trace), in
  float32 and float64, on a copy of those terms; the solver keeps 1e-5.
- `coupling_trial`: two ablations of the coupling B B^T, each dense LM in
  float32 on a copy of ba._dense_assemble whose plan pairs observation
  slots, not (landmark, pose) groups: `port_float32`, the port's former
  assembly (one float32 product per slot pair; its stop at 43,927.2 on the
  card is ROADMAP C's record), and `compensated`, the JAX package's six
  compensated bf16 products (backend/ba.py:603-664 there) without its
  placement rounding. Beside them the JAX package's CPU figures
  (REFERENCE_CPU).
- `placement_trial`: dense LM with the solver as it is, whose coupling is
  the JAX package's arithmetic with its placement rounding (ba.placed_parts:
  where a landmark has two slots on one pose, as the benchmark's observers
  drawn with replacement give, their hi, mid and lo parts are summed per
  (landmark, pose) in float32 and each sum rounded to bfloat16 before the
  six products), beside the reference's CPU figures.
- `schedule_trial`: the former float32 dense LM (coupling_trial's
  `port_float32`) run to its stop, then one dense step from that state at
  each lambda of SCHEDULE_LAMBDAS: the cost after it, beside the stop cost
  (which lambda the shared LM schedule would need to go on).

Run: python -m vision_slam_frontend_tpu_torch.backend.dense_plateau
[--device cuda] (one JSON line per measurement; about a minute on an H100).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from unittest import mock

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.backend import ba
from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse
from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
from vision_slam_frontend_tpu_torch.utils.device import resolve_device

SHAPE = (500, 100_000, 5)  # bench_ba's and tests/test_ba_scale_accuracy.py's
ITERATIONS = 25
CG_ITERATIONS = 32
GROUND_TRUTH_COST = 43_711.0  # tests/test_ba_scale_accuracy.py:19
# The equilibrated ridge as a function of the LM lambda.
RIDGES = {
    "1e-3 (the solver's)": lambda lam: 1e-3,
    "max(lambda, 1e-6)": lambda lam: max(lam, 1e-6),
    "clamp(10 lambda, 1e-6, 1e-3)": lambda lam: min(max(10.0 * lam, 1e-6), 1e-3),
    "max(10 lambda, 1e-6)": lambda lam: max(10.0 * lam, 1e-6),
    "max(100 lambda, 1e-6)": lambda lam: max(100.0 * lam, 1e-6),
}

# The landmarks' damping floor, as a fraction of each block's trace / 3.
FLOORS = {"0": 0.0, "1e-6": 1e-6, "1e-5 (the solver's)": 1e-5, "1e-4": 1e-4}

# schedule_trial's lambdas: 1e-9 to 1e4, one per decade.
SCHEDULE_LAMBDAS = tuple(10.0**k for k in range(-9, 5))

# The JAX package's dense LM at SHAPE on the CPU (its optimize with
# BASolverConfig(max_iterations=25, schur_solver="dense", cg_iterations=32)
# on bench_ba.make_problem(500, 100_000, 5, clean=True)): the figures
# _follows_reference holds a run against.
REFERENCE_CPU = dict(cost=42_009.371, iterations=25, accepted=17, rejected=[4, 5, 6, 11, 17, 18, 20, 23],
                     ate=0.02509, cost_after_step1=2_080_473.875)


# ROADMAP.md C's CPU figures at SHAPE (float32): the placement emulation that
# the solver's coupling now is, and the former float32 run's stop with the
# JAX package's first accepted lambda when started from that state. Printed
# beside the card's; nothing is held to them.
PLACEMENT_CPU = dict(cost=42_058.1, iterations=25, accepted=19, rejected=[4, 5, 6, 9, 15, 21], ate=0.0274)
SCHEDULE_CPU = dict(stop_cost=43_844.9, reference_accepted_at=16.4)


def benchmark_problem(device):
    """(problem, camera, ground-truth positions) of the benchmark shape."""
    from vision_slam_frontend_tpu_torch.io.synthetic import make_problem

    problem, gt_t, _ = make_problem(*SHAPE, return_gt=True, clean=True, device=device)
    cam = CameraParams(fx=500.0, fy=500.0, cx=320.0, cy=240.0, R_cr=np.eye(3), t_cr=np.zeros(3)).to(device)
    return problem, cam, gt_t


def to_float64(problem, cam):
    """The problem and camera with every floating tensor in float64."""
    problem = problem.replace(**{
        f.name: getattr(problem, f.name).double() for f in dataclasses.fields(problem)
        if getattr(problem, f.name) is not None and getattr(problem, f.name).is_floating_point()
    })
    cam = dataclasses.replace(cam)
    for f in dataclasses.fields(cam):
        setattr(cam, f.name, getattr(cam, f.name).double())  # past CameraParams' float32 rule
    return problem, cam


def first_step(problem, cam) -> dict:
    """The first dense LM step (lambda 1e-3) in float32 and in float64:
    the relative differences of the pose and landmark steps' norms and of
    the cost after the step."""
    cfg = ba.BASolverConfig()
    hd, wt, wr = (ba._round_f32(x) for x in (cfg.huber_delta, cfg.odom_t_weight, cfg.odom_r_weight))
    out = {}
    for name, (p, c) in (("float32", (problem, cam)), ("float64", to_float64(problem, cam))):
        pm = ba._build_pm_inputs(p)
        d_pose, d_lm, _ = ba._dense_core(pm, *ba._linearize_pm(c, p, pm, hd, wt, wr, True), p, 1e-3, True)
        cost = float(ba.compute_cost(c, ba._apply_step(p, d_pose, d_lm), hd, wt, wr, True))
        out[name] = (d_pose.double(), d_lm.double(), cost)
    (p32, l32, c32), (p64, l64, c64) = out["float32"], out["float64"]
    return dict(step_rel_pose=float((p32 - p64).norm() / p64.norm()),
                step_rel_lm=float((l32 - l64).norm() / l64.norm()),
                cost32=c32, cost64=c64, cost_rel=abs(c32 - c64) / c64)


def _solve_core_with_ridge(S4, b, free, ridge: float):
    """A copy of ba._dense_solve_core with `ridge` in place of its 1e-3."""
    P = b.shape[0]
    S2 = S4.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
    free6 = free.repeat_interleave(6)
    S2 = S2 * free6[:, None] * free6[None, :]
    S2 = S2 + torch.diag(1.0 - free6)
    d = torch.rsqrt(torch.diagonal(S2).clamp(min=1e-20))
    S2e = S2 * d[:, None] * d[None, :] + ridge * torch.eye(6 * P, dtype=S2.dtype, device=S2.device)
    chol, info = torch.linalg.cholesky_ex(S2e)
    y = torch.linalg.solve_triangular(chol, (b.reshape(-1) * d)[:, None], upper=False)
    xe = torch.linalg.solve_triangular(chol.mT, y, upper=True)[:, 0]
    x = torch.where(info == 0, xe * d, float("nan"))
    return x.reshape(P, 6) * free[:, None], torch.linalg.norm(b - (S2 @ x).reshape(P, 6))


def _dense_core_with_ridge(ridge_of):
    """ba._dense_core with the equilibrated ridge `ridge_of(lambda)`."""

    def core(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first, plan=None):
        S4, b, free, V_inv, g_lm = ba._dense_assemble(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping,
                                                      fix_first, plan)
        d_pose, rrn = _solve_core_with_ridge(S4, b, free, ridge_of(float(lm_damping)))
        lm_mask = problem.lm_obs_mask.to(g_lm.dtype)[..., None]
        return d_pose, ba._backsub(Jp_pm, Jl_pm, problem.lm_obs, lm_mask, V_inv, g_lm, d_pose), rrn

    return core


def _schur_terms_with_floor(floor: float):
    """A copy of ba._schur_terms with the landmarks' damping floor at
    `floor` of the trace / 3 (the solver's 1e-5) where `trace_floor` is set."""

    def terms(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first, trace_floor):
        P = problem.num_poses
        L = problem.num_landmarks
        pm_mask = pm["mask"].to(r_pm.dtype)[..., None]
        lm_tbl = problem.lm_obs
        lm_mask = problem.lm_obs_mask.to(r_pm.dtype)[..., None]
        ol_pm = pm["landmark"]
        Mp = ol_pm.shape[1]
        VV = torch.einsum("pmij,pmik->pmjk", Jl_pm, Jl_pm).reshape(P, Mp, 9)
        V = ba._lm_reduce(VV, lm_tbl, lm_mask).reshape(L, 3, 3)
        damping = lm_damping
        if trace_floor:
            trV = V[..., 0, 0] + V[..., 1, 1] + V[..., 2, 2]
            damping = (floor * trV / 3.0).clamp(min=lm_damping)[..., None, None]
        V = V + damping * ba._eye(3, V)[None]
        V_inv = ba._sym3_inv(V)
        free = ba._free_mask(problem, fix_first, r_pm.dtype)
        g_odom, U_odom = ba._odom_terms(problem, Ji, Jj, ro, P)
        g_pose = -torch.einsum("pmij,pmi->pj", Jp_pm, r_pm) + g_odom
        g_lm = -ba._lm_reduce(torch.einsum("pmij,pmi->pmj", Jl_pm, r_pm), lm_tbl, lm_mask)
        s = torch.einsum("ljk,lk->lj", V_inv, g_lm)
        s_pm = s[ol_pm] * pm_mask
        Jls = torch.einsum("pmij,pmj->pmi", Jl_pm, s_pm)
        b = (g_pose - torch.einsum("pmij,pmi->pj", Jp_pm, Jls)) * free[:, None]
        U_diag = torch.einsum("pmij,pmik->pjk", Jp_pm, Jp_pm) + U_odom
        U_diag = U_diag + lm_damping * ba._eye(6, U_diag)[None]
        return dict(V=V, V_inv=V_inv, free=free, g_lm=g_lm, b=b, U_diag=U_diag, pm_mask=pm_mask,
                    lm_tbl=lm_tbl, lm_mask=lm_mask, ol_pm=ol_pm)

    return terms


def compensated_coupling(Ba, Bb):
    """Each pair's 6x6 block Ba Bb^T (Ba, Bb: (n, 6, 3)) as the JAX
    package's compensated bf16 products without its placement:
    hh + mm + hm + mh + hl + lh of each block's own parts (ba._split_bf16,
    ba._six_products)."""
    return ba._six_products(ba._split_bf16(Ba), ba._split_bf16(Bb))


def _slot_pair_plan(problem, block_poses=None):
    """The port's former coupling plan: every pair (a, b) of valid
    observation slots of each landmark l, as (l, a, b, target block
    pose(a) * Pb + pose(b) % Pb) in ba._s_init's layout."""
    Pb = block_poses or problem.num_poses
    mask = problem.lm_obs_mask
    lm, a, b = (mask[:, :, None] & mask[:, None, :]).nonzero(as_tuple=True)
    pose_of = problem.lm_obs // problem.pose_obs.shape[1]
    return lm, a, b, pose_of[lm, a] * Pb + pose_of[lm, b] % Pb


def _dense_assemble_with(coupling):
    """A copy of ba._dense_assemble over a _slot_pair_plan, whose coupling
    blocks are `coupling(Ba, Bb)` -> (n, 6, 6) for the plan's slot pairs."""

    def assemble(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first, plan=None, block_poses=None):
        t, S4, Bt = ba._dense_terms(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first, block_poses)
        lm, a, bb, target = _slot_pair_plan(problem, block_poses) if plan is None else plan
        C = coupling(Bt[lm, a], Bt[lm, bb])
        ba._scatter_add_(S4.view(-1, 36), target, -C.reshape(-1, 36))
        return S4, t["b"], t["free"], t["V_inv"], t["g_lm"]

    return assemble


def _float32_coupling(Ba, Bb):
    return torch.einsum("nic,njc->nij", Ba, Bb)


# The ablations, as patches of ba: the port's former float32 assembly, and
# the compensated products alone; each with the slot-pair plan.
FLOAT32_COUPLING = {"_dense_coupling_plan": _slot_pair_plan,
                    "_dense_assemble": _dense_assemble_with(_float32_coupling)}
COMPENSATED_PRODUCTS = {"_dense_coupling_plan": _slot_pair_plan,
                        "_dense_assemble": _dense_assemble_with(compensated_coupling)}


def _patched(patch: dict | None):
    """ba's functions replaced by `patch` (name -> replacement) while in use."""
    stack = contextlib.ExitStack()
    for name, fn in (patch or {}).items():
        stack.enter_context(mock.patch.object(ba, name, fn))
    return stack


def _lm_run(problem, cam, gt_t, patch: dict | None = None):
    """Dense LM at the benchmark's settings, with ba's functions replaced by
    `patch` (name -> replacement) where one is given: (the problem where it
    stopped, {cost, iterations, accepted, rejected (the 1-based iterations
    whose step was refused), ate, cost_after_step1 (the cost history's
    second entry)})."""
    solver = ba.BASolverConfig(max_iterations=ITERATIONS, schur_solver="dense", cg_iterations=CG_ITERATIONS)
    with _patched(patch):
        opt, info = ba.optimize(problem, cam=cam, solver=solver)
    h = info["history"]
    return opt, dict(cost=info["cost"], iterations=info["iterations"], accepted=info["accepted"],
                     rejected=[i for i in range(1, len(h)) if h[i] == h[i - 1]],
                     ate=ate_rmse(opt.poses_t.double().cpu().numpy(), gt_t), cost_after_step1=h[1])


def _lm_figures(problem, cam, gt_t, patch: dict | None = None) -> dict:
    """_lm_run's figures."""
    return _lm_run(problem, cam, gt_t, patch)[1]


def _dense_lm(problem, cam, gt_t, patch: dict) -> dict:
    """Dense LM at the benchmark's settings with ba patched by `patch`, in
    float32 and float64: {dtype: _lm_figures}."""
    runs = {"float32": (problem, cam), "float64": to_float64(problem, cam)}
    return {dtype: _lm_figures(p, c, gt_t, patch) for dtype, (p, c) in runs.items()}


def ridge_trial(problem, cam, gt_t) -> dict:
    """Dense LM under each rule of RIDGES, in float32 and float64:
    {rule: {dtype: {cost, iterations, accepted, ate}}}."""
    return {rule: _dense_lm(problem, cam, gt_t, {"_dense_core": _dense_core_with_ridge(ridge_of)})
            for rule, ridge_of in RIDGES.items()}


def floor_trial(problem, cam, gt_t) -> dict:
    """Dense LM under each landmark floor of FLOORS, in float32 and
    float64: {floor: {dtype: {cost, iterations, accepted, ate}}}."""
    return {name: _dense_lm(problem, cam, gt_t, {"_schur_terms": _schur_terms_with_floor(floor)})
            for name, floor in FLOORS.items()}


def _follows_reference(run: dict) -> bool:
    """The run rejects iterations 4 to 6, runs all ITERATIONS, and ends
    within 1% of the reference's cost."""
    return bool({4, 5, 6} <= set(run["rejected"]) and run["iterations"] == ITERATIONS
                and abs(run["cost"] - REFERENCE_CPU["cost"]) <= 0.01 * REFERENCE_CPU["cost"])


def coupling_trial(problem, cam, gt_t) -> dict:
    """Dense LM in float32 under the two ablations: the compensated bf16
    products without the placement rounding (`compensated`) and the port's
    former float32 coupling (`port_float32`), beside the JAX package's CPU
    figures (`reference_cpu`). `follows_reference`: the compensated run
    rejects iterations 4 to 6, runs all ITERATIONS, and ends within 1% of
    the reference's cost."""
    out = dict(compensated=_lm_figures(problem, cam, gt_t, COMPENSATED_PRODUCTS),
               port_float32=_lm_figures(problem, cam, gt_t, FLOAT32_COUPLING), reference_cpu=REFERENCE_CPU)
    out["follows_reference"] = _follows_reference(out["compensated"])
    return out


def placement_trial(problem, cam, gt_t) -> dict:
    """Dense LM with the solver as it is (the JAX package's placement
    rounding and compensated products: `placed`) beside the reference's CPU
    figures (`reference_cpu`); `follows_reference` as coupling_trial's, and
    `repeated_slots`: how many valid slots share a (landmark, pose) with an
    earlier slot."""
    mask = problem.lm_obs_mask
    _, first = ba._slot_groups(problem.lm_obs // problem.pose_obs.shape[1], mask)
    repeated = int((mask & ~first).sum())
    placed = _lm_figures(problem, cam, gt_t)
    return dict(placed=placed, reference_cpu=REFERENCE_CPU, repeated_slots=repeated,
                follows_reference=_follows_reference(placed))


def schedule_trial(problem, cam, gt_t) -> dict:
    """The former float32 dense LM (FLOAT32_COUPLING) at the benchmark's
    settings run to its stop, then one dense step of it from that state at
    each lambda of SCHEDULE_LAMBDAS: {stop: _lm_run's figures, lambdas,
    cost_after_step (one per lambda), accepted_from (the smallest lambda
    whose step lowers the cost, or None)}."""
    opt, stop = _lm_run(problem, cam, gt_t, FLOAT32_COUPLING)
    cfg = ba.BASolverConfig()
    hd, wt, wr = (ba._round_f32(x) for x in (cfg.huber_delta, cfg.odom_t_weight, cfg.odom_r_weight))
    pm = ba._build_pm_inputs(opt)
    lin = ba._linearize_pm(cam, opt, pm, hd, wt, wr, True)
    costs = []
    with _patched(FLOAT32_COUPLING):
        plan = ba._dense_coupling_plan(opt)
        for lam in SCHEDULE_LAMBDAS:
            d_pose, d_lm, _ = ba._dense_core(pm, *lin, opt, ba._round_f32(lam), cfg.fix_first_pose, plan)
            costs.append(float(ba.compute_cost(cam, ba._apply_step(opt, d_pose, d_lm), hd, wt, wr, True)))
    lower = [lam for lam, c in zip(SCHEDULE_LAMBDAS, costs) if np.isfinite(c) and c < stop["cost"]]
    return dict(stop=stop, lambdas=list(SCHEDULE_LAMBDAS), cost_after_step=costs,
                accepted_from=lower[0] if lower else None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    problem, cam, gt_t = benchmark_problem(device)
    print(json.dumps({"device": str(device), "first_step": first_step(problem, cam)}), flush=True)
    print(json.dumps({"device": str(device), "ground_truth_cost": GROUND_TRUTH_COST,
                      "ridges": ridge_trial(problem, cam, gt_t)}), flush=True)
    print(json.dumps({"device": str(device), "ground_truth_cost": GROUND_TRUTH_COST,
                      "landmark_floors": floor_trial(problem, cam, gt_t)}), flush=True)
    print(json.dumps({"device": str(device), "ground_truth_cost": GROUND_TRUTH_COST,
                      "coupling": coupling_trial(problem, cam, gt_t)}), flush=True)
    print(json.dumps({"device": str(device), "ground_truth_cost": GROUND_TRUTH_COST,
                      "placement": placement_trial(problem, cam, gt_t)}), flush=True)
    print(json.dumps({"device": str(device), "ground_truth_cost": GROUND_TRUTH_COST,
                      "schedule": schedule_trial(problem, cam, gt_t)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
