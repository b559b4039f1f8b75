"""The least time one conjugate-gradient iteration of the port's pose-major
PCG route can take, frozen: the bytes any implementation of the iteration
must move, over the published 3.35 TB/s of one NVIDIA H100 SXM's HBM3
(slam_bench/roofline.HBM_BYTES_PER_S).

An iteration applies S = U + lambda I - W V^-1 W^T (with the odometry
terms) to a pose vector, applies the block-Jacobi preconditioner and updates
the CG vectors. Counted once each, from the problem's shapes: the pose and
landmark Jacobians of every (pose, slot), (P, Mp, rows, 6) and
(P, Mp, rows, 3) float32; each slot's mask (1 byte) and landmark id (int32);
the landmark-major table into the slots and its mask, (L, Ml) int32 and
1 byte; V^-1, 6 float32 a landmark (symmetric); the odometry Jacobians,
two (P - 1, 6, 6) float32, and their pose ids; the preconditioner, (P, 6, 6)
float32; and the pose-sized vectors, 8 passes of (P, 6) float32 (p read and
S p written, x, the residual and p read and written, z written) and the
gauge mask. Nothing the iteration could keep on chip between passes is
counted twice, so the count reads the same work whatever implements it.
"""

from __future__ import annotations

from slam_bench.roofline import HBM_BYTES_PER_S

F32 = 4
I32 = 4


def cg_iteration_bytes(P: int, Mp: int, L: int, Ml: int, rows: int) -> int:
    slots = P * Mp
    jacobians = slots * rows * (6 + 3) * F32
    slot_tables = slots * (1 + I32)
    landmark_tables = L * Ml * (I32 + 1) + L * 6 * F32
    odometry = 2 * (P - 1) * 36 * F32 + 2 * (P - 1) * I32
    pose_side = P * 36 * F32 + 8 * P * 6 * F32 + P * F32
    return jacobians + slot_tables + landmark_tables + odometry + pose_side


def cg_iteration_ms(P: int, Mp: int, L: int, Ml: int, rows: int) -> float:
    return cg_iteration_bytes(P, Mp, L, Ml, rows) / HBM_BYTES_PER_S * 1e3
