"""Descriptor matching (port of ops/hamming.py): Hamming and squared L2.

Packed binary descriptors (int32 words) run kNN(2) in the Hamming kernel
(ops/cuda_kernels.hamming_top2). Float descriptors (the l2 families, SIFT)
run kNN(2) in plain torch: squared-L2 distances ||a||^2 + ||b||^2 - 2ab^T
computed in float64 and rounded once to float32, then `knn2_match`. The
matrix is materialized at every size (the reference streams it above 2048
trains; at K=8192, W=10 it is 2.7 GB in float32 here). This module then
applies the Lowe ratio test, the best-percent cut and the one-to-one cut,
with the reference's tie rules. All outputs are fixed-capacity,
query-aligned tensors with validity masks.
"""

from __future__ import annotations

import torch

from vision_slam_frontend_tpu_torch.ops.cuda_kernels import hamming_top2

_LARGE = 1e9
# Any real L2 distance of normalized descriptors is <= 2; the no-valid-train
# sentinel is sqrt(_LARGE), about 3e4.
_L2_MAX_REAL = 1e4


def knn2_match(
    dist: torch.Tensor, valid_t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query best and second-best over the train axis of a (Kq, Kt)
    distance matrix; invalid trains are ignored and the lowest index wins
    ties. Returns (best_idx (Kq,) int32, d1 (Kq,), d2 (Kq,))."""
    masked = torch.where(valid_t[None, :], dist, _LARGE)
    best = masked.argmin(1)
    d1 = masked.gather(1, best[:, None])[:, 0]
    d2 = masked.scatter(1, best[:, None], _LARGE).amin(1)
    return best.to(torch.int32), d1, d2


def l2_sq_distance_matrix(feat_q: torch.Tensor, feat_t: torch.Tensor) -> torch.Tensor:
    """(Kq, D) x (Kt, D) float descriptors -> (Kq, Kt) float32 squared L2
    distances ||a||^2 + ||b||^2 - 2ab^T.

    Every term is float64 and the result is rounded once, so the card and
    the CPU agree and the product is the exact one. (The reference's cross
    term is three bf16 passes, about 16 input bits; it is not imitated.)"""
    q = feat_q.to(torch.float64)
    t = feat_t.to(torch.float64)
    nq = (q * q).sum(-1)
    nt = (t * t).sum(-1)
    return (nq[:, None] + nt[None, :] - 2.0 * (q @ t.T)).to(torch.float32)


def _l2_knn2(
    desc_q: torch.Tensor, desc_t: torch.Tensor, valid_t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN(2) over float descriptors: (best_idx (Kq,) int32, d1, d2) as true
    L2 distances (squared, then the square root of the two kept values)."""
    best_idx, d1, d2 = knn2_match(l2_sq_distance_matrix(desc_q, desc_t), valid_t)
    # The sentinel stays huge through the root; rounding can leave a tiny
    # negative square.
    return best_idx, torch.sqrt(d1.clamp(min=0.0)), torch.sqrt(d2.clamp(min=0.0))


def _top2(desc_q: torch.Tensor, desc_t: torch.Tensor, valid_t: torch.Tensor):
    """kNN(2) by the descriptors' kind: (best_idx, d1, d2, largest real
    distance)."""
    if desc_q.dtype.is_floating_point:
        return (*_l2_knn2(desc_q, desc_t, valid_t), _L2_MAX_REAL)
    # Any true Hamming distance is <= the bit width.
    return (*hamming_top2(desc_q, desc_t, valid_t), float(desc_q.shape[1] * 32))


def hamming_distance_matrix(bits_q: torch.Tensor, bits_t: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances of unpacked {0, 1} descriptor rows:
    bits_q (..., Kq, B), bits_t (Kt, B) -> (..., Kq, Kt) float32, as pop
    counts minus twice a float32 product (exact: every partial sum of 0/1
    products is an integer below 2^24)."""
    q = bits_q.to(torch.float32)
    t = bits_t.to(torch.float32)
    cross = torch.matmul(q, t.T)
    return q.sum(-1)[..., :, None] + t.sum(-1)[None, :] - 2.0 * cross


def ratio_test_match(
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_t: torch.Tensor,
    ratio: float | torch.Tensor = 0.6,
):
    """Brute-force kNN(2) + Lowe ratio test: a query matches its nearest
    train iff d1 < ratio * d2. Packed int32 words match by Hamming distance,
    float descriptors by L2 distance.

    Returns (train_idx (Kq,) int32, 0 where unmatched; dist (Kq,) f32, 1e9
    where unmatched; matched (Kq,) bool)."""
    best_idx, d1, d2, max_real = _top2(desc_q, desc_t, valid_t)
    # The last cut rejects the no-valid-train sentinel.
    matched = valid_q & (d1 < ratio * d2) & (d1 <= max_real)
    return (
        torch.where(matched, best_idx, 0),
        torch.where(matched, d1, _LARGE),
        matched,
    )


def best_percent_mask(
    dist: torch.Tensor, matched: torch.Tensor, best_percent: float | torch.Tensor
) -> torch.Tensor:
    """Keep the floor(num_matched * best_percent) smallest distances along
    the last axis; equal distances rank by index (a stable ascending sort's
    ranks). Leading axes are batch axes."""
    masked = torch.where(matched, dist, _LARGE)
    K = masked.shape[-1]
    num_valid = matched.sum(-1, dtype=torch.int32)
    num_good = (num_valid.to(torch.float32) * best_percent).to(torch.int32)[..., None]
    if K <= 1024:
        # Counting ranks: rank_i = #{j : d_j < d_i or (d_j == d_i and j < i)}.
        less = masked[..., None, :] < masked[..., :, None]
        idx = torch.arange(K, device=dist.device)
        tie_before = (masked[..., None, :] == masked[..., :, None]) & (idx[None, :] < idx[:, None])
        ranks = (less | tie_before).sum(-1)
        return matched & (ranks < num_good)
    # Large K: the cut value from one sort; ties at the cut break by index.
    sorted_d = torch.sort(masked, dim=-1).values
    v = sorted_d.gather(-1, (num_good - 1).clamp(min=0).to(torch.int64))
    n_less = ((masked < v) & matched).sum(-1, keepdim=True)
    tie = matched & (masked == v)
    tie_i = tie.to(torch.int32)
    tie_rank = torch.cumsum(tie_i, dim=-1) - tie_i
    keep = (masked < v) | (tie & (tie_rank < num_good - n_less))
    return matched & keep & (num_good > 0)


def _dedup_per_train(best_idx: torch.Tensor, d1: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """One-to-one cut: per (frame, train) keep only the closest query;
    exact-distance ties keep both."""
    W, K = keep.shape
    tgt = torch.where(keep, best_idx, K).to(torch.int64)  # K = parked pad slot
    flat = (tgt + torch.arange(W, device=keep.device)[:, None] * (K + 1)).reshape(-1)
    dm = torch.where(keep, d1, _LARGE).reshape(-1)
    m = torch.full((W * (K + 1),), _LARGE, dtype=d1.dtype, device=d1.device)
    m = m.scatter_reduce(0, flat, dm, reduce="amin", include_self=True)
    return keep & (d1 <= m[flat].reshape(W, K))


def match_window(
    desc_window: torch.Tensor,
    valid_window: torch.Tensor,
    desc_curr: torch.Tensor,
    valid_curr: torch.Tensor,
    ratio: float | torch.Tensor,
    best_percent: float | torch.Tensor,
    mutual: bool = False,
):
    """Match all W past frames (queries) against the current frame (trains)
    in one kNN(2) over W*K queries (one kernel launch for packed words), then
    the ratio test, the per-frame best-percent cut and, with `mutual`, the
    one-to-one cut.

    Returns (train_idx (W, K) int32, dist (W, K) f32, matched (W, K) bool)."""
    W, K, words = desc_window.shape
    idx_f, d1_f, d2_f, max_real = _top2(desc_window.reshape(W * K, words), desc_curr, valid_curr)
    best_idx = idx_f.reshape(W, K)
    d1 = d1_f.reshape(W, K)
    d2 = d2_f.reshape(W, K)
    matched = valid_window & (d1 < ratio * d2) & (d1 <= max_real)
    keep = best_percent_mask(torch.where(matched, d1, _LARGE), matched, best_percent)
    if mutual:
        keep = _dedup_per_train(best_idx, d1, keep)
    return (
        torch.where(keep, best_idx, 0),
        torch.where(keep, d1, _LARGE),
        keep,
    )
