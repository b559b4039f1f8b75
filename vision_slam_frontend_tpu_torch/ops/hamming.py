"""Hamming descriptor matching (port of the Hamming path of ops/hamming.py).

kNN(2) runs in the Hamming kernel (ops/cuda_kernels.hamming_top2); this
module applies the Lowe ratio test, the best-percent cut and the one-to-one
cut, with the reference's tie rules. All outputs are fixed-capacity,
query-aligned tensors with validity masks.
"""

from __future__ import annotations

import torch

from vision_slam_frontend_tpu_torch.ops.cuda_kernels import hamming_top2

_LARGE = 1e9


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


def ratio_test_match(
    desc_q: torch.Tensor,
    valid_q: torch.Tensor,
    desc_t: torch.Tensor,
    valid_t: torch.Tensor,
    ratio: float | torch.Tensor = 0.6,
):
    """Brute-force kNN(2) + Lowe ratio test: a query matches its nearest
    train iff d1 < ratio * d2.

    Returns (train_idx (Kq,) int32, 0 where unmatched; dist (Kq,) f32, 1e9
    where unmatched; matched (Kq,) bool)."""
    best_idx, d1, d2 = hamming_top2(desc_q, desc_t, valid_t)
    # Any true distance is <= the bit width: this cut rejects the sentinel.
    matched = valid_q & (d1 < ratio * d2) & (d1 <= float(desc_q.shape[1] * 32))
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
    in one kernel launch over W*K queries, then the ratio test, the
    per-frame best-percent cut and, with `mutual`, the one-to-one cut.

    Returns (train_idx (W, K) int32, dist (W, K) f32, matched (W, K) bool)."""
    W, K, words = desc_window.shape
    idx_f, d1_f, d2_f = hamming_top2(desc_window.reshape(W * K, words), desc_curr, valid_curr)
    best_idx = idx_f.reshape(W, K)
    d1 = d1_f.reshape(W, K)
    d2 = d2_f.reshape(W, K)
    matched = valid_window & (d1 < ratio * d2) & (d1 <= float(words * 32))
    keep = best_percent_mask(torch.where(matched, d1, _LARGE), matched, best_percent)
    if mutual:
        keep = _dedup_per_train(best_idx, d1, keep)
    return (
        torch.where(keep, best_idx, 0),
        torch.where(keep, d1, _LARGE),
        keep,
    )
