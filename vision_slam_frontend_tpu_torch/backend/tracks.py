"""SLAMProblem -> BAProblem: chain matches into landmark tracks (port of
backend/tracks.py; numpy on the host, the same arrays as the JAX package's).

A frontend's vision factors are pairwise match lists between poses; a bundle
adjuster needs landmarks. This module chains the pairwise matches into
tracks (the connected components of the match graph over (pose, feature)
keys, labelled in numpy array code over the whole problem), initializes each
landmark from the first observation's triangulated stereo point lifted to
the world frame, and emits the flat fixed-capacity BAProblem tensors the
solver consumes, on the requested device. Only the one pass over the vision
factors and the one over the nodes read Python objects.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem, SLAMProblem
from vision_slam_frontend_tpu_torch.utils import np_geom
from vision_slam_frontend_tpu_torch.utils.device import resolve_device


def build_gather_tables(
    obs_pose: np.ndarray,
    obs_landmark: np.ndarray,
    obs_mask: np.ndarray,
    num_poses: int,
    num_landmarks: int,
    pad_multiple: int = 8,
):
    """Precompute the solver's segment-reduction plan as padded index tables.

    `sum over observations of pose p` is computed as a dense gather over
    `pose_obs[p]` + masked sum: no scatter, so the sums are deterministic on
    the GPU. Built once per problem on the host (the observation graph is
    static during a solve).

    Returns (pose_obs, pose_obs_mask, lm_obs, lm_obs_mask).
    """
    obs_pose = np.asarray(obs_pose)
    obs_landmark = np.asarray(obs_landmark)
    obs_mask = np.asarray(obs_mask)

    def table(ids, num_segments):
        idx_valid = np.nonzero(obs_mask)[0]
        order = np.argsort(ids[idx_valid], kind="stable")
        sorted_idx = idx_valid[order]
        sorted_ids = ids[idx_valid][order]
        counts = np.bincount(sorted_ids, minlength=num_segments)
        width = int(counts.max()) if len(counts) and counts.max() > 0 else 1
        width = ((width + pad_multiple - 1) // pad_multiple) * pad_multiple
        tbl = np.zeros((num_segments, width), np.int32)
        msk = np.zeros((num_segments, width), bool)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for s in range(num_segments):
            c = counts[s]
            if c:
                tbl[s, :c] = sorted_idx[starts[s] : starts[s] + c]
                msk[s, :c] = True
        return tbl, msk

    pose_obs, pose_obs_mask = table(obs_pose, num_poses)
    lm_obs, lm_obs_mask = table(obs_landmark, num_landmarks)
    # Translate the landmark table into POSE-MAJOR flat positions: the solver
    # lays observation tensors out as (P, Mp, ...) so pose-side products are
    # gather-free; landmark reductions then index that flat (P*Mp) space.
    Mp = pose_obs.shape[1]
    obs_to_pm = np.zeros(max(int(obs_pose.shape[0]), 1), np.int64)
    rows = np.repeat(np.arange(pose_obs.shape[0]), Mp)
    cols = np.tile(np.arange(Mp), pose_obs.shape[0])
    flat_idx = pose_obs.reshape(-1)
    valid = pose_obs_mask.reshape(-1)
    obs_to_pm[flat_idx[valid]] = (rows * Mp + cols)[valid]
    lm_obs_pm = obs_to_pm[lm_obs].astype(np.int32)
    lm_obs_pm[~lm_obs_mask] = 0
    return pose_obs, pose_obs_mask, lm_obs_pm, lm_obs_mask


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            self.parent[x] = p = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def build_ba_problem(
    problem: SLAMProblem,
    left_cam_to_robot: Optional[np.ndarray] = None,
    min_track_length: int = 2,
    max_landmarks: Optional[int] = None,
    pad_to_multiple: int = 128,
    consistency_threshold: float = 0.75,
    device="cuda",
) -> BAProblem:
    """Convert a SLAMProblem to flat BA arrays.

    Args:
      problem: the frontend's output.
      left_cam_to_robot: 4x4 camera->robot transform (observations are
        left-camera pixels; the solver projects world points through
        pose o extrinsic).
      min_track_length: drop tracks observed fewer than this many times
        (single-observation landmarks don't constrain anything).
      max_landmarks: optional cap, keeping the longest tracks (their
        lengths before the consistency filter).
      pad_to_multiple: pad capacities to static shapes.
      consistency_threshold: geometric track verification (metres; <= 0
        disables). Ratio-test survivors on self-similar texture still chain
        FALSE matches into one track (two different physical
        points merged), which poisons BA far beyond what Huber/trimming can
        absorb. Each observation carries its own stereo-triangulated 3D
        point; lifting them to world through the (odometry) poses, a true
        track's points agree to odometry-drift + stereo noise. Observations
        farther than `consistency_threshold * max(1, depth/5)` from the
        track's component-wise median are dropped (as are duplicate
        observations of one pose — keep the closest to the median).
      device: where the BAProblem's tensors go (default cuda; raises where
        there is no GPU).

    Returns a BAProblem of tensors on `device`.
    """
    device = resolve_device(device)
    return BAProblem.from_numpy(
        build_ba_arrays(problem, left_cam_to_robot, min_track_length, max_landmarks, pad_to_multiple,
                        consistency_threshold),
        device=device,
    )


def build_ba_arrays(
    problem: SLAMProblem,
    left_cam_to_robot: Optional[np.ndarray] = None,
    min_track_length: int = 2,
    max_landmarks: Optional[int] = None,
    pad_to_multiple: int = 128,
    consistency_threshold: float = 0.75,
    gather_tables: bool = True,
) -> dict:
    """build_ba_problem's arrays in numpy ({field: array}, index fields
    int32, the JAX package's dtypes), before any upload; without the gather
    tables when `gather_tables` is False (the scatter-form solves).

    Array code over the whole problem: one pass over the vision factors reads
    the matches, one over the nodes reads the features; tracks are the
    connected components of the match graph, and the consistency filter,
    observations and landmark points are segment-wise array operations, each
    computing what the JAX package's per-track and per-observation code does
    in the same float64 operations, so the arrays equal its bit for bit."""
    node_by_id = {n.node_idx: n for n in problem.nodes}
    if left_cam_to_robot is None:
        left_cam_to_robot = np.eye(4)
    R_cr = left_cam_to_robot[:3, :3]
    t_cr = left_cam_to_robot[:3, 3]
    nodes = _read_nodes(node_by_id, R_cr, t_cr)
    P = len(nodes.ids)

    # Keys (pose, feature) as codes that ascend as the tuples do; a track is
    # a component of the graph whose edges are the matches.
    key_pose, key_feat = _read_matches(problem.vision_factors)
    pose_vals, pose_code = np.unique(key_pose, return_inverse=True)
    feat_vals, feat_code = np.unique(key_feat, return_inverse=True)
    n_feat_vals = max(len(feat_vals), 1)
    codes, ends = np.unique(pose_code * n_feat_vals + feat_code, return_inverse=True)
    E = len(key_pose) // 2
    labels = _components(ends[:E], ends[E:], len(codes))

    # Tracks longest first, then by first key (a component's label is its
    # first key); `slots` lists their keys by (track, key).
    size = np.bincount(labels, minlength=len(codes))
    roots = np.flatnonzero(labels == np.arange(len(codes)))
    roots = roots[size[roots] >= min_track_length]
    ranked = roots[np.lexsort((roots, -size[roots]))]
    T = len(ranked)
    rank = np.full(len(codes), -1)
    rank[ranked] = np.arange(T)
    slots = np.flatnonzero(rank[labels] >= 0)
    slots = slots[np.argsort(rank[labels[slots]], kind="stable")]
    track = rank[labels[slots]]

    # Each key's node row and feature row (the sentinels where it names none).
    pose = pose_vals[codes[slots] // n_feat_vals]
    feat = feat_vals[codes[slots] % n_feat_vals]
    row = np.searchsorted(nodes.ids, pose)
    found = row < P
    found[found] = nodes.ids[row[found]] == pose[found]
    row[~found] = P
    on_node = (feat >= 0) & (feat < nodes.count[row])
    fi = np.where(on_node, nodes.start[row] + feat, -1)

    keep = np.ones(len(slots), bool)
    survives = np.ones(T, bool)
    if consistency_threshold > 0:
        keep, survives = _consistency_filter(track, row, fi, nodes, T, consistency_threshold, min_track_length)
    if max_landmarks is not None:
        # The cut ranks by each track's length before the filter.
        kept = np.zeros(T, bool)
        kept[np.flatnonzero(survives)[:max_landmarks]] = True
        survives = kept
    keep &= survives[track]

    # Landmark ids in first-observed-pose order (the JAX package's order:
    # frontend tracks are pose-local, and its banded coupling plan keys off
    # this; the landmark ids must match it).
    ks = np.flatnonzero(keep)
    firsts = ks[_run_heads(track[ks])]
    L = len(firsts)
    lid = np.zeros(T, np.int64)
    lid[track[firsts[np.argsort(slots[firsts])]]] = np.arange(L)
    ks = ks[np.argsort(lid[track[ks]], kind="stable")]
    obs = ks[on_node[ks]]
    N = len(obs)

    # Each landmark starts at its first observation with a lift-able stereo
    # point: world = pose o (cam->robot) applied to point3d.
    landmarks = np.zeros((L, 3))
    lifts = obs[nodes.lift_ok[fi[obs]]]
    lifts = lifts[_run_heads(track[lifts])]
    landmarks[lid[track[lifts]]] = _lift(nodes, row[lifts], fi[lifts], R_cr, t_cr)

    def cap(n):
        m = pad_to_multiple
        return max(m, ((n + m - 1) // m) * m)

    Pc, Lc, Nc = P, cap(L), cap(N)

    poses_t = np.zeros((Pc, 3), np.float32)
    poses_q = np.zeros((Pc, 4), np.float32)
    poses_q[:, 0] = 1.0
    pose_mask = np.zeros(Pc, bool)
    poses_t[:P] = nodes.loc[:P]
    poses_q[:P] = nodes.angle[:P]
    pose_mask[:P] = True

    lm = np.zeros((Lc, 3), np.float32)
    lm_mask = np.zeros(Lc, bool)
    lm[:L] = landmarks
    lm_mask[:L] = True

    op = np.zeros(Nc, np.int32)
    ol = np.zeros(Nc, np.int32)
    opix = np.zeros((Nc, 2), np.float32)
    omask = np.zeros(Nc, bool)
    opix_r = np.zeros((Nc, 2), np.float32)
    omask_r = np.zeros(Nc, bool)
    op[:N] = row[obs]
    ol[:N] = lid[track[obs]]
    opix[:N] = nodes.pixel[fi[obs]]
    omask[:N] = True
    opix_r[:N] = nodes.pixel_right[fi[obs]]
    omask_r[:N] = nodes.right_ok[fi[obs]]

    pose_row = {pid: i for i, pid in enumerate(nodes.ids.tolist())}
    Q = len(problem.odometry_factors)
    Qc = max(1, Q)
    oi = np.zeros(Qc, np.int32)
    oj = np.zeros(Qc, np.int32)
    ot = np.zeros((Qc, 3), np.float32)
    oq = np.zeros((Qc, 4), np.float32)
    oq[:, 0] = 1.0
    oqm = np.zeros(Qc, bool)
    for k, f in enumerate(problem.odometry_factors):
        if f.pose_i in pose_row and f.pose_j in pose_row:
            oi[k] = pose_row[f.pose_i]
            oj[k] = pose_row[f.pose_j]
            ot[k] = f.translation
            oq[k] = f.rotation
            oqm[k] = True

    arrays = dict(
        poses_t=poses_t,
        poses_q=poses_q,
        pose_mask=pose_mask,
        landmarks=lm,
        landmark_mask=lm_mask,
        obs_pose=op,
        obs_landmark=ol,
        obs_pixel=opix,
        obs_mask=omask,
        obs_pixel_right=opix_r,
        obs_right_mask=omask_r,
        odom_i=oi,
        odom_j=oj,
        odom_t=ot,
        odom_q=oq,
        odom_mask=oqm,
    )
    if gather_tables:
        tables = build_gather_tables(op, ol, omask, Pc, Lc)
        arrays.update(zip(("pose_obs", "pose_obs_mask", "lm_obs", "lm_obs_mask"), tables))
    return arrays


class _Nodes(NamedTuple):
    """A problem's nodes in node-id order, their features' rows laid end to
    end (node i's are rows start[i] to start[i] + count[i]). Each table ends
    in a sentinel row, node P with no features and feature row -1: a key that
    names no node, or no feature of its node, reads those."""

    ids: np.ndarray  # (P,) sorted node ids
    loc: np.ndarray  # (P + 1, 3) float64
    angle: np.ndarray  # (P + 1, 4) float64, as stored (not normalised)
    start: np.ndarray  # (P + 1,)
    count: np.ndarray  # (P + 1,)
    pixel: np.ndarray  # (F + 1, 2) float64
    pixel_right: np.ndarray  # (F + 1, 2) float64, zero where there is none
    right_ok: np.ndarray  # (F + 1,) a finite right pixel
    point3d: np.ndarray  # (F + 1, 3) float64
    lift_ok: np.ndarray  # (F + 1,) point3d finite and z > 0.05, compared in its own dtype
    world: np.ndarray  # (F + 1, 3) float64 world points
    world_ok: np.ndarray  # (F + 1,) point3d finite and z > 0.05, compared in float64


_NO_RIGHT = np.full(2, np.nan)
_SENTINEL = dict(pixel=np.zeros((1, 2)), pixel_right=np.zeros((1, 2)), right_ok=np.zeros(1, bool),
                 point3d=np.zeros((1, 3)), lift_ok=np.zeros(1, bool), world=np.zeros((1, 3)),
                 world_ok=np.zeros(1, bool))


def _read_nodes(node_by_id: dict, R_cr: np.ndarray, t_cr: np.ndarray) -> _Nodes:
    """The one pass over the nodes: each node's pose and its features'
    pixels, right pixels and stereo points, and those points lifted to the
    world frame in one batched matmul per node (the JAX package's
    `_node_world`, float64)."""
    ids = sorted(node_by_id)
    locs, angles, counts = [], [], []
    cols = {k: [] for k in _SENTINEL}
    for nid in ids:
        node = node_by_id[nid]
        feats = node.features
        n = len(feats)
        loc = np.asarray(node.pose.loc, np.float64)
        angle = np.asarray(node.pose.angle, np.float64)
        locs.append(loc)
        angles.append(angle)
        counts.append(n)
        if not n:
            continue
        cols["pixel"].append(np.concatenate([f.pixel for f in feats]).reshape(n, 2).astype(np.float64))
        right = np.concatenate([_NO_RIGHT if f.pixel_right is None else f.pixel_right for f in feats])
        right = right.reshape(n, 2).astype(np.float64)
        right_ok = np.all(np.isfinite(right), axis=1)
        right[~right_ok] = 0.0
        cols["pixel_right"].append(right)
        cols["right_ok"].append(right_ok)
        raw = np.concatenate([f.point3d for f in feats]).reshape(n, 3)
        p3 = raw.astype(np.float64)
        cols["point3d"].append(p3)
        cols["lift_ok"].append(np.all(np.isfinite(raw), axis=1) & (raw[:, 2] > 0.05))
        cols["world_ok"].append(np.all(np.isfinite(p3), axis=1) & (p3[:, 2] > 0.05))
        w, x, y, z = np_geom.quat_normalize(angle)
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        cols["world"].append((np.nan_to_num(p3) @ R_cr.T + t_cr) @ R.T + loc)
    counts = np.array(counts + [0], np.int64)
    return _Nodes(
        ids=np.array(ids, np.int64),
        loc=np.stack(locs + [np.zeros(3)]),
        angle=np.stack(angles + [np.zeros(4)]),
        start=np.concatenate([[0], np.cumsum(counts)[:-1]]),
        count=counts,
        **{k: np.concatenate(v + [_SENTINEL[k]]) for k, v in cols.items()},
    )


def _read_matches(factors) -> tuple:
    """The one pass over the vision factors: every match's two (pose,
    feature) keys, the initial ends then the current ends, as (pose ids,
    feature indices), each of length 2E."""
    initial, current, poses, counts = [], [], [], []
    for f in factors:
        ms = f.feature_matches
        initial += [m.feature_idx_initial for m in ms]
        current += [m.feature_idx_current for m in ms]
        poses.append((f.pose_idx_initial, f.pose_idx_current))
        counts.append(len(ms))
    poses = np.repeat(np.array(poses, np.int64).reshape(-1, 2), counts, axis=0)
    return poses.T.reshape(-1), np.array(initial + current, np.int64)


def _components(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """Connected components of the graph on vertices 0..n-1 with edges
    (a[i], b[i]): each vertex's label is the smallest vertex of its
    component. Min-label propagation over the edges, each end's root taking
    the other end's label, then pointer jumping until every vertex points at
    a root; until a round changes nothing (labels only fall, label[v] <= v).
    Hooking roots rather than ends takes O(log n) rounds, not the diameter."""
    labels = np.arange(n)
    while True:
        before = labels.copy()
        np.minimum.at(labels, labels[a], labels[b])
        np.minimum.at(labels, labels[b], labels[a])
        jumped = labels[labels]
        while not np.array_equal(jumped, labels):
            labels, jumped = jumped, jumped[jumped]
        if np.array_equal(labels, before):
            return labels


def _run_heads(*cols: np.ndarray) -> np.ndarray:
    """True where a run of equal rows of the (sorted) columns starts."""
    head = np.zeros(len(cols[0]), bool)
    head[:1] = True
    for c in cols:
        head[1:] |= c[1:] != c[:-1]
    return head


def _consistency_filter(track, row, fi, nodes: _Nodes, T: int, threshold: float, min_track_length: int):
    """Geometric track verification over all tracks at once (see
    build_ba_problem's `consistency_threshold`). `track`, `row` and `fi`
    give each key's track, node row and feature row, by (track, key).

    A track with fewer than two world points is kept whole, one with fewer
    than `min_track_length` is dropped; in the others, a point farther than
    threshold * max(1, depth / 5) from the track's component-wise median is
    dropped, and of each pose's points the nearest is kept (the earlier key
    on a tie, as a strict `<` over the keys in order keeps it). Returns
    (keep per key, survives per track)."""
    has_pt = nodes.world_ok[fi]
    n_pts = np.bincount(track[has_pt], minlength=T)
    checked = (n_pts >= 2) & (n_pts >= min_track_length)
    v = np.flatnonzero(has_pt & checked[track])
    pts = nodes.world[fi[v]]
    starts = np.flatnonzero(_run_heads(track[v]))
    n = np.diff(np.r_[starts, len(v)])
    seg = np.repeat(np.arange(len(starts)), n)
    # np.median itself, over the tracks of each point count at once.
    med = np.empty((len(starts), 3))
    for count in np.unique(n):
        tr = np.flatnonzero(n == count)
        med[tr] = np.median(pts[starts[tr, None] + np.arange(count)], axis=1)
    d = np.linalg.norm(pts - med[seg], axis=1)
    # np.linalg.norm of one 3-vector is sqrt(x.dot(x)); a (1, 3) @ (3, 1)
    # matmul takes the same dot, so the `d > thr` comparisons equal its.
    off = med - nodes.loc[row[v[starts]]]
    depth = np.sqrt(np.matmul(off[:, None, :], off[:, :, None])[:, 0, 0])
    scale = depth / 5.0
    thr = threshold * np.where(scale > 1.0, scale, 1.0)
    cand = np.flatnonzero(~(d > thr[seg]))
    # A track's keys of one pose are consecutive: keep the nearest of each
    # run, the first on a tie. A strict `<` never replaces a NaN distance
    # that comes first, and never takes a later one: fmin passes over NaN.
    head = _run_heads(seg[cand], row[v[cand]])
    dist = np.where(head & np.isnan(d[cand]), -np.inf, d[cand])
    run = np.cumsum(head) - 1
    nearest = np.flatnonzero(dist == np.fmin.reduceat(dist, np.flatnonzero(head))[run]) if len(cand) else cand
    best = v[cand[nearest[_run_heads(run[nearest])]]]
    n_sel = np.bincount(track[best], minlength=T)
    survives = (n_pts < 2) | (checked & (n_sel >= max(min_track_length, 1)))  # never an emptied track
    keep = (n_pts < 2)[track]
    keep[best] = survives[track[best]]
    return keep, survives


def _lift(nodes: _Nodes, row: np.ndarray, fi: np.ndarray, R_cr: np.ndarray, t_cr: np.ndarray) -> np.ndarray:
    """Stereo points to world points, row-wise in np_geom.quat_rotate's
    arithmetic with each node's stored (unnormalised) quaternion. R_cr @ p
    is one matrix-vector product per point, as the per-point code takes it."""
    p_robot = np.matmul(R_cr, nodes.point3d[fi][:, :, None])[:, :, 0] + t_cr
    w, u = nodes.angle[row, :1], nodes.angle[row, 1:]
    uv = np.cross(u, p_robot)
    return p_robot + 2.0 * (w * uv + np.cross(u, uv)) + nodes.loc[row]
