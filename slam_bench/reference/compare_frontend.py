"""The numbers that judge a frontend run against the reference.

Features are matched by content (their undistorted pixel to 1/16 px), not
by index, so one feature that differs counts once and does not shift every
later index of its keyframe. Tracks are compared by their origin: the
keyframe and pixel where the track started. Each number is a count of
what differs over the whole run, but for the 3-D points' widest relative
gap. Plain NumPy."""

from __future__ import annotations

import numpy as np


def _keys(px: np.ndarray) -> np.ndarray:
    q = np.round(np.asarray(px, np.float64) * 16.0).astype(np.int64)
    return (q[:, 0] + (1 << 20)) * (1 << 21) + (q[:, 1] + (1 << 20))


def program_nodes(problem, track_ids) -> list[dict]:
    """The program's nodes as arrays."""
    out = []
    for node, tid in zip(problem.nodes, track_ids):
        f = node.features
        out.append(dict(
            idx=node.node_idx, timestamp=node.timestamp, loc=np.asarray(node.pose.loc, np.float64),
            angle=np.asarray(node.pose.angle, np.float64),
            pixels=np.array([x.pixel for x in f], np.float32).reshape(-1, 2),
            right=np.array([x.pixel_right for x in f], np.float32).reshape(-1, 2),
            points=np.array([x.point3d for x in f], np.float32).reshape(-1, 3),
            track_id=np.asarray(tid, np.int64)))
    return out


def program_matches(problem) -> dict:
    """{current keyframe: [(past keyframe, (q, c) array)]} of the vision factors."""
    out: dict = {}
    for vf in problem.vision_factors:
        m = np.array([[x.feature_idx_initial, x.feature_idx_current] for x in vf.feature_matches],
                     np.int64).reshape(-1, 2)
        out.setdefault(vf.pose_idx_current, []).append((vf.pose_idx_initial, m))
    return out


def reference_matches(results) -> dict:
    out = {}
    for k, r in enumerate(results):
        lst = []
        for w, past in enumerate(r["w_frame"]):
            if past < 0:
                continue
            qs = np.nonzero(r["w_matched"][w])[0]
            lst.append((int(past), np.stack([qs, r["w_idx"][w][qs]], 1).astype(np.int64).reshape(-1, 2)))
        out[k] = lst
    return out


def _origins(nodes, K: int):
    """Per node, each feature's track origin (keyframe, pixel key)."""
    keys = [_keys(n["pixels"]) for n in nodes]
    out = []
    for n in nodes:
        fid0, idx0 = n["track_id"] // K, n["track_id"] % K
        k0 = np.full(len(fid0), -1, np.int64)
        for f in np.unique(fid0):
            if not 0 <= f < len(nodes):
                continue
            sel = np.nonzero((fid0 == f) & (idx0 < len(keys[f])))[0]
            k0[sel] = keys[f][idx0[sel]]
        out.append(fid0 * (1 << 42) + k0)
    return keys, out


def _align(ka: np.ndarray, kb: np.ndarray):
    """Indices (ia, ib) of the features two keyframes share by key."""
    if len(ka) == len(kb) and np.array_equal(ka, kb):
        i = np.arange(len(ka))
        return i, i
    _, ia, ib = np.intersect1d(ka, kb, assume_unique=False, return_indices=True)
    return ia, ib


def compare(prog_nodes, prog_matches, ref_kfs, ref_results, K: int, W: int, prog_window=None, ref_window=None,
            poses: bool = True) -> dict:
    """The frontend's numbers; `poses=False` leaves the node poses out
    (local BA refines them: its own numbers hold them)."""
    nodes_r = [dict(idx=i, timestamp=kf["timestamp"], loc=kf["loc"].astype(np.float64),
                    angle=kf["angle"].astype(np.float64), pixels=r["pixels"], right=r["right"],
                    points=r["points"], track_id=r["track_id"].astype(np.int64))
               for i, (kf, r) in enumerate(zip(ref_kfs, ref_results))]
    kf_gap = abs(len(prog_nodes) - len(nodes_r))
    keys_p, org_p = _origins(prog_nodes, K)
    keys_r, org_r = _origins(nodes_r, K)
    feat_bad = match_bad = 0
    point_gap = 0.0
    matches_r = reference_matches(ref_results)
    for k in range(min(len(prog_nodes), len(nodes_r))):
        p, r = prog_nodes[k], nodes_r[k]
        if p["idx"] != r["idx"] or p["timestamp"] != r["timestamp"] or (poses and (
                np.abs(p["loc"] - r["loc"]).max() > 1e-6 or np.abs(p["angle"] - r["angle"]).max() > 1e-6)):
            kf_gap += 1
        ia, ib = _align(keys_p[k], keys_r[k])
        bad = (np.abs(p["pixels"][ia] - r["pixels"][ib]).max(-1, initial=0) > 1e-3) \
            | (np.abs(p["right"][ia] - r["right"][ib]).max(-1, initial=0) > 1e-3) \
            | (org_p[k][ia] != org_r[k][ib])
        feat_bad += int(bad.sum()) + (len(keys_p[k]) - len(ia)) + (len(keys_r[k]) - len(ib))
        if len(ia):
            d = np.linalg.norm(p["points"][ia].astype(np.float64) - r["points"][ib], axis=-1)
            scale = np.maximum(np.linalg.norm(r["points"][ib].astype(np.float64), axis=-1), 1.0)
            point_gap = max(point_gap, float((d / scale).max()))

        def match_set(matches, keys):
            s = set()
            for past, m in matches:
                if past >= len(keys) or not len(m):
                    continue
                kp, kc = keys[past], keys[k]
                ok = (m[:, 0] < len(kp)) & (m[:, 1] < len(kc))
                s.update(zip([past] * int(ok.sum()), kp[m[ok, 0]].tolist(), kc[m[ok, 1]].tolist()))
                s.update(("out of range", past, int(j)) for j in np.nonzero(~ok)[0])
            return s

        a = match_set(prog_matches.get(p["idx"], []), keys_p)
        b = match_set(matches_r.get(k, []), keys_r)
        if len(prog_matches.get(p["idx"], [])) != len(matches_r.get(k, [])):
            kf_gap += 1
        match_bad += len(a ^ b)
    out = dict(keyframe_gap=float(kf_gap), feature_mismatches=float(feat_bad), match_mismatches=float(match_bad),
               point_gap_rel=point_gap)
    if prog_window is not None:
        dp, vp, fp = prog_window
        dr, vr, fr = ref_window
        rows = vp | vr
        bad = rows & ((vp != vr) | (dp != dr).any(-1))
        out["descriptor_mismatches"] = float(bad.sum()) + float((fp != fr).sum())
    return out
