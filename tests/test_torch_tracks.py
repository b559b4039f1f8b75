"""The port's track building (backend/tracks.build_ba_arrays, array code
over the whole problem) against the JAX package's build_ba_problem (a
union-find, then per-track and per-observation numpy), on the CPU.

Each case is a SLAMProblem made from a seeded generator, small and aimed at
one rule of the reference, except the last: a local-BA window of the
KITTI ORB K = 2000 cell's size (8 nodes of 1,180 features, about 12,000
matches, consistent tracks and some false merges). Both packages read the
same problem objects; every field is held equal in dtype, shape and value,
with the gather tables built and without.
"""

import numpy as np
import pytest

from vision_slam_frontend_tpu.backend import tracks as jtracks
from vision_slam_frontend_tpu_torch.backend import tracks
from vision_slam_frontend_tpu_torch.types.slam_types import (
    FeatureMatch,
    OdometryFactor,
    RobotPose,
    SLAMNode,
    SLAMProblem,
    VisionFactor,
    VisionFeature,
)


def _quat(rng, angle):
    """A unit quaternion [w, x, y, z] of `angle` radians about a random axis."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def _rot(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _extrinsic(rng, identity=False):
    ext = np.eye(4)
    if not identity:
        ext[:3, :3] = _rot(_quat(rng, 0.2))
        ext[:3, 3] = rng.normal(0, 0.3, 3)
    return ext


def _world(rng, n_nodes, n_points, n_feat, ext, noise=0.01, unit=True):
    """Nodes along x looking at points 5 to 40 m ahead, each observing
    `n_feat` of the points; returns (nodes, which point each feature sees).
    Stereo points carry `noise` metres of noise, float32 like the frontend's;
    a node's stored quaternion is off unit length unless `unit`."""
    pts = np.stack([rng.uniform(-10, 10 + n_nodes, n_points), rng.uniform(-3, 3, n_points),
                    rng.uniform(5, 40, n_points)], 1)
    nodes, seen = [], []
    for i in range(n_nodes):
        q = _quat(rng, 0.05)
        loc = np.array([0.8 * i, 0.0, 0.2 * i]) + rng.normal(0, 0.05, 3)
        ids = rng.choice(n_points, n_feat, replace=False)
        p_robot = (pts[ids] - loc) @ _rot(q)
        p_cam = (p_robot - ext[:3, 3]) @ ext[:3, :3] + rng.normal(0, noise, (n_feat, 3))
        pix = rng.uniform(0, 1241, (n_feat, 2)).astype(np.float32)
        feats = [VisionFeature(k, pix[k], p_cam[k].astype(np.float32),
                               pixel_right=pix[k] - np.float32([rng.uniform(1, 60), 0])) for k in range(n_feat)]
        stored = q * (1.0 if unit else rng.uniform(0.7, 1.3))
        nodes.append(SLAMNode(i, 0.1 * i, RobotPose(loc.astype(np.float32), stored.astype(np.float32)), feats))
        seen.append(ids)
    return nodes, seen


def _factors(rng, seen, reach=3, keep=1.0, false_share=0.0):
    """Vision factors between nodes up to `reach` apart: each shared point a
    match (a `keep` share of them), plus `false_share` as many random pairs."""
    factors = []
    for j in range(len(seen)):
        for i in range(max(0, j - reach), j):
            common, fi, fj = np.intersect1d(seen[i], seen[j], return_indices=True)
            take = rng.random(len(common)) < keep
            pairs = list(zip(fi[take].tolist(), fj[take].tolist()))
            n_false = int(false_share * len(pairs))
            pairs += list(zip(rng.integers(0, len(seen[i]), n_false).tolist(),
                              rng.integers(0, len(seen[j]), n_false).tolist()))
            rng.shuffle(pairs)
            factors.append(VisionFactor(i, j, [FeatureMatch(a, b) for a, b in pairs]))
    return factors


def _odometry(nodes):
    return [OdometryFactor(a.node_idx, b.node_idx, np.float32(b.pose.loc - a.pose.loc), np.float32([1, 0, 0, 0]))
            for a, b in zip(nodes[:-1], nodes[1:])]


def _add_features(node, points_world):
    """Append features seeing the given world points (the camera is the
    robot: the small cases' extrinsic is the identity); their indices."""
    start = len(node.features)
    p_cam = (np.asarray(points_world, np.float64) - node.pose.loc) @ _rot(np.float64(node.pose.angle))
    for k, pt in enumerate(p_cam):
        node.features.append(VisionFeature(start + k, np.float32([100 + k, 50]), np.float32(pt),
                                           pixel_right=np.float32([90 + k, 50])))
    return list(range(start, start + len(p_cam)))


def _small(rng, ext=None, n_nodes=4, n_points=40, n_feat=25, **kw):
    nodes, seen = _world(rng, n_nodes, n_points, n_feat, np.eye(4) if ext is None else ext)
    return SLAMProblem(nodes, _factors(rng, seen, **kw), _odometry(nodes))


def case_no_finite_points(rng):
    """Features without a finite point3d (tracks with fewer than two points
    are kept whole), points at z = 0.04 and at float32's 0.05, and a node
    whose location is NaN (its tracks' medians and distances are NaN)."""
    p = _small(rng, n_nodes=5)
    for k in range(0, 25, 3):
        p.nodes[0].features[k].point3d = np.float32([np.nan, 0, 1])
        p.nodes[1].features[k].point3d = np.float32([0, np.inf, 1])
    for k in range(1, 25, 5):
        p.nodes[2].features[k].point3d = np.float32([0.1, 0.2, 0.04])
        p.nodes[3].features[k].point3d = np.float32([0.1, 0.2, 0.05])
    p.nodes[4].pose.loc = np.float32([np.nan, 0, 0])
    return p, {}


def case_same_pose_chain(rng):
    """Two features of one pose chained into one track through other poses
    (the filter keeps the nearer), and two at the same point (a tie)."""
    p = _small(rng)
    first = p.vision_factors[0].feature_matches[0]
    p.vision_factors.append(VisionFactor(0, 1, [FeatureMatch(3, first.feature_idx_current)]))
    p.vision_factors.append(VisionFactor(0, 2, [FeatureMatch(4, 5), FeatureMatch(6, 5), FeatureMatch(6, 7)]))
    p.vision_factors.append(VisionFactor(1, 2, [FeatureMatch(8, 5), FeatureMatch(9, 7)]))
    # A track of two features of pose 0 at one point and one of pose 1: a
    # tie, which the earlier key wins.
    a, b = _add_features(p.nodes[0], [[1, 2, 10], [1, 2, 10]])
    (c,) = _add_features(p.nodes[1], [[1.2, 2, 10]])
    p.vision_factors.append(VisionFactor(0, 1, [FeatureMatch(b, c), FeatureMatch(a, c)]))
    return p, {}


def case_missing_node_and_feature(rng):
    """Matches to a node that is not in the problem, past a node's features,
    and a node without features."""
    p = _small(rng)
    p.nodes.append(SLAMNode(7, 0.7, RobotPose(np.float32([3, 0, 1]), np.float32([1, 0, 0, 0])), []))
    p.vision_factors.append(VisionFactor(2, 9, [FeatureMatch(0, 1), FeatureMatch(1, 2)]))
    p.vision_factors.append(VisionFactor(1, 3, [FeatureMatch(2, 30), FeatureMatch(25, 3), FeatureMatch(4, 4)]))
    p.vision_factors.append(VisionFactor(3, 7, [FeatureMatch(5, 0), FeatureMatch(6, 1)]))
    p.vision_factors.append(VisionFactor(9, 11, [FeatureMatch(0, 0)]))
    return p, {}


def case_right_pixels(rng):
    """`pixel_right` None, NaN, infinite and as a list of floats."""
    p = _small(rng)
    for k, feat in enumerate(p.nodes[1].features + p.nodes[2].features):
        if k % 4 == 0:
            feat.pixel_right = None
        elif k % 4 == 1:
            feat.pixel_right = np.float32([np.nan, 3.0])
        elif k % 4 == 2:
            feat.pixel_right = [float(feat.pixel[0]) - 2.5, float(feat.pixel[1])]
    p.nodes[3].features[0].pixel_right = np.float32([1.0, np.inf])
    return p, {}


def case_min_track_length_3(rng):
    p = _small(rng, n_nodes=5, false_share=0.2)
    return p, dict(min_track_length=3)


def case_max_landmarks_cut(rng):
    """A cap that cuts tracks which the filter later shortens: the cut ranks
    by length before the filter. The longest track, 11 features over six
    nodes, keeps three after it: two at one point in each of nodes 0 to 2
    (one per pose survives), five scattered in nodes 3 to 5."""
    p = _small(rng, n_nodes=6, n_points=60, false_share=0.05)
    for node in p.nodes[::2]:
        for feat in node.features[::3]:
            feat.point3d = feat.point3d + np.float32([3, -2, 1])
    x = [2, 1, 15]
    far = [[-6, 1, 20], [10, 1, 30], [-8, 3, 12], [12, -2, 25], [0, 9, 35]]
    chain = [_add_features(p.nodes[i], [x, x]) for i in range(3)]
    chain += [_add_features(p.nodes[i], far[k:k + 2]) for i, k in ((3, 0), (4, 2), (5, 4))]
    ends = [k for i, feats in enumerate(chain) for k in ((i, f) for f in feats)]
    p.vision_factors += [VisionFactor(a[0], b[0], [FeatureMatch(a[1], b[1])]) for a, b in zip(ends[:-1], ends[1:])]
    return p, dict(max_landmarks=4, min_track_length=3)


def case_threshold_zero(rng):
    p = _small(rng, false_share=0.3)
    return p, dict(consistency_threshold=0.0, pad_to_multiple=16)


def case_distance_at_threshold(rng):
    """A distance equal to the threshold is kept (the filter drops `d >
    thr`): nodes at the origin, unrotated, see world points as their own
    stereo points, and (0, 3, 8) lies 5 m from the median (0, 0, 4)."""
    p = _small(rng)
    for i in (0, 1):
        p.nodes[i].pose = RobotPose(np.float32([0, 0, 0]), np.float32([1, 0, 0, 0]))
    a, b = _add_features(p.nodes[0], [[0, 0, 4], [0, 0, 4]])
    (c,) = _add_features(p.nodes[1], [[0, 3, 8]])
    p.vision_factors.append(VisionFactor(0, 1, [FeatureMatch(a, c), FeatureMatch(b, c)]))
    return p, dict(consistency_threshold=5.0)


def case_no_vision_factors(rng):
    p = _small(rng)
    p.vision_factors = []
    return p, {}


def case_extrinsic(rng):
    """A non-identity left_cam_to_robot, stored quaternions off unit length
    (normalised for the filter's world points, not for the landmarks' lift)
    and a threshold that the noise straddles, so each distance's last
    operations decide."""
    ext = _extrinsic(rng)
    nodes, seen = _world(rng, 5, 150, 60, ext, noise=0.3, unit=False)
    p = SLAMProblem(nodes, _factors(rng, seen, false_share=0.1), _odometry(nodes))
    return p, dict(left_cam_to_robot=ext, consistency_threshold=0.06)


def case_cell3_window(rng):
    """A window of the KITTI ORB K = 2000 local-BA cell: 8 nodes of 1,180
    features (0.59 of K survive stereo), about 12,000 matches between nodes
    up to 3 apart, 3% of them false (merging two points' tracks)."""
    ext = _extrinsic(rng)
    nodes, seen = _world(rng, 8, 2000, 1180, ext)
    p = SLAMProblem(nodes, _factors(rng, seen, keep=0.93, false_share=0.03), _odometry(nodes))
    for feat in nodes[3].features[::40]:
        feat.pixel_right = None
    return p, dict(left_cam_to_robot=ext)


CASES = [case_no_finite_points, case_same_pose_chain, case_missing_node_and_feature, case_right_pixels,
         case_min_track_length_3, case_max_landmarks_cut, case_threshold_zero, case_distance_at_threshold,
         case_no_vision_factors, case_extrinsic, case_cell3_window]


@pytest.mark.parametrize("gather_tables", [True, False])
@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_build_ba_arrays_equals_the_jax_packages(case, gather_tables):
    problem, kw = case(np.random.default_rng(20_000 + CASES.index(case)))
    theirs = jtracks.build_ba_problem(problem, **kw)
    ours = tracks.build_ba_arrays(problem, gather_tables=gather_tables, **kw)
    fields = [f for f in theirs.__dataclass_fields__ if getattr(theirs, f) is not None]
    tables = ("pose_obs", "pose_obs_mask", "lm_obs", "lm_obs_mask")
    assert sorted(ours) == sorted(f for f in fields if gather_tables or f not in tables)
    for f in ours:
        v = np.asarray(getattr(theirs, f))
        assert ours[f].dtype == v.dtype and ours[f].shape == v.shape, f
        np.testing.assert_array_equal(ours[f], v, err_msg=f)
    if case is case_cell3_window:
        matches = sum(len(f.feature_matches) for f in problem.vision_factors)
        assert 11_000 < matches < 13_500
        assert int(ours["landmark_mask"].sum()) > 1_500


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_components_equal_a_graph_search(seed):
    """tracks._components labels each vertex with its component's smallest
    vertex, as a breadth-first search over the same edges groups them:
    random graphs, and a path through 5,000 vertices in random order (a
    chain deeper than a recursive union-find's stack)."""
    rng = np.random.default_rng(seed)
    graphs = [(int(n), rng.integers(0, n, int(e)), rng.integers(0, n, int(e)))
              for n, e in zip(rng.integers(1, 300, 40), rng.integers(0, 400, 40))]
    path = rng.permutation(5_000)
    graphs.append((5_000, path[:-1], path[1:]))
    for n, a, b in graphs:
        adjacent = [[] for _ in range(n)]
        for x, y in zip(a.tolist(), b.tolist()):
            adjacent[x].append(y)
            adjacent[y].append(x)
        expected = np.full(n, -1)
        for v in range(n):  # ascending, so each search starts at its component's smallest vertex
            if expected[v] < 0:
                expected[v], frontier = v, [v]
                while frontier:
                    frontier = [w for u in frontier for w in adjacent[u] if expected[w] < 0]
                    for w in frontier:
                        expected[w] = v
        np.testing.assert_array_equal(tracks._components(a, b, n), expected)
