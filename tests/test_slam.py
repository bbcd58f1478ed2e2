"""SLAM layer tests: pairwise chains, pose-graph GN, and distributed BA."""

import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu import ICPConfig
from icp_tpu.ops.alignment import Similarity
from icp_tpu.ops.transform import apply_similarity, compose, identity_similarity, inverse
from icp_tpu.slam.pairwise import chain_to_world_poses, register_chain, register_pair
from icp_tpu.slam.pose_graph import (
    PoseEdge,
    bundle_adjust,
    bundle_adjust_sharded,
    optimize_pose_graph,
    params_to_poses,
    poses_to_params,
)
from tests.conftest import random_rotation


def _rand_pose(rng, scale=False):
    R = random_rotation(rng)
    s = float(rng.uniform(0.7, 1.4)) if scale else 1.0
    t = rng.standard_normal(3)
    return Similarity(jnp.asarray(s, jnp.float64), jnp.asarray(R), jnp.asarray(t))


def _make_scan_world(rng, n=400):
    return rng.standard_normal((n, 3)) * 2.0


def _small_pose(rng, rot_scale=0.15, t_scale=0.2):
    """Small similarity perturbation (ICP is local: big random rotations are
    out of its basin of convergence — that is inherent, not a bug)."""
    w = rot_scale * rng.standard_normal(3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    A = np.eye(3) + K
    U, _, Vt = np.linalg.svd(A)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R[:, 0] = -R[:, 0]
    return Similarity(
        jnp.asarray(1.0, jnp.float64),
        jnp.asarray(R),
        jnp.asarray(t_scale * rng.standard_normal(3)),
    )


def test_register_pair_unequal_counts(rng):
    world = _make_scan_world(rng)
    T = _small_pose(rng)
    # scan A sees 400 points in world frame; scan B sees 350 of them from pose T
    A = world
    B = np.asarray(apply_similarity(jnp.asarray(world[:350]), inverse(T)))
    cfg = ICPConfig(max_iter=60, dtype=jnp.float64, nn_method="bcast",
                    solver="eigh", with_scale=False, validate_inputs=False)
    pr = register_pair(A, B, cfg)
    # recovered transform should map B back into A's frame = T
    np.testing.assert_allclose(np.asarray(pr.transform.R), np.asarray(T.R), atol=1e-5)
    np.testing.assert_allclose(np.asarray(pr.transform.t), np.asarray(T.t), atol=1e-5)


def test_chain_world_poses():
    # its own generator: the scene must not depend on which tests ran
    # before this one in the same worker
    rng = np.random.default_rng(3)
    world = _make_scan_world(rng, 500)
    # ground-truth world poses for 4 scans; scan i observes world via inverse
    poses_true = [identity_similarity(jnp.float64)] + [
        _rand_pose(rng) for _ in range(3)
    ]
    # make consecutive poses CLOSE so vanilla ICP can converge
    poses_true = [identity_similarity(jnp.float64)]
    for k in range(3):
        delta_R = np.eye(3) + 0.15 * np.cross(np.eye(3), rng.standard_normal(3))
        U, _, Vt = np.linalg.svd(delta_R)
        delta = Similarity(jnp.asarray(1.0, jnp.float64), jnp.asarray(U @ Vt),
                           jnp.asarray(0.2 * rng.standard_normal(3)))
        poses_true.append(compose(poses_true[-1], delta))

    clouds = [
        np.asarray(apply_similarity(jnp.asarray(world), inverse(p)))
        for p in poses_true
    ]
    cfg = ICPConfig(max_iter=80, dtype=jnp.float64, nn_method="bcast",
                    solver="eigh", with_scale=False, validate_inputs=False)
    pairs = register_chain(clouds, cfg)
    poses_est = chain_to_world_poses(pairs)
    for est, true in zip(poses_est, poses_true):
        np.testing.assert_allclose(np.asarray(est.R), np.asarray(true.R), atol=1e-4)
        np.testing.assert_allclose(np.asarray(est.t), np.asarray(true.t), atol=1e-4)


def test_pose_params_roundtrip(rng):
    poses = [identity_similarity(jnp.float32)] + [_rand_pose(rng) for _ in range(3)]
    theta = poses_to_params(poses)
    back = params_to_poses(theta)
    for p, b in zip(poses, back):
        np.testing.assert_allclose(np.asarray(b.R), np.asarray(p.R), atol=1e-6)
        np.testing.assert_allclose(np.asarray(b.t), np.asarray(p.t), atol=1e-6)


def _relative(pi: Similarity, pj: Similarity) -> PoseEdge:
    rel = compose(pj, inverse(pi))  # T_i^-1 T_j in our row convention
    return None, rel


def test_pose_graph_gn_closes_loop(rng):
    # 4 poses on a loop; edges = noisy consecutive + loop closure.
    true = [identity_similarity(jnp.float32)]
    for _ in range(3):
        d = _small_pose(rng, rot_scale=0.4, t_scale=1.0)
        d32 = Similarity(
            jnp.asarray(1.0, jnp.float32),
            jnp.asarray(np.asarray(d.R), jnp.float32),
            jnp.asarray(np.asarray(d.t), jnp.float32),
        )
        true.append(compose(true[-1], d32))

    def edge(i, j, noise=0.0):
        Ri = np.asarray(true[i].R)
        Rj = np.asarray(true[j].R)
        ti = np.asarray(true[i].t)
        tj = np.asarray(true[j].t)
        R_ij = Ri.T @ Rj
        t_ij = Ri.T @ (tj - ti)
        if noise:
            t_ij = t_ij + noise * rng.standard_normal(3)
        return PoseEdge(i, j, jnp.asarray(R_ij, jnp.float32), jnp.asarray(t_ij, jnp.float32))

    edges = [edge(0, 1), edge(1, 2), edge(2, 3), edge(0, 3)]
    # corrupt the initial poses
    init = [true[0]]
    for p in true[1:]:
        init.append(
            Similarity(p.s, p.R, p.t + jnp.asarray(0.3 * rng.standard_normal(3), jnp.float32))
        )
    opt, cost = optimize_pose_graph(init, edges, n_iters=15)
    assert cost < 1e-8
    for o, t in zip(opt, true):
        np.testing.assert_allclose(np.asarray(o.t), np.asarray(t.t), atol=1e-3)
        np.testing.assert_allclose(np.asarray(o.R), np.asarray(t.R), atol=1e-3)


def test_pose_graph_scales_and_reuses_program():
    # 48-pose ring (chain + ring closure + 8 chords): the vmapped block
    # assembly must (a) converge on a graph this size, (b) serve a second
    # graph with the SAME (n_poses, n_edges) shape but DIFFERENT topology
    # and measurements from the same compiled program (topology is data).
    from icp_tpu.slam.pose_graph import _optimize_jit

    def make_problem(seed, chords):
        rng = np.random.default_rng(seed)
        true = [identity_similarity(jnp.float32)]
        for _ in range(47):
            d = _small_pose(rng, rot_scale=0.25, t_scale=0.5)
            d32 = Similarity(
                jnp.asarray(1.0, jnp.float32),
                jnp.asarray(np.asarray(d.R), jnp.float32),
                jnp.asarray(np.asarray(d.t), jnp.float32),
            )
            true.append(compose(true[-1], d32))

        def edge(i, j, t_noise=0.0):
            Ri, Rj = np.asarray(true[i].R), np.asarray(true[j].R)
            ti, tj = np.asarray(true[i].t), np.asarray(true[j].t)
            t_ij = Ri.T @ (tj - ti) + t_noise * rng.standard_normal(3)
            return PoseEdge(i, j, jnp.asarray(Ri.T @ Rj, jnp.float32),
                            jnp.asarray(t_ij, jnp.float32))

        edges = [edge(k, k + 1) for k in range(47)]
        edges.append(edge(0, 47))
        edges += [edge(i, j) for i, j in chords]
        init = [true[0]] + [
            Similarity(p.s, p.R,
                       p.t + jnp.asarray(0.25 * rng.standard_normal(3),
                                         jnp.float32))
            for p in true[1:]
        ]
        return true, edges, init

    chords_a = [(0, 24), (8, 32), (16, 40), (4, 28), (12, 36),
                (20, 44), (2, 26), (10, 34)]
    chords_b = [(1, 25), (9, 33), (17, 41), (5, 29), (13, 37),
                (21, 45), (3, 27), (11, 35)]
    true, edges, init = make_problem(21, chords_a)
    before = _optimize_jit._cache_size()
    opt, _ = optimize_pose_graph(init, edges, n_iters=20)
    for o, t in zip(opt, true):
        np.testing.assert_allclose(np.asarray(o.R), np.asarray(t.R), atol=1e-3)
        np.testing.assert_allclose(np.asarray(o.t), np.asarray(t.t), atol=1e-3)
    true2, edges2, init2 = make_problem(22, chords_b)
    opt2, _ = optimize_pose_graph(init2, edges2, n_iters=20)
    for o, t in zip(opt2, true2):
        np.testing.assert_allclose(np.asarray(o.t), np.asarray(t.t), atol=1e-3)
    assert _optimize_jit._cache_size() == before + 1, (
        "same-shape graph with different topology recompiled"
    )


def test_pose_graph_robust_rejects_outlier_edge():
    # local generator: drawing from the session ``rng`` fixture here would
    # shift the stream position of every test after this one in the file
    rng = np.random.default_rng(11)
    # 5 poses with a redundant cycle structure (chain + three closures) and
    # ONE garbage edge: DCS (robust_phi) must recover the true poses while
    # plain least squares splits the garbage across the graph.  The init is
    # the realistic bad one: world poses chained THROUGH the garbage edge.
    true = [identity_similarity(jnp.float32)]
    for _ in range(4):
        d = _small_pose(rng, rot_scale=0.4, t_scale=1.0)
        d32 = Similarity(
            jnp.asarray(1.0, jnp.float32),
            jnp.asarray(np.asarray(d.R), jnp.float32),
            jnp.asarray(np.asarray(d.t), jnp.float32),
        )
        true.append(compose(true[-1], d32))

    def edge(i, j, garbage=False):
        if garbage:
            R_ij = random_rotation(rng).astype(np.float32)
            t_ij = np.array([3.0, -2.0, 1.0], np.float32)
        else:
            Ri, Rj = np.asarray(true[i].R), np.asarray(true[j].R)
            ti, tj = np.asarray(true[i].t), np.asarray(true[j].t)
            R_ij = Ri.T @ Rj
            t_ij = Ri.T @ (tj - ti)
        return PoseEdge(i, j, jnp.asarray(R_ij, jnp.float32),
                        jnp.asarray(t_ij, jnp.float32))

    bad = edge(1, 2, garbage=True)
    edges = [edge(0, 1), bad, edge(2, 3), edge(3, 4),
             edge(0, 2), edge(1, 3), edge(2, 4)]
    # init: chain composition through the garbage edge (poses 2..4 wrong)
    init = list(true[:2])
    for k, e in enumerate([bad, edges[2], edges[3]], start=2):
        prev = init[-1]
        init.append(Similarity(
            prev.s, prev.R @ e.R, prev.t + jnp.ravel(e.t @ prev.R.T)))

    def max_t_err(poses):
        return max(float(np.linalg.norm(np.asarray(o.t) - np.asarray(tp.t)))
                   for o, tp in zip(poses, true))

    plain, _ = optimize_pose_graph(init, edges, n_iters=25)
    robust, _ = optimize_pose_graph(init, edges, n_iters=25, robust_phi=1.0)
    assert max_t_err(robust) < 1e-2, max_t_err(robust)
    assert max_t_err(plain) > 5 * max_t_err(robust)
    for o, t in zip(robust, true):
        np.testing.assert_allclose(np.asarray(o.R), np.asarray(t.R), atol=1e-2)


def _ba_problem(rng, n_pts=64):
    # 3 poses; shared world points seen in each frame; init poses perturbed.
    true = [identity_similarity(jnp.float32)]
    for _ in range(2):
        R = random_rotation(rng).astype(np.float32)
        true.append(Similarity(jnp.asarray(1.0, jnp.float32), jnp.asarray(R),
                               jnp.asarray(rng.standard_normal(3).astype(np.float32))))
    world = rng.standard_normal((n_pts, 3)).astype(np.float32)
    frames = [
        np.asarray(apply_similarity(jnp.asarray(world), inverse(p)), np.float32)
        for p in true
    ]
    corr = [
        (0, 1, frames[0], frames[1]),
        (1, 2, frames[1], frames[2]),
        (0, 2, frames[0], frames[2]),
    ]
    init = [true[0]] + [
        Similarity(p.s, p.R, p.t + jnp.asarray(0.2 * rng.standard_normal(3), jnp.float32))
        for p in true[1:]
    ]
    return true, corr, init


def test_bundle_adjust_recovers_poses(rng):
    true, corr, init = _ba_problem(rng)
    opt, cost = bundle_adjust(init, corr, n_iters=10)
    assert cost < 1e-6
    for o, t in zip(opt, true):
        np.testing.assert_allclose(np.asarray(o.t), np.asarray(t.t), atol=1e-3)
        np.testing.assert_allclose(np.asarray(o.R), np.asarray(t.R), atol=1e-3)


def test_bundle_adjust_sharded_matches_single(rng):
    true, corr, init = _ba_problem(rng, n_pts=40)
    opt_s, cost_s = bundle_adjust(init, corr, n_iters=8)
    opt_d, cost_d = bundle_adjust_sharded(init, corr, n_iters=8)
    np.testing.assert_allclose(cost_d, cost_s, rtol=1e-3, atol=1e-8)
    for a, b in zip(opt_s, opt_d):
        np.testing.assert_allclose(np.asarray(a.R), np.asarray(b.R), atol=1e-4)
        np.testing.assert_allclose(np.asarray(a.t), np.asarray(b.t), atol=1e-4)
