"""Bunny-chain integration test (SURVEY.md §4e: the unequal-count,
real-noise workload the reference cannot run at all — its validation rejects
unequal point counts, ``src/cpu.cc:42-53``).

Marked slow: registers a subsampled 5-view chain + loop closure + pose-graph
optimization on the CPU backend and pins the drift reduction the closures
buy (thresholds here are for the heavier test subsample).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu.config import ICPConfig
from icp_tpu.io.csv import load_matrix
from icp_tpu.ops.transform import compose, inverse
from icp_tpu.slam.pairwise import chain_to_world_poses, register_chain, register_pair
from icp_tpu.slam.pose_graph import PoseEdge, optimize_pose_graph
from tests.conftest import data_path

VIEWS = ["bun000", "bun045", "bun180", "bun270", "bun315"]
SUB = 12  # heavier subsample than the script: keeps the CPU test ~a minute


def _consistency(pose_i, pose_j, edge):
    T = compose(pose_j, inverse(pose_i))
    dR = float(np.abs(np.asarray(T.R) - np.asarray(edge.R)).max())
    dt = float(np.abs(np.asarray(T.t) - np.asarray(edge.t)).max())
    return dR, dt


@pytest.mark.slow
def test_bunny_chain_closure_and_pose_graph():
    clouds = [load_matrix(data_path(v + ".txt"))[::SUB] for v in VIEWS]
    assert len({c.shape[0] for c in clouds}) > 1  # genuinely unequal counts

    cfg = ICPConfig(max_iter=60, dtype=jnp.float32, solver="eigh",
                    nn_method="bcast", with_scale=False,
                    validate_inputs=False, trim_fraction=0.3)
    pairs = register_chain(clouds, cfg, multiscale=(8, 1), init="pca")
    # every adjacent pair must actually register (trimmed err at noise scale)
    for k, pr in enumerate(pairs):
        assert pr.err < 5e-4, (k, pr.err)
    poses = chain_to_world_poses(pairs)

    closure = register_pair(clouds[4], clouds[0], cfg, multiscale=(8, 1),
                            init="pca")
    assert closure.err < 5e-4, closure.err
    edges = [
        PoseEdge(k, k + 1, jnp.asarray(np.asarray(pairs[k].transform.R)),
                 jnp.asarray(np.asarray(pairs[k].transform.t)))
        for k in range(4)
    ] + [
        PoseEdge(4, 0, jnp.asarray(np.asarray(closure.transform.R)),
                 jnp.asarray(np.asarray(closure.transform.t)))
    ]

    dR0, dt0 = _consistency(poses[4], poses[0], edges[-1])
    opt, cost = optimize_pose_graph(poses, edges, n_iters=15)
    dR1, dt1 = _consistency(opt[4], opt[0], edges[-1])

    # the chain accumulates visible drift; the pose graph must shrink it
    assert dR1 < dR0 * 0.6, (dR0, dR1)
    assert dt1 < dt0 * 0.6, (dt0, dt1)
    # absolute post-optimization consistency bounds (regression guard)
    assert dR1 < 1.0, dR1
    assert dt1 < 0.08, dt1


@pytest.mark.slow
def test_bunny_pair_engine_selectable():
    """Adjacent bunny pair registers under every engine; the plane-based
    engines reach noise-floor trimmed error in fewer iterations."""
    a = load_matrix(data_path("bun000.txt"))[::SUB]
    b = load_matrix(data_path("bun045.txt"))[::SUB]
    cfg = ICPConfig(max_iter=40, dtype=jnp.float32, solver="eigh",
                    nn_method="bcast", with_scale=False,
                    validate_inputs=False, trim_fraction=0.3)
    results = {}
    for engine in ("point_to_point", "point_to_plane", "gicp"):
        pr = register_pair(a, b, cfg, multiscale=(4, 1), init="pca",
                           engine=engine)
        results[engine] = pr
        # per-engine error bound (metrics differ: MSE / plane / Mahalanobis,
        # so cross-engine error values are NOT comparable)
        assert pr.err < 5e-4, (engine, pr.err)
    # all three engines must agree on the pose (same physical registration)
    R0 = np.asarray(results["point_to_point"].transform.R)
    t0 = np.asarray(results["point_to_point"].transform.t)
    for engine in ("point_to_plane", "gicp"):
        R = np.asarray(results[engine].transform.R)
        t = np.asarray(results[engine].transform.t)
        assert np.abs(R - R0).max() < 0.05, engine
        assert np.abs(t - t0).max() < 0.01, engine
