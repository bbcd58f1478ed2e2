#!/usr/bin/env python
"""End-to-end bunny SLAM: chain registration + loop closure + pose graph.

Registers the 5 bunny views in a chain, adds a loop-closure edge
(bun315 -> bun000, a 45-degree pair), measures the accumulated chain drift
against the directly measured closure, then optimizes the pose graph and
reports the post-optimization consistency — the quantified benefit of the
SLAM back end over dead-reckoned chaining.

By default the closure pair is hand-picked (4 -> 0, the known 45-degree
overlap); with ``--auto`` the pipeline instead DETECTS closures over all
non-adjacent pairs (slam/closure.py: FPFH + spectral + batched RANSAC),
ICP-refines them, weights every edge by its feature-verified inlier
fraction, and solves the robust (Geman-McClure) pose graph — the fully
automatic path of ``icp-slam --detect-closures``.

Usage: run_bunny_posegraph.py [subsample] [engine] [nn] [--auto] [--bucket[=Q]]

``--bucket`` (optionally ``--bucket=4096``) enables static-shape bucketing
(``ops/padding.py``): every pair whose padded sizes land in the same bucket
reuses one compiled program instead of compiling once per shape.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from icp_tpu.config import ICPConfig
from icp_tpu.io.csv import load_matrix
from icp_tpu.ops.transform import compose, inverse
from icp_tpu.slam.pairwise import chain_to_world_poses, register_chain, register_pair
from icp_tpu.slam.pose_graph import PoseEdge, optimize_pose_graph

VIEWS = ["bun000", "bun045", "bun180", "bun270", "bun315"]


def rel(pose_i, pose_j):
    """Relative transform of pose_j expressed in pose_i's frame."""
    return compose(pose_j, inverse(pose_i))


def consistency(pose_i, pose_j, edge):
    """Max-abs deviation between the pose-implied relative transform and the
    measured edge (rotation entries + translation)."""
    T = rel(pose_i, pose_j)
    dR = float(np.abs(np.asarray(T.R) - np.asarray(edge.R)).max())
    dt = float(np.abs(np.asarray(T.t) - np.asarray(edge.t)).max())
    return dR, dt


def main():
    data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
    bucket = None
    for a in sys.argv[1:]:
        if a == "--bucket":
            bucket = 4096
        elif a.startswith("--bucket="):
            bucket = int(a.split("=", 1)[1])
    args = [a for a in sys.argv[1:]
            if a != "--auto" and not a.startswith("--bucket")]
    auto = "--auto" in sys.argv[1:]
    sub = int(args[0]) if len(args) > 0 else 4
    engine = args[1] if len(args) > 1 else "point_to_point"
    nn = args[2] if len(args) > 2 else None
    clouds = [load_matrix(os.path.join(data, v + ".txt"))[::sub] for v in VIEWS]
    backend = jax.default_backend()
    cfg = ICPConfig(
        max_iter=60,
        dtype=jnp.float32,
        solver="auto",
        nn_method=nn or "auto",
        with_scale=False,
        validate_inputs=False,
        trim_fraction=0.3,
    )
    pad_sizes = None
    if bucket:
        from icp_tpu.ops.padding import bucket_size

        # chain-wide shared bucket per level: closure pairs reuse the very
        # same compiled programs as the chain pairs
        pad_sizes = [bucket_size(max(len(c[::k]) for c in clouds), bucket)
                     for k in (8, 1)]
    t0 = time.time()
    pairs = register_chain(clouds, cfg, multiscale=(8, 1), init="pca",
                           engine=engine, bucket_quantum=bucket)
    poses = chain_to_world_poses(pairs)

    extra = {}
    if auto:
        # fully automatic: detect closures, refine, weight by feature
        # evidence, robust pose graph
        from icp_tpu.slam.closure import (
            chain_edges_from_pairs,
            detect_loop_closures,
            refine_closures,
        )

        cands = detect_loop_closures(clouds)
        closure_edges, closure_results = refine_closures(
            clouds, cands, cfg, engine=engine, multiscale=(8, 1),
            bucket_quantum=bucket, pad_sizes=pad_sizes)
        if not closure_edges:
            print(json.dumps(dict(error="no closures detected",
                                  candidates=len(cands))))
            return
        chain_edges, suspects = chain_edges_from_pairs(pairs, clouds)
        edges = chain_edges + closure_edges
        closure_edge = closure_edges[0]
        closure_err = float(closure_results[0].err)
        extra = dict(
            detected_pairs=[[c.i, c.j] for c in cands],
            detected_inliers=[round(c.inlier_fraction, 3) for c in cands],
            edge_weights=[round(e.weight, 3) for e in edges],
            suspect_chain_edges=suspects,
        )
        opt_kwargs = dict(n_iters=15, robust_phi=1.0)
    else:
        # loop closure: bun315 (index 4) directly onto bun000 (index 0)
        closure = register_pair(clouds[4], clouds[0], cfg, multiscale=(8, 1),
                                init="pca", engine=engine,
                                bucket_quantum=bucket, pad_sizes=pad_sizes)
        # closure.transform maps cloud0 -> cloud4 frame: edge (i=4, j=0)
        edges = [
            PoseEdge(k, k + 1, jnp.asarray(np.asarray(pairs[k].transform.R)),
                     jnp.asarray(np.asarray(pairs[k].transform.t)))
            for k in range(4)
        ] + [
            PoseEdge(4, 0, jnp.asarray(np.asarray(closure.transform.R)),
                     jnp.asarray(np.asarray(closure.transform.t)))
        ]
        closure_edge = edges[-1]
        closure_err = round(closure.err, 7)
        opt_kwargs = dict(n_iters=15)

    dR0, dt0 = consistency(poses[closure_edge.i], poses[closure_edge.j],
                           closure_edge)
    opt, cost = optimize_pose_graph(poses, edges, **opt_kwargs)
    dR1, dt1 = consistency(opt[closure_edge.i], opt[closure_edge.j],
                           closure_edge)

    print(json.dumps(dict(
        closure_drift_before=dict(rot=round(dR0, 5), trans=round(dt0, 5)),
        closure_drift_after=dict(rot=round(dR1, 5), trans=round(dt1, 5)),
        graph_cost=cost,
        pair_errs=[round(p.err, 7) for p in pairs],
        closure_err=closure_err,
        wall_s=round(time.time() - t0, 1),
        backend=backend,
        subsample=sub,
        engine=engine,
        nn_method=cfg.nn_method,
        bucket=bucket,
        mode="auto" if auto else "manual",
        **extra,
    )))


if __name__ == "__main__":
    main()
