"""Multi-scan registration CLI: ``icp-slam scan0.txt scan1.txt ... ``

Registers each scan onto its predecessor (unequal point counts fine — the
bunny workload the reference cannot run), composes world poses, optionally
refines them with point-level bundle adjustment, and writes every scan
transformed into scan 0's frame plus a poses checkpoint.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="icp-slam", description="multi-scan registration"
    )
    p.add_argument("clouds", nargs="+", help="scan CSVs, in chain order")
    p.add_argument("--max-iter", type=int, default=60)
    p.add_argument("--threshold", type=float, default=1e-5)
    p.add_argument("--subsample", type=int, default=1,
                   help="use every k-th point for registration (outputs are full)")
    p.add_argument("--voxel", type=float, default=0.0, metavar="SIZE",
                   help="voxel-grid downsample each scan to SIZE-sized voxel "
                        "centroids for registration (outputs are full; "
                        "composes with --subsample, voxel applied after)")
    p.add_argument("--multiscale", type=int, nargs="*", default=[1],
                   help="coarse-to-fine subsampling levels, e.g. 16 4 1 "
                        "(widens the convergence basin for distant views)")
    p.add_argument("--init", default=None, choices=[None, "pca", "fpfh"],
                   help="per-pair global initialization (pca: principal-axis "
                        "alignment, rescues large-rotation pairs; fpfh: "
                        "feature matching + RANSAC, also handles partial "
                        "overlap where PCA's whole-cloud axes diverge)")
    p.add_argument("--scale", action="store_true",
                   help="similarity (allow per-pair scale); default rigid")
    p.add_argument("--engine", default="point_to_point",
                   choices=["point_to_point", "point_to_plane", "gicp",
                            "symmetric"],
                   help="registration metric (plane-based engines converge "
                        "in ~3 iters and handle sliding contact)")
    p.add_argument("--trim", type=float, default=0.0, metavar="FRAC",
                   help="trimmed registration: reject this fraction of "
                        "worst matches per iteration")
    p.add_argument("--bucket", type=int, default=-1, metavar="QUANTUM",
                   help="static-shape bucketing: pad each pair's clouds to "
                        "the next QUANTUM multiple (true counts masked) so "
                        "similar-size pairs share ONE compiled program.  "
                        "Default "
                        "-1 = auto (ON for unequal-count chains, quantum "
                        "auto-sized); 0 = off; or give an explicit quantum")
    p.add_argument("--refine", action="store_true",
                   help="bundle-adjust poses after the chain")
    p.add_argument("--detect-closures", action="store_true",
                   help="detect non-adjacent overlapping scan pairs "
                        "(FPFH + RANSAC), refine them with ICP, and "
                        "pose-graph-optimize the chain with the closure "
                        "edges (cancels accumulated drift)")
    p.add_argument("--closure-min-inliers", type=float, default=0.15,
                   metavar="FRAC",
                   help="RANSAC inlier fraction required to accept a "
                        "closure candidate")
    p.add_argument("--solver", default="auto")
    p.add_argument("--nn", default="auto")
    p.add_argument("--output-prefix", default="registered_")
    p.add_argument("--poses", default="poses.npz")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if len(args.clouds) < 2:
        print("need at least 2 scans", file=sys.stderr)
        return -1

    from icp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from icp_tpu.config import ICPConfig
    from icp_tpu.io.csv import load_matrices, write_matrix
    from icp_tpu.ops.transform import apply_similarity
    from icp_tpu.slam.pairwise import chain_to_world_poses, register_chain

    clouds = load_matrices(args.clouds)  # threaded native multi-file parse
    reg_clouds = [c[:: args.subsample] for c in clouds]
    if args.voxel > 0.0:
        from icp_tpu.ops.voxel import voxel_downsample_np

        reg_clouds = [voxel_downsample_np(c, args.voxel)[0]
                      for c in reg_clouds]
        for f, c in zip(args.clouds, reg_clouds):
            print(f"[slam] voxel {args.voxel:g}: {f} -> {len(c)} pts",
                  file=sys.stderr)

    cfg = ICPConfig(
        max_iter=args.max_iter,
        threshold=args.threshold,
        solver=args.solver,
        nn_method=args.nn,
        with_scale=args.scale,
        validate_inputs=False,
        trim_fraction=args.trim,
    )
    if args.bucket < 0:  # auto (default): on for unequal-count chains
        from icp_tpu.ops.padding import resolve_auto_bucket

        bucket_quantum = resolve_auto_bucket(reg_clouds)
    else:
        bucket_quantum = args.bucket or None
    if bucket_quantum:
        print(f"[slam] bucketing on: quantum={bucket_quantum}",
              file=sys.stderr)
    pairs = register_chain(
        reg_clouds, cfg, multiscale=tuple(args.multiscale), init=args.init,
        engine=args.engine, bucket_quantum=bucket_quantum,
    )
    for k, pr in enumerate(pairs):
        print(
            f"[slam] pair {k}->{k+1}: iters={pr.iters} err={pr.err:g}",
            file=sys.stderr,
        )
    poses = chain_to_world_poses(pairs)

    if args.detect_closures:
        from icp_tpu.slam.closure import (
            chain_edges_from_pairs,
            detect_loop_closures,
            refine_closures,
        )
        from icp_tpu.slam.pose_graph import optimize_pose_graph

        if args.scale:
            print("[slam] note: pose-graph optimization is SE(3); closure "
                  "edges and the optimized poses are rigid", file=sys.stderr)
        cands = detect_loop_closures(
            reg_clouds, inlier_min=args.closure_min_inliers,
        )
        for c in cands:
            print(f"[slam] closure candidate {c.i}<-{c.j}: "
                  f"inliers={c.inlier_fraction:.2f}", file=sys.stderr)
        closure_edges, closure_results = refine_closures(
            reg_clouds, cands, cfg, engine=args.engine,
            multiscale=tuple(args.multiscale),
            bucket_quantum=bucket_quantum,
        )
        if closure_edges:
            # every edge (chain AND closure) carries its feature-verified
            # inlier fraction as the trust weight; trimmed-ICP error alone
            # cannot distinguish a registered pair from a plausible
            # mis-alignment (see closure.verified_inlier_fraction)
            chain_edges, suspects = chain_edges_from_pairs(pairs, reg_clouds)
            for k in suspects:
                print(f"[slam] chain edge {k}->{k+1} is unverifiable "
                      f"(feature-inliers={chain_edges[k].weight:.3f}, "
                      f"err={pairs[k].err:g}); down-weighted in the pose "
                      f"graph", file=sys.stderr)
            # closures give the graph cycles, i.e. redundancy -> the robust
            # kernel can down-weight residually inconsistent edges
            poses, cost = optimize_pose_graph(
                poses, chain_edges + closure_edges, n_iters=15,
                robust_phi=1.0)
            print(f"[slam] pose graph: {len(closure_edges)} closure "
                  f"edge(s), cost={cost:g}", file=sys.stderr)
        else:
            print("[slam] no loop closures detected", file=sys.stderr)

    if args.refine:
        from icp_tpu.slam.pose_graph import bundle_adjust

        # Correspondences from consecutive pairs: p in frame k+1 matched to
        # its NN in frame k (using the chain solution as initialization).
        from icp_tpu.ops.distance import closest_point_indices

        corr = []
        for k, pr in enumerate(pairs):
            src = jnp.asarray(reg_clouds[k + 1], jnp.float32)
            moved = apply_similarity(src, pr.transform)
            tgt = jnp.asarray(reg_clouds[k], jnp.float32)
            idx = closest_point_indices(moved, tgt, method="bcast")
            corr.append((k, k + 1, np.asarray(tgt)[np.asarray(idx)], np.asarray(src)))
        poses, cost = bundle_adjust(poses, corr, n_iters=8)
        print(f"[slam] bundle adjust: cost={cost:g}", file=sys.stderr)

    for k, (cloud, pose) in enumerate(zip(clouds, poses)):
        out = np.asarray(apply_similarity(jnp.asarray(cloud, jnp.float32), pose))
        write_matrix(out, f"{args.output_prefix}{k}.txt")

    np.savez(
        args.poses,
        s=np.stack([np.asarray(p.s) for p in poses]),
        R=np.stack([np.asarray(p.R) for p in poses]),
        t=np.stack([np.asarray(p.t) for p in poses]),
    )
    print(f"[slam] poses saved to {args.poses}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
