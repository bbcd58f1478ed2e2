"""Automatic loop-closure detection for multi-scan registration.

The pose-graph back end (``slam/pose_graph.py``) needs loop-closure edges to
cancel chain drift, but until now the caller had to KNOW which non-adjacent
scans overlap (tests/test_bunny_chain.py hand-picks 4->0).  This module
finds them: score every candidate scan pair with the global-registration
pipeline (FPFH + spectral consistency + batched RANSAC,
``engine/global_reg.py``) and keep pairs whose inlier fraction clears a
threshold.  No reference counterpart (the reference registers one pair,
``src/main.cc:6-25``).

Shape of the classic "try pairs until something sticks" loop here:

  * every scan is subsampled to the SAME point count S, so ONE compiled
    feature program serves all scans and ONE detection program serves all
    pairs (distinct shapes would each pay a compile);
  * candidate pairs are scored in vmapped CHUNKS: descriptor matching,
    the (S, S) spectral affinity power iteration, and all RANSAC
    hypothesis solves/scores batch along the pair axis — small matmuls
    become big ones, which is what the device wants; chunking bounds the
    (chunk, S, S) affinity memory, and the tail chunk is padded (never
    recompiled) and its padding discarded;
  * the host never syncs mid-pipeline — one fetch of (frac, sim) per chunk.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icp_tpu.ops.alignment import Similarity


class ClosureCandidate(NamedTuple):
    """A detected loop closure: scan ``j`` registered into scan ``i``'s
    frame (same convention as ``register_pair(model=clouds[i],
    scene=clouds[j])`` and ``PoseEdge(i, j, ...)``)."""

    i: int
    j: int
    transform: Similarity
    inlier_fraction: float
    n_mutual: int


@functools.partial(jax.jit, static_argnames=("n_hypotheses", "with_scale"))
def _score_pairs(m_pts, s_pts, f_m, f_s, taus, keys, *,
                 n_hypotheses: int, with_scale: bool):
    """Batched pair scoring: (C, S, 3)x2 points, (C, S, 33)x2 features,
    (C,) taus, (C, 2) keys -> (Similarity batch, (C,) fracs, (C,) mutual)."""
    from icp_tpu.engine.global_reg import (
        compatibility_scores,
        match_features,
        ransac_alignment,
    )

    def one(m, s, fm, fs, tau, key):
        idx, valid = match_features(fm, fs, mutual=True)
        matched = m[idx]
        scores = compatibility_scores(s, matched, valid, sigma=tau)
        sim, frac = ransac_alignment(
            s, matched, valid, inlier_tau=tau, key=key,
            n_hypotheses=n_hypotheses, with_scale=with_scale,
            sample_weights=scores,
        )
        return sim, frac, jnp.sum(valid.astype(jnp.int32))

    return jax.vmap(one)(m_pts, s_pts, f_m, f_s, taus, keys)


def _subsample_fixed(cloud: np.ndarray, n_out: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Exactly ``n_out`` distinct rows (uniform without replacement), so all
    scans share one compiled program regardless of their true sizes."""
    n = cloud.shape[0]
    if n <= n_out:
        return np.ascontiguousarray(cloud)
    sel = rng.choice(n, n_out, replace=False)
    sel.sort()
    return np.ascontiguousarray(cloud[sel])


def detect_loop_closures(
    clouds: Sequence[np.ndarray],
    *,
    min_separation: int = 2,
    candidate_pairs: Optional[Sequence[Tuple[int, int]]] = None,
    max_points: int = 2048,
    k: int = 32,
    voxel: Optional[float] = None,
    inlier_min: float = 0.15,
    n_hypotheses: int = 512,
    with_scale: bool = False,
    chunk: int = 8,
    seed: int = 0,
) -> List[ClosureCandidate]:
    """Find overlapping non-adjacent scan pairs and their coarse poses.

    ``candidate_pairs`` defaults to every (i, j) with ``j - i >=
    min_separation`` (adjacent pairs are the chain's job).  A pair is a
    closure when its RANSAC inlier fraction >= ``inlier_min`` — on
    disjoint scans the spectral scores are diffuse and no hypothesis
    gathers inliers, so the fraction separates (bunny at max_points=2048:
    the true 45-degree closure 0-4 scores ~0.21, every wrong pair <= 0.08;
    see tests/test_closure.py).  ``max_points`` below ~2k thins the
    subsample enough to blur the margin (1024: 0.13 vs 0.07).  Results are
    coarse (RANSAC-level) — refine
    each with ``register_pair(clouds[i], clouds[j], init=cand.transform)``
    before trusting the edge (``refine_closures`` does exactly that).

    Returned sorted by inlier fraction, best first.
    """
    from icp_tpu.ops.knn import knn
    from icp_tpu.ops.fpfh import fpfh_features

    n_scans = len(clouds)
    if candidate_pairs is None:
        candidate_pairs = [
            (i, j)
            for i in range(n_scans)
            for j in range(i + min_separation, n_scans)
        ]
    candidate_pairs = list(candidate_pairs)
    if not candidate_pairs:
        return []

    rng = np.random.default_rng(seed)
    subs = []
    for c in clouds:
        c_np = np.asarray(c, np.float32)
        if voxel is not None:
            from icp_tpu.ops.voxel import voxel_downsample_np

            c_np, _ = voxel_downsample_np(c_np, voxel)
        subs.append(c_np)
    # one shared size S: all scans clamp to the smallest so every feature /
    # detection program compiles exactly once
    size = min(max_points, min(s.shape[0] for s in subs))
    subs = [_subsample_fixed(s, size, rng) for s in subs]

    feats = []
    taus = []
    for s_np in subs:
        pts = jnp.asarray(s_np)
        d2, _ = knn(pts, min(2, size))
        spacing = float(jnp.median(jnp.sqrt(jnp.maximum(d2[:, -1], 0.0))))
        taus.append(3.0 * max(spacing, 1e-12))
        feats.append(fpfh_features(pts, k=k))

    results: List[ClosureCandidate] = []
    keys = jax.random.split(jax.random.PRNGKey(seed), len(candidate_pairs))
    for c0 in range(0, len(candidate_pairs), chunk):
        batch = candidate_pairs[c0:c0 + chunk]
        pad = chunk - len(batch)
        padded = batch + [batch[-1]] * pad  # tail chunk: repeat, drop later
        m_pts = jnp.stack([jnp.asarray(subs[i]) for i, _ in padded])
        s_pts = jnp.stack([jnp.asarray(subs[j]) for _, j in padded])
        f_m = jnp.stack([feats[i] for i, _ in padded])
        f_s = jnp.stack([feats[j] for _, j in padded])
        tau_b = jnp.asarray([taus[i] for i, _ in padded], jnp.float32)
        key_b = jnp.stack([keys[min(c0 + n, len(candidate_pairs) - 1)]
                           for n in range(chunk)])
        sims, fracs, mutual = _score_pairs(
            m_pts, s_pts, f_m, f_s, tau_b, key_b,
            n_hypotheses=n_hypotheses, with_scale=with_scale,
        )
        fracs_np = np.asarray(fracs)
        mutual_np = np.asarray(mutual)
        for n, (i, j) in enumerate(batch):
            if float(fracs_np[n]) >= inlier_min:
                sim = jax.tree_util.tree_map(lambda x: x[n], sims)
                results.append(ClosureCandidate(
                    i=i, j=j, transform=sim,
                    inlier_fraction=float(fracs_np[n]),
                    n_mutual=int(mutual_np[n]),
                ))
    results.sort(key=lambda c: -c.inlier_fraction)
    return results


def overlap_fraction(
    model: np.ndarray,
    scene: np.ndarray,
    transform: Similarity,
    *,
    tau_factor: float = 3.0,
    max_points: int = 2048,
    seed: int = 0,
    nn_method: str = "auto",
) -> float:
    """Fraction of ``scene`` points within tau of a ``model`` point after
    ``transform`` (tau = ``tau_factor`` x the model's median NN spacing).

    A cheap geometric-proximity diagnostic — NOT a registration verifier.
    Trimmed ICP aligning two shape-compatible crops of the same object
    manufactures proximity: on the tests/test_closure.py fixture the
    disjoint chain pair measures 0.53 — HIGHER than a genuinely
    overlapping pair (0.40) — because the solver is free to slide one crop
    onto the other's surface.  Use ``verified_inlier_fraction`` to decide
    whether a pose is trustworthy; use this only as an overlap-extent
    estimate for poses already known to be correct.
    """
    from icp_tpu.ops.knn import knn
    from icp_tpu.ops.distance import closest_point_indices
    from icp_tpu.ops.transform import apply_similarity

    rng = np.random.default_rng(seed)
    m = _subsample_fixed(np.asarray(model, np.float32), max_points, rng)
    s = _subsample_fixed(np.asarray(scene, np.float32), max_points, rng)
    m_d = jnp.asarray(m)
    moved = apply_similarity(jnp.asarray(s), transform)
    d2_self, _ = knn(m_d, min(2, m.shape[0]))
    spacing = jnp.sqrt(jnp.maximum(d2_self[:, -1], 0.0))
    tau = tau_factor * jnp.median(spacing)
    idx = closest_point_indices(moved, m_d, method=nn_method)
    d2 = jnp.sum((moved - m_d[idx]) ** 2, axis=1)
    return float(jnp.mean((d2 <= tau * tau).astype(jnp.float32)))


def verified_inlier_fraction(
    model: np.ndarray,
    scene: np.ndarray,
    transform: Similarity,
    *,
    tau_factor: float = 3.0,
    max_points: int = 2048,
    k: int = 32,
    seed: int = 0,
) -> float:
    """Feature-verified confidence of a registration: the fraction of
    mutual FPFH matches consistent with ``transform`` (within tau =
    ``tau_factor`` x the model's median NN spacing).

    This is the detection scorer of ``detect_loop_closures`` applied to a
    GIVEN pose instead of a RANSAC-found one, and it is the only signal of
    the three we measured that an untrustworthy pose cannot fake
    (tests/test_closure.py fixture, disjoint chain pair aligned by trimmed
    ICP): the trimmed error converges within 1.4x of genuine pairs, the
    geometric ``overlap_fraction`` measures HIGHER than a genuine pair
    (0.53 vs 0.40) — but feature correspondences point at semantically
    matching surface patches, which no rigid pose aligns for
    non-overlapping scans (0.026 here, vs 1.0 for the planted closure).
    Conversely a *correct* pose on weak-feature geometry can also score
    low, so treat the value as relative trust (a pose-graph edge weight),
    not an absolute accept/reject gate.
    """
    from icp_tpu.engine.global_reg import match_features
    from icp_tpu.ops.knn import knn
    from icp_tpu.ops.fpfh import fpfh_features
    from icp_tpu.ops.transform import apply_similarity

    rng = np.random.default_rng(seed)
    size = min(max_points, np.asarray(model).shape[0],
               np.asarray(scene).shape[0])
    m = jnp.asarray(_subsample_fixed(np.asarray(model, np.float32), size, rng))
    s = jnp.asarray(_subsample_fixed(np.asarray(scene, np.float32), size, rng))
    d2_self, _ = knn(m, min(2, size))
    spacing = jnp.sqrt(jnp.maximum(d2_self[:, -1], 0.0))
    tau = tau_factor * jnp.median(spacing)
    f_m = fpfh_features(m, k=min(k, size - 1))
    f_s = fpfh_features(s, k=min(k, size - 1))
    idx, valid = match_features(f_m, f_s, mutual=True)
    moved = apply_similarity(s, transform)
    d2 = jnp.sum((moved - m[idx]) ** 2, axis=1)
    n_ok = float(jnp.sum((valid & (d2 <= tau * tau)).astype(jnp.float32)))
    return n_ok / max(1.0, float(jnp.sum(valid.astype(jnp.float32))))


def chain_edges_from_pairs(
    pairs,
    clouds: Optional[Sequence[np.ndarray]] = None,
    *,
    min_confidence: float = 0.1,
    outlier_ratio: float = 25.0,
    min_weight: float = 1e-3,
) -> Tuple[list, List[int]]:
    """Pose-graph edges for the odometry chain, weighted by quality.

    A chain pair that never actually overlapped still "converges" — to a
    garbage pose — and graph consistency alone cannot identify that edge
    when the chain + one closure form a single cycle (any of the cycle's
    edges could be the bad one; rejecting any one yields a zero-residual
    tree, so even a robust kernel is indifferent).  Identifiability must
    come from per-edge evidence:

      * with ``clouds``, each edge is weighted by its
        ``verified_inlier_fraction`` (clamped to ``min_weight`` — never
        zero, the graph must stay connected when no closure covers a
        scan), so feature-verified edges overrule unverifiable ones where
        closures give redundancy;
      * always: ``pairs[k].err`` > ``outlier_ratio`` x the chain's lower
        quartile drops the edge to ``min_weight`` — catches pairs that
        overlapped but diverged.

    Returns ``(edges, suspect_ks)``; ``suspect_ks`` are the edges below
    ``min_confidence`` (edge k connects scans k and k+1) so callers can
    warn.
    """
    from icp_tpu.slam.pose_graph import PoseEdge

    errs = np.array([float(p.err) for p in pairs], np.float64)
    baseline = max(float(np.quantile(errs, 0.25)), 1e-12)
    edges, suspects = [], []
    for k, pr in enumerate(pairs):
        if errs[k] > outlier_ratio * baseline:
            w = min_weight
        elif clouds is not None:
            w = max(min_weight,
                    verified_inlier_fraction(clouds[k], clouds[k + 1],
                                             pr.transform))
        else:
            w = 1.0
        if w < min_confidence:
            suspects.append(k)
        edges.append(PoseEdge(
            k, k + 1,
            jnp.asarray(np.asarray(pr.transform.R)),
            jnp.asarray(np.asarray(pr.transform.t)),
            weight=w,
        ))
    return edges, suspects


def refine_closures(
    clouds: Sequence[np.ndarray],
    candidates: Sequence[ClosureCandidate],
    config=None,
    *,
    engine: str = "point_to_point",
    multiscale: Sequence[int] = (1,),
    max_err: Optional[float] = None,
    weighted: bool = True,
    bucket_quantum: Optional[int] = None,
    pad_sizes=None,
):
    """ICP-refine detected closures; returns ``(edges, results)``.

    ``edges`` are ``PoseEdge``s ready for ``optimize_pose_graph`` (scan j
    in scan i's frame); ``results`` the corresponding ``PairwiseResult``s.
    Candidates whose refined error exceeds ``max_err`` (if given) are
    dropped — a RANSAC false positive diverges rather than converges under
    trimmed ICP, so the error bound is the second, independent gate.
    With ``weighted`` (default) each surviving edge carries its
    ``verified_inlier_fraction`` at the REFINED pose as the edge weight —
    the same trust scale ``chain_edges_from_pairs`` assigns chain edges,
    so the pose graph arbitrates chain vs closure on uniform evidence.
    """
    from icp_tpu.slam.pairwise import register_pair
    from icp_tpu.slam.pose_graph import PoseEdge

    edges, results = [], []
    for cand in candidates:
        pr = register_pair(clouds[cand.i], clouds[cand.j], config,
                           multiscale=multiscale, init=cand.transform,
                           engine=engine, bucket_quantum=bucket_quantum,
                           pad_sizes=pad_sizes)
        if max_err is not None and float(pr.err) > max_err:
            continue
        w = 1.0
        if weighted:
            w = max(1e-3, verified_inlier_fraction(
                clouds[cand.i], clouds[cand.j], pr.transform))
        edges.append(PoseEdge(cand.i, cand.j,
                              jnp.asarray(np.asarray(pr.transform.R)),
                              jnp.asarray(np.asarray(pr.transform.t)),
                              weight=w))
        results.append(pr)
    return edges, results
