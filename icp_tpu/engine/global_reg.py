"""Global registration: FPFH correspondences + batched RANSAC.

The reference's ICP (and every engine in this package) is *local* — it needs
an initial pose within the convergence basin (`src/cpu.cc:55-79` iterates
from identity; its datasets are pre-aligned transforms).  This module
produces that initial pose from nothing: match FPFH descriptors
(``ops/fpfh.py``) between the clouds, then robustly fit a similarity with
RANSAC, and hand the result to any ICP engine as a warm start
(``icp(..., init=...)`` / ``register_pair(init="fpfh")``).

Shape of the classic pipeline here:
  * descriptor matching is argmin over a (Ns, Nm) distance matrix in 33-D —
    one matrix product via the ||a-b||^2 expansion (HIGHEST precision);
  * RANSAC evaluates ALL hypotheses at once: sample (K, 3) correspondence
    triplets, solve K Horn problems in one vmapped branch-free QCP solve
    (``ops/alignment.py::max_eigvec_qcp`` — no eigh, no data-dependent
    branching), score all K x S inlier counts as one batched pass.  No
    sequential hypothesis loop, no early exit — the classic
    CPU-RANSAC control flow is replaced by width, which is what the
    hardware wants;
  * everything is static-shaped and jitted end-to-end; the only host sync
    is the final fetch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from icp_tpu.ops.alignment import (
    Similarity,
    alignment_from_stats,
    compute_alignment_stats,
)


class GlobalRegResult(NamedTuple):
    transform: Similarity  # maps scene into the model frame
    inlier_fraction: jax.Array  # () best hypothesis' inlier share
    n_mutual: jax.Array  # () mutual feature matches used


def match_features(f_model: jax.Array, f_scene: jax.Array,
                   *, mutual: bool = True):
    """Nearest neighbors in descriptor space.

    Returns ``(idx, valid)``: for each scene row, the best model row (Ns,)
    int32 and a (Ns,) bool mask (mutual cross-check passed).  The matmul
    expansion makes the 33-D distance work one matrix product; HIGHEST
    precision — descriptor gaps are small and TF32 flips argmins.
    """
    fm = f_model.astype(jnp.float32)
    fs = f_scene.astype(jnp.float32)
    cross = jnp.matmul(fs, fm.T, precision=jax.lax.Precision.HIGHEST)
    m2 = jnp.sum(fm * fm, axis=1)
    fwd = jnp.argmin(m2[None, :] - 2.0 * cross, axis=1).astype(jnp.int32)
    if not mutual:
        return fwd, jnp.ones(fwd.shape, bool)
    s2 = jnp.sum(fs * fs, axis=1)
    back = jnp.argmin(s2[None, :] - 2.0 * cross.T, axis=1).astype(jnp.int32)
    valid = back[fwd] == jnp.arange(fs.shape[0], dtype=jnp.int32)
    return fwd, valid


@functools.partial(jax.jit, static_argnames=("n_power_iters",))
def compatibility_scores(scene_pts: jax.Array, model_pts: jax.Array,
                         valid: jax.Array, *, sigma,
                         n_power_iters: int = 30) -> jax.Array:
    """Spectral geometric-consistency score per putative correspondence.

    Leordeanu & Hebert's spectral matching (ICCV '05): rigid motion
    preserves pairwise distances, so for two TRUE correspondences i, j the
    scene gap ||s_i - s_j|| equals the model gap ||m_i - m_j||.  Build the
    (S, S) affinity C[i,j] = exp(-(ds - dm)^2 / (2 sigma^2)); true matches
    form a mutually consistent block, so the leading eigenvector (computed
    by ``n_power_iters`` branch-free power iterations — all matrix
    products) concentrates its mass on them.  On partial-overlap bunny crops
    this lifts the top-100 good-match rate from 0.32 (raw mutual matches)
    to 1.00 (tests/test_global_reg.py), which is what makes 3-point RANSAC
    sample-efficient.  Returns (S,) non-negative scores, max-normalized.
    """
    dt = jnp.float32
    s = scene_pts.astype(dt)
    m = model_pts.astype(dt)
    w = valid.astype(dt)

    def pdist(p):
        g = jnp.matmul(p, p.T, precision=jax.lax.Precision.HIGHEST)
        n2 = jnp.diagonal(g)
        return jnp.sqrt(jnp.maximum(n2[:, None] + n2[None, :] - 2.0 * g, 0.0))

    ds = pdist(s)
    dm = pdist(m)
    sig = jnp.maximum(jnp.asarray(sigma, dt), 1e-12)
    C = jnp.exp(-jnp.square((ds - dm) / sig) * 0.5) * (w[:, None] * w[None, :])
    C = C * (1.0 - jnp.eye(C.shape[0], dtype=dt))

    def body(_, x):
        x = jnp.matmul(C, x, precision=jax.lax.Precision.HIGHEST)
        return x / jnp.maximum(jnp.linalg.norm(x), 1e-30)

    x0 = w / jnp.maximum(jnp.sum(w), 1.0)
    x = jax.lax.fori_loop(0, n_power_iters, body, x0)
    return x / jnp.maximum(jnp.max(x), 1e-30)


def _solve3(p3, y3, with_scale):
    """Horn similarity from 3 correspondences — branch-free (vmapped)."""
    stats = compute_alignment_stats(p3, y3)
    return alignment_from_stats(stats, solver="qcp", with_scale=with_scale)


@functools.partial(
    jax.jit,
    static_argnames=("n_hypotheses", "with_scale", "refine_iters"),
)
def ransac_alignment(
    scene_pts: jax.Array,  # (S, 3) scene points with a match
    model_pts: jax.Array,  # (S, 3) their matched model points
    valid: jax.Array,  # (S,) bool — usable correspondences
    *,
    inlier_tau,  # distance threshold (same units as the clouds)
    key: jax.Array,  # jax.random key
    n_hypotheses: int = 512,
    with_scale: bool = False,
    edge_similarity: float = 0.9,
    refine_iters: int = 4,
    sample_weights: jax.Array | None = None,  # (S,) sampling bias
):
    """Batched-hypothesis RANSAC over putative correspondences.

    Returns ``(Similarity, inlier_fraction)``.  All ``n_hypotheses``
    3-point Horn solves and all hypothesis scores run as ONE program:
    sampling uses weighted categorical draws (``sample_weights`` — e.g. the
    spectral ``compatibility_scores`` — biases triplets toward consistent
    matches; invalid and degenerate triplets simply score zero —
    branch-free), scoring is a (K, S) batched residual check, refinement
    re-fits on the best hypothesis' inliers with ``refine_iters``
    reweighted Horn passes whose inlier radius anneals 3*tau -> tau
    (a 3-point solve from noisy matches is coarse; the wide first radius
    lets the refit capture the true inlier set before tightening).
    """
    dt = scene_pts.dtype
    w = valid.astype(jnp.float32)
    sw = w if sample_weights is None else sample_weights.astype(jnp.float32) * w
    logits = jnp.log(jnp.maximum(sw, 1e-30))
    tri = jax.random.categorical(
        key, logits[None, :], shape=(n_hypotheses, 3)
    )  # (K, 3) indices into the correspondence list (with replacement)

    p3 = scene_pts[tri]  # (K, 3, 3)
    y3 = model_pts[tri]

    # Edge-length compatibility (Open3D-style checker): the triangle spanned
    # in the scene must match the matched triangle in the model.  Kills
    # wrong-match and duplicate-index triplets before they cost a solve
    # ... they solve anyway (vmapped), but their score is zeroed.
    # Two deliberate loosenings vs the textbook ratio test:
    #   * an ABSOLUTE slack of 2*inlier_tau per edge — correspondence noise
    #     (subsample spacing) is additive, and real-scan triangles are often
    #     small enough that a pure ratio test rejects every honest triplet
    #     (measured: 3/512 survivors, none of them all-inlier);
    #   * under ``with_scale`` edges are compared after removing the
    #     per-triplet least-squares scale (model edges are s x scene edges
    #     for true matches — the raw ratio test rejects ALL of them).
    def edges(x):  # (K, 3, 3) -> (K, 3) pairwise edge lengths
        d01 = jnp.linalg.norm(x[:, 0] - x[:, 1], axis=1)
        d12 = jnp.linalg.norm(x[:, 1] - x[:, 2], axis=1)
        d20 = jnp.linalg.norm(x[:, 2] - x[:, 0], axis=1)
        return jnp.stack([d01, d12, d20], axis=1)

    ep, ey = edges(p3), edges(y3)
    nondegenerate = jnp.all(ep > 1e-9, axis=1) & jnp.all(ey > 1e-9, axis=1)
    if with_scale:
        s_hat = jnp.sum(ey, axis=1) / jnp.maximum(jnp.sum(ep, axis=1), 1e-30)
    else:
        s_hat = jnp.ones(ep.shape[0], ep.dtype)
    ep_s = s_hat[:, None] * ep
    slack = (1.0 - edge_similarity) * jnp.maximum(ep_s, ey) \
        + 2.0 * jnp.asarray(inlier_tau, ep.dtype)
    compatible = jnp.all(jnp.abs(ey - ep_s) <= slack, axis=1)
    ok = (nondegenerate & compatible).astype(dt)  # (K,)

    sims = jax.vmap(_solve3, in_axes=(0, 0, None))(p3, y3, with_scale)

    # Score every hypothesis against every valid correspondence:
    # moved[k, i] = s_k R_k p_i + t_k  — one batched einsum.
    moved = (
        sims.s[:, None, None]
        * jnp.einsum("kab,sb->ksa", sims.R, scene_pts,
                     precision=jax.lax.Precision.HIGHEST)
        + sims.t[:, None, :]
    )  # (K, S, 3)
    r2 = jnp.sum((moved - model_pts[None, :, :]) ** 2, axis=2)  # (K, S)
    tau = jnp.asarray(inlier_tau, dt)
    # hypothesis selection uses the ANNEALED radius (3-point solves from
    # noisy matches place the pose coarsely; 2*tau separates right-basin
    # from wrong-basin hypotheses far more reliably than tau)
    inl = (r2 < (2.0 * tau) ** 2).astype(dt) * w[None, :]  # (K, S)
    score = jnp.sum(inl, axis=1) * ok  # (K,)
    best = jnp.argmax(score)

    # Refinement: reweighted Horn on the best hypothesis' inliers, radius
    # annealing 3*tau -> tau.  Static unrolled few-step loop (tiny solves).
    sim = jax.tree_util.tree_map(lambda x: x[best], sims)
    denom = max(refine_iters - 1, 1)
    for i in range(refine_iters):
        tau_i = tau * 3.0 ** (1.0 - i / denom)
        moved1 = (
            sim.s * jnp.matmul(scene_pts, sim.R.T,
                               precision=jax.lax.Precision.HIGHEST)
            + sim.t
        )
        r2_1 = jnp.sum((moved1 - model_pts) ** 2, axis=1)
        w_in = (r2_1 < tau_i * tau_i).astype(dt) * w
        # guard: if everything fell outside tau (pathological), keep weights
        w_in = jnp.where(jnp.sum(w_in) < 3.0, w, w_in)
        stats = compute_alignment_stats(scene_pts, model_pts, weights=w_in)
        sim = alignment_from_stats(stats, solver="qcp",
                                   with_scale=with_scale)
    # report the final refined pose's inlier share at the true tau
    moved_f = (
        sim.s * jnp.matmul(scene_pts, sim.R.T,
                           precision=jax.lax.Precision.HIGHEST)
        + sim.t
    )
    r2_f = jnp.sum((moved_f - model_pts) ** 2, axis=1)
    n_in = jnp.sum((r2_f < tau * tau).astype(dt) * w)
    n_valid = jnp.maximum(jnp.sum(w), 1.0)
    return sim, (n_in / n_valid).astype(dt)


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_hypotheses", "with_scale", "estimate_tau"),
)
def _global_register_device(
    m, s, key, inlier_tau, *, k, n_hypotheses, with_scale, estimate_tau
):
    """The whole device pipeline as ONE compiled program: tau estimation,
    both FPFH passes, matching, spectral scoring and RANSAC in one jit — a
    single dispatch and one result fetch, with no host sync in between.
    """
    from icp_tpu.ops.knn import knn
    from icp_tpu.ops.fpfh import fpfh_features

    if estimate_tau:
        # 3x the model cloud's median NN spacing, computed ON DEVICE —
        # no host round-trip between the kNN and the rest of the pipeline
        d2, _ = knn(m, min(2, m.shape[0]))
        spacing = jnp.median(jnp.sqrt(jnp.maximum(d2[:, -1], 0.0)))
        inlier_tau = 3.0 * jnp.maximum(spacing, 1e-12)

    f_m = fpfh_features(m, k=k)
    f_s = fpfh_features(s, k=k)
    idx, valid = match_features(f_m, f_s, mutual=True)

    # Spectral consistency scores bias the RANSAC triplet sampling toward
    # the mutually consistent match set (scores are ~0 on wrong matches,
    # O(1) on the consistent block — measured top-50 purity 0.96 on bunny
    # crops where raw matches are 21% good).  Scores stay a BIAS, not a
    # filter: validity for inlier counting remains the full mutual set, so
    # a degenerate spectrum cannot starve RANSAC.
    matched = m[idx]
    scores = compatibility_scores(s, matched, valid, sigma=inlier_tau)
    sim, frac = ransac_alignment(
        s,
        matched,
        valid,
        inlier_tau=inlier_tau,
        key=key,
        n_hypotheses=n_hypotheses,
        with_scale=with_scale,
        sample_weights=scores,
    )
    return sim, frac, jnp.sum(valid.astype(jnp.int32))


def global_register(
    model,
    scene,
    *,
    voxel: float | None = None,
    k: int = 16,
    n_hypotheses: int = 512,
    inlier_tau: float | None = None,
    with_scale: bool = False,
    seed: int = 0,
    max_points: int = 4096,
) -> GlobalRegResult:
    """Estimate the scene->model similarity with no initial guess.

    Pipeline: (optional) voxel downsample -> uniform subsample to
    ``max_points`` (host) -> ONE jitted device program (normals + FPFH ->
    mutual descriptor matching -> spectral consistency filter
    (``compatibility_scores``) -> batched RANSAC).  The result warm-starts
    any ICP engine (``icp(model, scene, init=result.transform)``); accuracy
    is coarse-level by design — ICP does the precision.

    ``inlier_tau`` defaults to 3x the model cloud's median NN spacing
    (estimated on the subsampled cloud, on device).
    """
    import numpy as np

    from icp_tpu.ops.voxel import voxel_downsample_np

    m_np = np.asarray(model, np.float32)
    s_np = np.asarray(scene, np.float32)
    if voxel is not None:
        m_np, _ = voxel_downsample_np(m_np, voxel)
        s_np, _ = voxel_downsample_np(s_np, voxel)

    def sub(x):
        step = max(1, int(np.ceil(x.shape[0] / max_points)))
        return np.ascontiguousarray(x[::step])

    m_np, s_np = sub(m_np), sub(s_np)
    sim, frac, n_mutual = _global_register_device(
        jnp.asarray(m_np),
        jnp.asarray(s_np),
        jax.random.PRNGKey(seed),
        jnp.asarray(0.0 if inlier_tau is None else inlier_tau, jnp.float32),
        k=k,
        n_hypotheses=n_hypotheses,
        with_scale=with_scale,
        estimate_tau=inlier_tau is None,
    )
    return GlobalRegResult(
        transform=sim, inlier_fraction=frac, n_mutual=n_mutual
    )
