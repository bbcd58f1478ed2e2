"""Surface-normal estimation — closed-form, batched.

Prerequisite for point-to-plane ICP (``engine/point_to_plane.py``) and GICP.
No reference counterpart (the reference is point-to-point only).

Design: exact kNN per point (``ops/knn.py``, plain XLA — it runs once per
cloud, off the iteration loop), then the normal is the smallest
eigenvector of the local covariance — computed in closed form
(trigonometric eigenvalues + row-cross eigenvector), fully branchless: no
LAPACK-style ``eigh`` per point.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _smallest_eigvec_sym3(C: jax.Array) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue of a symmetric (..., 3, 3).

    Eigenvalues via the trigonometric closed form (Smith '61); eigenvector as
    the largest cross product of rows of (C - lambda_min I) (the null-space
    direction of a rank-2 symmetric matrix).
    """
    dt = C.dtype
    # scale-normalize for conditioning
    scale = jnp.maximum(
        jnp.max(jnp.abs(C), axis=(-1, -2), keepdims=True), jnp.asarray(1e-30, dt)
    )
    A = C / scale
    q = jnp.trace(A, axis1=-2, axis2=-1)[..., None, None] / 3.0
    B = A - q * jnp.eye(3, dtype=dt)
    p2 = jnp.sum(B * B, axis=(-1, -2))[..., None, None] / 6.0
    p = jnp.sqrt(jnp.maximum(p2, jnp.asarray(1e-30, dt)))
    detB = jnp.linalg.det(B / p)[..., None, None]
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # eigenvalues: q + 2p cos(phi + 2k pi / 3); smallest at k=1 shift
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    M = A - lam_min * jnp.eye(3, dtype=dt)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c12 = jnp.cross(r1, r2)
    c20 = jnp.cross(r2, r0)
    cands = jnp.stack([c01, c12, c20], axis=-2)  # (..., 3, 3)
    norms = jnp.sum(cands * cands, axis=-1)  # (..., 3)
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    return v * jax.lax.rsqrt(
        jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), jnp.asarray(1e-30, dt))
    )


def normals_from_neighbor_indices(points: jax.Array, idx: jax.Array) -> jax.Array:
    """(N, 3) cloud + (N, k) neighbor indices -> (N, 3) unit normals via
    local-covariance PCA (closed-form smallest eigenvector)."""
    nbrs = points[idx]  # (N, k, 3)
    mu = jnp.mean(nbrs, axis=1, keepdims=True)
    cent = nbrs - mu
    C = jnp.einsum(
        "cki,ckj->cij", cent, cent,
        precision=jax.lax.Precision.HIGHEST,
    )
    return _smallest_eigvec_sym3(C)


@functools.partial(jax.jit, static_argnames=(
    "k", "chunk", "method", "grid_scene_tile", "grid_model_tile",
    "grid_max_candidates"))
def estimate_normals(points: jax.Array, *, k: int = 16,
                     chunk: int | None = None,
                     method: str = "auto",
                     grid_scene_tile: int = 64,
                     grid_model_tile: int = 256,
                     grid_max_candidates: int = 32) -> jax.Array:
    """(N, 3) cloud -> (N, 3) unit normals from k-nearest-neighbor PCA.

    Neighbors come from the exact f32 kNN (``ops/knn.py``; the neighbor SET
    is all PCA needs, so the f32 search serves every dtype).  Orientation is
    arbitrary (point-to-plane residuals are squared; flip with
    ``orient_normals`` if a consistent orientation is needed).

    ``method``: ``"dense"`` (blocked O(N^2)), ``"grid"`` (kd-tile pruned —
    same exact result, the at-scale path), or ``"auto"``
    (``config.resolve_knn_method``).  Smaller kd tiles than the
    correspondence path: kNN culls with a per-tile MAX k-th-distance bound,
    which only stays tight over few queries.  ``chunk`` is accepted for
    back-compatibility and ignored.
    """
    from icp_tpu.ops.knn import knn

    del chunk
    n = points.shape[0]
    k_eff = min(k + 1, n)  # +1: the point itself is its own nearest neighbor
    _, idx = knn(points, k_eff, method=method, scene_tile=grid_scene_tile,
                 model_tile=grid_model_tile,
                 max_candidates=grid_max_candidates)
    return normals_from_neighbor_indices(points, idx)


def orient_normals(points: jax.Array, normals: jax.Array,
                   viewpoint=(0.0, 0.0, 0.0)) -> jax.Array:
    """Flip normals to face the given viewpoint (sensor origin)."""
    vp = jnp.asarray(viewpoint, points.dtype)
    toward = vp[None, :] - points
    sign = jnp.sign(jnp.sum(toward * normals, axis=1, keepdims=True))
    return normals * jnp.where(sign == 0, 1.0, sign)
