"""FPFH point features (one-hot histograms, static shapes).

Fast Point Feature Histograms (Rusu et al., ICRA 2009): a 33-dimensional
rotation-invariant descriptor per point, the standard feature for *global*
registration (no initial guess).  The reference has no counterpart — its ICP
is purely local and its datasets are near-aligned; this module (with
``engine/global_reg.py``) removes that limitation, which is what makes the
bunny-style partial-overlap chains robust to arbitrary initial poses.

Formulation (vs the classic pointer-chasing one):
  * neighbor sets come from the exact kNN (``ops/knn.py``) — (N, k) static;
  * the three Darboux-frame angles (alpha, phi, theta) for all N x k pairs
    are computed in one vectorized pass;
  * histogramming is ``one_hot(bins) summed over k`` — an (N*k, 11)-shaped
    matmul-like reduction XLA fuses, not a scatter;
  * the FPFH neighbor mix-in (sum_j SPFH(q_j)/omega_j) is a gather + masked
    weighted sum — again static (N, k).

Angles are invariant under rigid motion provided the normal orientation rule
commutes with rotation; ``fpfh_features`` therefore orients each normal away
from its LOCAL neighborhood mean (sign(n . (p - mean(kNN(p))))).  Local
orientation is both rotation-equivariant AND crop-stable: an interior
point's neighborhood is the same in two partially overlapping views, so its
sign decision matches across views.  Global-centroid orientation
(``orient_outward``) is rotation-equivariant but NOT crop-stable — the
centroid moves with the crop, flipping signs inconsistently between views,
which was measured to cut the good-match rate 3.5x on partial-overlap
bunny crops (9% -> 32%, see tests/test_global_reg.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

N_BINS = 11  # per angle; 3 angles -> 33-D descriptor (PCL's FPFH33 layout)


def _safe_normalize(v, eps=1e-12):
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(n2, eps))


def orient_outward(points: jax.Array, normals: jax.Array) -> jax.Array:
    """Flip each normal to point away from the cloud centroid.

    Rotation-equivariant: orient_outward(R p + t, R n) = R orient_outward(p, n),
    which is what keeps the FPFH angles rigid-motion invariant.  (A fixed
    world viewpoint, as in ``ops/normals.py::orient_normals``, is NOT — use
    that one for rendering/sensor semantics, this one for features.)
    """
    mu = jnp.mean(points, axis=0, keepdims=True)
    sign = jnp.sign(jnp.sum((points - mu) * normals, axis=1, keepdims=True))
    return normals * jnp.where(sign == 0, 1.0, sign)


def orient_local(points: jax.Array, normals: jax.Array,
                 idx: jax.Array) -> jax.Array:
    """Flip each normal away from its local neighborhood mean.

    ``idx`` is (N, K) neighbor indices (self allowed).  Rotation-equivariant
    like ``orient_outward``, but the sign decision depends only on the K
    nearest neighbors — so it is stable under cropping/partial overlap,
    which is what feature matching across views needs.  Larger K gives a
    larger mean offset and a stabler sign (K=64 measured best on bunny
    crops; K=16 loses ~half the matches to flips in near-flat regions).
    """
    nb_mu = jnp.mean(points[idx], axis=1)  # (N, 3)
    sign = jnp.sign(jnp.sum((points - nb_mu) * normals, axis=1, keepdims=True))
    return normals * jnp.where(sign == 0, 1.0, sign)


def _pair_angles(p, n, q, nq, eps=1e-12):
    """Darboux-frame angle features for point pairs.

    p, n: (..., 3) query point + unit normal; q, nq: (..., 3) neighbor
    point + unit normal.  Returns (alpha, phi, theta) each (...,), plus the
    pair distance.  Conventions follow Rusu's SPFH: u = n, v = unit(d) x u,
    w = u x v, alpha = v . nq, phi = u . unit(d), theta = atan2(w . nq, u . nq).
    """
    d = q - p
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), eps))
    du = d / dist[..., None]
    v = _safe_normalize(jnp.cross(du, n), eps)
    w = jnp.cross(n, v)
    alpha = jnp.sum(v * nq, axis=-1)
    phi = jnp.sum(n * du, axis=-1)
    theta = jnp.arctan2(jnp.sum(w * nq, axis=-1), jnp.sum(n * nq, axis=-1))
    return alpha, phi, theta, dist


def _bin11(x, lo, hi):
    """Static 11-bin index of x in [lo, hi] (clamped)."""
    t = (x - lo) / (hi - lo)
    return jnp.clip((t * N_BINS).astype(jnp.int32), 0, N_BINS - 1)


def _spfh(points, normals, idx):
    """Simplified Point Feature Histograms.

    points/normals (N, 3), idx (N, k) neighbor indices (self allowed —
    masked out).  Returns (spfh (N, 33), w_pair (N, k) validity weights,
    dist (N, k))."""
    dt = points.dtype
    p = points[:, None, :]  # (N, 1, 3)
    n = normals[:, None, :]
    q = points[idx]  # (N, k, 3)
    nq = normals[idx]
    alpha, phi, theta, dist = _pair_angles(p, n, q, nq)

    n_pts = points.shape[0]
    self_pair = idx == jnp.arange(n_pts, dtype=idx.dtype)[:, None]
    w_pair = jnp.where(self_pair, 0.0, 1.0).astype(dt)  # (N, k)

    bins = jnp.stack(
        [
            _bin11(alpha, -1.0, 1.0),
            _bin11(phi, -1.0, 1.0),
            _bin11(theta, -jnp.pi, jnp.pi),
        ],
        axis=0,
    )  # (3, N, k)
    # one-hot + masked sum over neighbors: (3, N, k, 11) -> (3, N, 11);
    # XLA lowers this to fused selects/adds — no scatter.
    oh = jax.nn.one_hot(bins, N_BINS, dtype=dt) * w_pair[None, :, :, None]
    hist = jnp.sum(oh, axis=2)  # (3, N, 11)
    spfh = jnp.concatenate([hist[0], hist[1], hist[2]], axis=1)  # (N, 33)
    # normalize per point by its valid-pair count (uniform across the three
    # angle blocks) so sparse-neighborhood points aren't under-weighted
    cnt = jnp.maximum(jnp.sum(w_pair, axis=1, keepdims=True), 1.0)
    return spfh / cnt, w_pair, dist


@functools.partial(jax.jit, static_argnames=())
def fpfh_from_neighbors(points: jax.Array, normals: jax.Array,
                        idx: jax.Array,
                        orient_idx: jax.Array | None = None) -> jax.Array:
    """FPFH descriptors from precomputed (N, k) neighbor indices.

    FPFH(p) = SPFH(p) + (1/|Nb|) sum_j SPFH(q_j) / omega_j with omega_j the
    pair distance (Rusu '09 eq. 4), each 11-bin block then L1-normalized to
    100 (PCL convention) so descriptors compare across neighborhood sizes.

    Normals are sign-canonicalized with ``orient_local`` over ``orient_idx``
    (default: ``idx`` itself) — see the module docstring for why local,
    not global-centroid, orientation.
    """
    dt = points.dtype
    normals = orient_local(points, normals,
                           idx if orient_idx is None else orient_idx)
    spfh, w_pair, dist = _spfh(points, normals, idx)
    inv_w = w_pair / jnp.maximum(dist, 1e-6)  # (N, k); 0 on self pairs
    nb_spfh = spfh[idx]  # (N, k, 33)
    cnt = jnp.maximum(jnp.sum(w_pair, axis=1, keepdims=True), 1.0)
    mix = jnp.einsum("nk,nkf->nf", inv_w, nb_spfh,
                     precision=jax.lax.Precision.HIGHEST) / cnt
    f = spfh + mix
    # L1-normalize each angle block to 100
    blocks = f.reshape(f.shape[0], 3, N_BINS)
    s = jnp.maximum(jnp.sum(blocks, axis=2, keepdims=True), 1e-12)
    return (100.0 * blocks / s).reshape(f.shape[0], 3 * N_BINS).astype(dt)


def fpfh_features(points: jax.Array, *, k: int = 32,
                  orient_k: int = 64,
                  normals: jax.Array | None = None,
                  method: str = "auto") -> jax.Array:
    """(N, 3) cloud -> (N, 33) FPFH descriptors.

    ``k``: neighborhood size for the normals and the histograms (k=32
    measured ~2x the partial-overlap match quality of k=16 on bunny crops).
    ``orient_k``: (larger) neighborhood for the normal-sign decision —
    one kNN call fetches max(k+1, orient_k) neighbors and both uses slice
    it.  ``normals``: optional precomputed (N, 3) unit normals (any sign —
    they are re-oriented locally).  ``method`` selects the kNN path as in
    ``ops/normals.py::estimate_normals``.
    """
    points = jnp.asarray(points)
    n = points.shape[0]
    k_eff = min(k + 1, n)  # + self, masked out of the histograms
    k_fetch = min(max(k + 1, orient_k), n)
    from icp_tpu.ops.knn import knn

    _, idx_fetch = knn(points, k_fetch, method=method, scene_tile=64,
                       model_tile=256, max_candidates=32)
    idx = idx_fetch[:, :k_eff]
    if normals is None:
        from icp_tpu.ops.normals import normals_from_neighbor_indices

        normals = normals_from_neighbor_indices(points, idx)
    else:
        normals = jnp.asarray(normals, points.dtype)
    return fpfh_from_neighbors(points, normals, idx, orient_idx=idx_fetch)
