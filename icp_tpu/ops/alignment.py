"""Similarity alignment solve (Horn quaternion method, with scale).

Matches the behavior of reference ``CPU::ICP::find_alignment``
(``src/cpu.cc:105-175``) / ``GPU::ICP::find_alignment``
(``src/GPU/gpu.cc:95-151``): given scene points ``p`` and their matched model
points ``y``, find the similarity transform ``y ~= s * R @ p + t`` that
minimizes the residual, where

  * centroids / centered clouds            (``src/cpu.cc:113-117``)
  * 3x3 cross-covariance  S = sum p'_i y'_i^T   (``src/cpu.cc:119``)
  * Horn's symmetric 4x4 N-matrix          (``src/cpu.cc:121-126``)
  * max-eigenvalue eigenvector = unit quaternion -> R
  * symmetric scale s = sqrt(sum||y'||^2 / sum||p'||^2)  (``src/cpu.cc:154-165``)
  * t = mu_y - s R mu_p                    (``src/cpu.cc:166-167``)

Divergence from the reference (deliberate, documented): the reference's
``max_element_index`` (``src/cpu.cc:81-91``) has a bug (BUG-1 in SURVEY.md) —
it never updates ``max`` inside the loop, so eigenvector selection between
large eigenvalues is order-dependent.  We implement the correct argmax.
Acceptance criterion is convergence within the reference's error bound, not
bit-equality of the quaternion branch.

Design: everything is phrased over *sufficient statistics*
``(sum_p, sum_y, sum_py, sum_pp, sum_yy, n)`` so the sharded engine can psum
five small tensors over the device mesh and run the tiny 4x4 solve replicated
on every device (the reference ships centered clouds back to the host for its
4x4 Eigen solve each iteration, ``src/GPU/gpu.cc:113``).

Three eigen solvers:
  * ``eigh``   — ``jnp.linalg.eigh`` on the symmetric N (oracle-grade).
  * ``qcp``    — Newton iteration on the quartic characteristic polynomial
                 (the N-matrix is traceless: P(l) = l^4 + c2 l^2 + c1 l + c0)
                 plus an adjugate-based eigenvector, refined by a few shifted
                 power iterations.  Branch-free, no LAPACK-style loops: a
                 few fused scalar kernels inside the jitted while_loop.  (Theobald-style
                 QCP; see PAPERS.md Kabsch-Umeyama reference.)
  * ``kabsch`` — 3x3 SVD with reflection correction (Kabsch/Umeyama).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class AlignmentStats(NamedTuple):
    """Sufficient statistics of a (p, y) correspondence set.

    All of these are plain sums, so sharded engines obtain the global stats
    with a single fused ``psum`` over the points axis.
    """

    sum_p: jax.Array  # (3,)
    sum_y: jax.Array  # (3,)
    sum_py: jax.Array  # (3, 3) = sum_i p_i y_i^T
    sum_pp: jax.Array  # () = sum_i ||p_i||^2
    sum_yy: jax.Array  # () = sum_i ||y_i||^2
    n: jax.Array  # () point count (float)


def compute_alignment_stats(
    p: jax.Array, y: jax.Array, acc_dtype=None, weights: jax.Array | None = None
) -> AlignmentStats:
    """Accumulate the alignment statistics of (N,3) clouds in one pass.

    ``weights`` (N,): optional per-correspondence weights (0/1 masks for
    trimmed ICP, or soft robust weights); ``n`` becomes the weight sum.
    """
    if acc_dtype is None:
        acc_dtype = p.dtype
    pa = p.astype(acc_dtype)
    ya = y.astype(acc_dtype)
    # HIGHEST precision: a reduced-precision product (TF32 on the GPU)
    # pollutes the 3x3 cross-covariance enough to put a floor on the
    # convergence error; full f32 costs nothing at 3x3 output size.
    if weights is None:
        return AlignmentStats(
            sum_p=jnp.sum(pa, axis=0),
            sum_y=jnp.sum(ya, axis=0),
            sum_py=jnp.matmul(pa.T, ya, precision=jax.lax.Precision.HIGHEST),
            sum_pp=jnp.sum(pa * pa),
            sum_yy=jnp.sum(ya * ya),
            n=jnp.asarray(p.shape[0], acc_dtype),
        )
    w = weights.astype(acc_dtype)
    pw = pa * w[:, None]
    return AlignmentStats(
        sum_p=jnp.sum(pw, axis=0),
        sum_y=jnp.sum(ya * w[:, None], axis=0),
        sum_py=jnp.matmul(pw.T, ya, precision=jax.lax.Precision.HIGHEST),
        sum_pp=jnp.sum(w * jnp.sum(pa * pa, axis=1)),
        sum_yy=jnp.sum(w * jnp.sum(ya * ya, axis=1)),
        n=jnp.sum(w),
    )


def horn_n_matrix(S: jax.Array) -> jax.Array:
    """Horn's symmetric, traceless 4x4 N-matrix from the 3x3 cross-covariance.

    Same algebra as reference ``src/cpu.cc:121-126``.
    """
    tr = S[0, 0] + S[1, 1] + S[2, 2]
    A = S[1, 2] - S[2, 1]
    B = S[2, 0] - S[0, 2]
    C = S[0, 1] - S[1, 0]
    return jnp.array(
        [
            [tr, A, B, C],
            [A, S[0, 0] - S[1, 1] - S[2, 2], S[0, 1] + S[1, 0], S[0, 2] + S[2, 0]],
            [B, S[0, 1] + S[1, 0], S[1, 1] - S[0, 0] - S[2, 2], S[1, 2] + S[2, 1]],
            [C, S[0, 2] + S[2, 0], S[1, 2] + S[2, 1], S[2, 2] - S[0, 0] - S[1, 1]],
        ],
        dtype=S.dtype,
    )


def quat_to_rot(q: jax.Array) -> jax.Array:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation with y = R p.

    Equivalent to the reference's ``(q_bar^H q_caps)`` 3x3 block
    (``src/cpu.cc:138-152``); verified against that construction in
    ``tests/test_alignment.py``.
    """
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
        ],
        dtype=q.dtype,
    )


def _det3(m: jax.Array) -> jax.Array:
    return (
        m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
        - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
        + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0])
    )


def _minor3_det(A, rows, cols):
    """det of the 3x3 minor at static (rows, cols) — pure scalar indexing.

    Deliberately NOT ``A[jnp.array(rows)][:, jnp.array(cols)]``: fancy-index
    minors lower to gather ops that XLA does not fuse into the scalar chain,
    turning the 4x4 solve into dozens of kernel dispatches inside the ICP
    loop.  Scalar reads fuse.
    """
    (r0, r1, r2), (c0, c1, c2) = rows, cols
    return (
        A[r0, c0] * (A[r1, c1] * A[r2, c2] - A[r1, c2] * A[r2, c1])
        - A[r0, c1] * (A[r1, c0] * A[r2, c2] - A[r1, c2] * A[r2, c0])
        + A[r0, c2] * (A[r1, c0] * A[r2, c1] - A[r1, c1] * A[r2, c0])
    )


def _det4(A: jax.Array) -> jax.Array:
    rows = (1, 2, 3)
    out = jnp.zeros((), A.dtype)
    for j in range(4):
        cols = tuple(c for c in range(4) if c != j)
        out = out + ((-1.0) ** j) * A[0, j] * _minor3_det(A, rows, cols)
    return out


def _adjugate4(A: jax.Array) -> jax.Array:
    """Adjugate of a 4x4 (static unrolled scalar cofactors; branch-free)."""
    cof_rows = []
    for i in range(4):
        r = tuple(x for x in range(4) if x != i)
        cof_row = []
        for j in range(4):
            c = tuple(x for x in range(4) if x != j)
            cof_row.append(((-1.0) ** (i + j)) * _minor3_det(A, r, c))
        cof_rows.append(jnp.stack(cof_row))
    cof = jnp.stack(cof_rows)  # cofactor matrix
    return cof.T


def max_eigvec_eigh(N: jax.Array) -> jax.Array:
    """Largest-eigenvalue unit eigenvector via eigh (ascending order)."""
    _, vecs = jnp.linalg.eigh(N)
    return vecs[:, -1]


def max_eigvec_qcp(N: jax.Array, S: jax.Array, gp: jax.Array, gy: jax.Array,
                   newton_iters: int = 12, power_iters: int = 4) -> jax.Array:
    """Largest eigenvector of Horn's N via QCP-style Newton + adjugate.

    N is symmetric traceless, so its characteristic polynomial is
    ``P(l) = l^4 + c2 l^2 + c1 l + c0`` with
      c2 = -2 tr(S^T S),  c1 = -8 det(S),  c0 = det(N).
    The largest root satisfies ``l <= sqrt(gp * gy)`` (Cauchy-Schwarz), and
    Newton from that upper bound converges monotonically and quadratically.
    The eigenvector is recovered from the adjugate of ``N - l I`` (rank-3 for
    a simple root => adj = c v v^T), with a few shifted power iterations to
    clean up near-degenerate spectra.  Entirely branch-free: straight-line
    scalar code inside a jitted while_loop, unlike a general eigensolver.
    """
    dt = N.dtype
    # Scale-normalize: adjugate cofactors are cubic in |N|, so their squared
    # norms overflow f32 for large clouds (|S| ~ 1e7 at 1M points -> 1e42).
    # The eigenvector is invariant under uniform scaling.
    scale = 1.0 / jnp.maximum(gp + gy, jnp.asarray(1e-30, dt))
    N = N * scale
    S = S * scale
    gp = gp * scale
    gy = gy * scale
    c2 = -2.0 * jnp.sum(S * S)
    c1 = -8.0 * _det3(S)
    c0 = _det4(N)
    lam0 = jnp.sqrt(jnp.maximum(gp * gy, 0.0)).astype(dt)

    def newton_step(lam):
        p = ((lam * lam + c2) * lam + c1) * lam + c0
        dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
        dp = jnp.where(jnp.abs(dp) < jnp.finfo(dt).tiny * 4 + 1e-30, 1.0, dp)
        return lam - p / dp

    # Unrolled on purpose: a lax.fori_loop here would be a device-side loop
    # with per-step overhead; unrolled, the whole chain is straight-line
    # scalar code that XLA fuses.
    lam = lam0
    for _ in range(newton_iters):
        lam = newton_step(lam)

    adj = _adjugate4(N - lam * jnp.eye(4, dtype=dt))
    norms = jnp.sum(adj * adj, axis=0)
    v = adj[:, jnp.argmax(norms)]
    # Degenerate-spectrum safety net: if the adjugate collapsed (repeated
    # eigenvalue), fall back to an all-ones seed and let the shifted power
    # iterations find the top eigenspace.  Branchless select — adding an
    # epsilon unconditionally would contaminate the healthy case.
    B = N + (lam0 + jnp.asarray(1.0, dt)) * jnp.eye(4, dtype=dt)
    degenerate = jnp.max(norms) < jnp.asarray(1e-16, dt)
    v = jnp.where(degenerate, jnp.ones((4,), dt), v)

    for _ in range(power_iters):  # unrolled: see the Newton comment above
        w = jnp.sum(B * v[None, :], axis=1)  # fusable matvec (no tiny matmul)
        v = w * jax.lax.rsqrt(jnp.maximum(jnp.sum(w * w), jnp.finfo(dt).tiny))
    return v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v), jnp.finfo(dt).tiny))


def rotation_kabsch(S: jax.Array) -> jax.Array:
    """Kabsch/Umeyama rotation from the cross-covariance S = sum p' y'^T.

    y ~= R p with det(R) = +1 (reflection corrected via the smallest singular
    value's sign, unlike plain SVD alignment).
    """
    # S = sum_i p_i y_i^T; we need R minimizing sum ||y - R p||^2
    # => R = V D U^T from SVD(S) = U Sig V^T, D = diag(1, 1, det(V U^T)).
    hi = jax.lax.Precision.HIGHEST
    U, _, Vt = jnp.linalg.svd(S)
    d = jnp.sign(jnp.linalg.det(jnp.matmul(Vt.T, U.T, precision=hi)))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], S.dtype)).at[2, 2].set(d)
    return jnp.matmul(jnp.matmul(Vt.T, D, precision=hi), U.T, precision=hi)


class Similarity(NamedTuple):
    """A similarity transform y = s * R @ p + t."""

    s: jax.Array  # () scale
    R: jax.Array  # (3, 3) rotation
    t: jax.Array  # (3,) translation


def alignment_from_stats(
    stats: AlignmentStats, *, solver: str = "eigh", with_scale: bool = True
) -> Similarity:
    """Closed-form similarity solve from psum-able sufficient statistics."""
    n = stats.n
    mu_p = stats.sum_p / n
    mu_y = stats.sum_y / n
    # Centered cross-covariance and energies via the shift identities.
    # elementwise forms: no dot product that could run at reduced precision
    S = stats.sum_py - n * (mu_p[:, None] * mu_y[None, :])
    gp = stats.sum_pp - n * jnp.sum(mu_p * mu_p)
    gy = stats.sum_yy - n * jnp.sum(mu_y * mu_y)

    if solver == "kabsch":
        R = rotation_kabsch(S)
    else:
        N = horn_n_matrix(S)
        if solver == "eigh":
            q = max_eigvec_eigh(N)
        elif solver == "qcp":
            q = max_eigvec_qcp(N, S, gp, gy)
        else:
            raise ValueError(f"unknown solver: {solver}")
        R = quat_to_rot(q / jnp.linalg.norm(q))

    one = jnp.asarray(1.0, S.dtype)
    s = jnp.sqrt(gy / gp) if with_scale else one
    # fusable 3-vec matvec (a bare 3x3 @ 3 dispatches its own tiny kernel
    # inside the jitted loop)
    t = mu_y - s * jnp.sum(R * mu_p[None, :], axis=1)
    return Similarity(s=s, R=R, t=t)


def find_alignment(
    p: jax.Array,
    y: jax.Array,
    *,
    solver: str = "eigh",
    with_scale: bool = True,
    acc_dtype=None,
) -> Tuple[Similarity, jax.Array]:
    """Full (single-device) alignment: returns the transform and the
    pre-application residual sum ``sum ||y - (s R p + t)||^2``, mirroring
    reference ``find_alignment``'s return value (``src/cpu.cc:169-174``).
    """
    stats = compute_alignment_stats(p, y, acc_dtype=acc_dtype)
    sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
    from icp_tpu.ops.transform import residual_error

    err = residual_error(p, y, sim)
    return sim, err
