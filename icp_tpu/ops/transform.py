"""Similarity-transform application, composition and residuals.

Reference counterparts: ``CPU::err_compute`` (apply + error in one pass,
``src/cpu.cc:29-40``), ``CPU::err_compute_alignment`` (non-mutating residual,
``src/cpu.cc:93-103``), CUDA fused kernel ``compute_err``
(``src/GPU/compute.cu:315-379``).  Here these are single fused passes
(XLA fuses transform + subtract + square + reduce); no hand-written kernel is
needed.

Unlike the reference (which only ever mutates the running cloud and never
composes the per-iteration transforms — SURVEY.md §3 numerics contract), we
also provide composition so the engine can report the *cumulative* transform,
needed for RMSE-vs-reference-transform metrics and for the SLAM layer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from icp_tpu.ops.alignment import Similarity


def identity_similarity(dtype=jnp.float32) -> Similarity:
    """s=1, R=I, t=0 — the reference's init (``src/cpu.hh:57-59``)."""
    return Similarity(
        s=jnp.asarray(1.0, dtype),
        R=jnp.eye(3, dtype=dtype),
        t=jnp.zeros((3,), dtype),
    )


def apply_similarity(p: jax.Array, sim: Similarity) -> jax.Array:
    """p -> s R p + t for an (N, 3) cloud (rows = points).

    HIGHEST precision: a reduced-precision product (TF32 on the GPU) would
    inject ~1e-3-relative noise into the cloud every iteration, capping ICP
    convergence far above the reference threshold; the (N,3)x(3,3) product
    is bandwidth-bound so full f32 is free.
    """
    return (
        jnp.matmul(p, (sim.s * sim.R).T, precision=jax.lax.Precision.HIGHEST)
        + sim.t
    )


def residual_error(p: jax.Array, y: jax.Array, sim: Similarity) -> jax.Array:
    """sum_i ||y_i - (s R p_i + t)||^2 without mutating p
    (= reference ``err_compute_alignment``, ``src/cpu.cc:93-103``)."""
    d = y - apply_similarity(p, sim)
    return jnp.sum(d * d)


def apply_and_error(
    p: jax.Array, y: jax.Array, sim: Similarity
) -> tuple[jax.Array, jax.Array]:
    """Fused transform + residual (= reference ``err_compute``,
    ``src/cpu.cc:29-40``): returns (transformed p, sum ||y - p_new||^2)."""
    p_new = apply_similarity(p, sim)
    d = y - p_new
    return p_new, jnp.sum(d * d)


def _mm3(A: jax.Array, B: jax.Array) -> jax.Array:
    """Fusable 3x3 @ 3x3 (a bare matmul dispatches a tiny kernel per loop
    iteration; the broadcast form fuses into the scalar chain)."""
    return jnp.sum(A[:, :, None] * B[None, :, :], axis=1)


def _mv3(A: jax.Array, v: jax.Array) -> jax.Array:
    """Fusable 3x3 @ 3-vector."""
    return jnp.sum(A * v[None, :], axis=1)


def compose(inner: Similarity, outer: Similarity) -> Similarity:
    """Transform equal to applying ``inner`` first, then ``outer``:
    x -> s_o R_o (s_i R_i x + t_i) + t_o."""
    s = outer.s * inner.s
    R = _mm3(outer.R, inner.R)
    t = outer.s * _mv3(outer.R, inner.t) + outer.t
    return Similarity(s=s, R=R, t=t)


def inverse(sim: Similarity) -> Similarity:
    """Inverse similarity: x -> (1/s) R^T (x - t)."""
    s_inv = 1.0 / sim.s
    R_inv = sim.R.T
    return Similarity(s=s_inv, R=R_inv, t=-s_inv * _mv3(R_inv, sim.t))
