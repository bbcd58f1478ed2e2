"""Closest-point correspondence search (the ICP hot loop).

Reference behavior being matched (NOT the implementation):
  * brute-force nearest neighbor: for every scene point, the model point with
    minimal euclidean distance (reference ``CPU::closest_matrix``
    ``src/cpu.cc:5-27`` — 99.74% of its CPU runtime; CUDA opti version
    ``src/GPU/compute.cu:94-245``);
  * squared distance is the contract (the CUDA path skips the sqrt,
    ``src/GPU/compute.cu:117``; argmin-equivalent);
  * ties resolve to the LOWEST model index (strict ``>`` comparisons,
    ``src/cpu.cc:22``, ``src/GPU/compute.cu:137``).

Implementations behind one dispatcher:
  * ``bcast``: XLA broadcast form — subtract/square/sum then argmin.  Whether
    XLA fuses the length-3 sum into the argmin reduce decides whether the
    N x M distance matrix is written; it is the CPU default.
  * ``matmul``: the classic ``||p||^2 + ||m||^2 - 2 p.m`` expansion at
    ``precision=HIGHEST``.  Materializes N x M; kept as a cross-check.
  * ``blocked``: exact blocked fold in plain XLA — scene chunks under
    ``lax.map``, model chunks folded with a strict ``<`` (lowest index on
    ties).  Never holds more than one (chunk x chunk) block; the plain
    reference the kernels are compared with at scale.
  * ``pallas``: the dense Triton kernel (``icp_tpu.kernels.nn_pallas``) —
    running (min, argmin) carry across model tiles in registers.

All return int32 indices into the model; gathering the matched points
(``Y = model[idx]``) is left to the caller so the gather can be fused or
sharded as needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def closest_point_indices_bcast(scene: jax.Array, model: jax.Array) -> jax.Array:
    """Fused broadcast form: argmin_j ||scene_i - model_j||^2 -> (N,) int32."""
    d2 = jnp.sum(
        (scene[:, None, :] - model[None, :, :]) ** 2, axis=-1
    )  # fused into the reduction by XLA
    return jnp.argmin(d2, axis=1).astype(jnp.int32)


def closest_point_indices_matmul(scene: jax.Array, model: jax.Array) -> jax.Array:
    """Matrix-product expansion: ||m||^2 - 2 s.m (the ||s||^2 term is constant per row
    and cannot change the argmin, so it is dropped — fewer flops, and it
    avoids one source of f32 cancellation)."""
    cross = jnp.matmul(scene, model.T, precision=jax.lax.Precision.HIGHEST)
    m2 = jnp.sum(model * model, axis=1)
    d2 = m2[None, :] - 2.0 * cross
    return jnp.argmin(d2, axis=1).astype(jnp.int32)


def closest_point_blocked(scene: jax.Array, model: jax.Array, *,
                          scene_chunk: int = 1024,
                          model_chunk: int = 65536):
    """Exact NN in plain XLA without the N x M matrix: ``(idx, d2)``.

    Scene rows in chunks under ``lax.map``; within a chunk the model is
    folded in chunks, ascending, with a strict ``<`` so the lowest index
    wins ties.  Distances in the subtract form, in the input dtype."""
    n = scene.shape[0]
    m = model.shape[0]
    sc = min(scene_chunk, n)
    mc = min(model_chunk, m)
    n_pad = -(-n // sc) * sc
    m_pad = -(-m // mc) * mc
    s_pad = jnp.concatenate(
        [scene, jnp.broadcast_to(scene[-1], (n_pad - n, 3))], axis=0)
    m_pad_arr = jnp.concatenate(
        [model, jnp.full((m_pad - m, 3), 1.0e17, model.dtype)], axis=0)
    m_blocks = m_pad_arr.reshape(m_pad // mc, mc, 3)

    def one(sc_rows):
        def fold(carry, xs):
            best_d, best_i = carry
            j, mb = xs
            d = jnp.sum((sc_rows[:, None, :] - mb[None, :, :]) ** 2, axis=-1)
            arg = jnp.argmin(d, axis=1).astype(jnp.int32)
            dmin = jnp.min(d, axis=1)
            better = dmin < best_d
            return (jnp.where(better, dmin, best_d),
                    jnp.where(better, arg + j * mc, best_i)), None

        init = (jnp.full((sc,), jnp.inf, scene.dtype),
                jnp.zeros((sc,), jnp.int32))
        (d, i), _ = jax.lax.scan(
            fold, init, (jnp.arange(m_pad // mc, dtype=jnp.int32), m_blocks))
        return i, d

    idx, d2 = jax.lax.map(one, s_pad.reshape(n_pad // sc, sc, 3))
    return idx.reshape(n_pad)[:n], d2.reshape(n_pad)[:n]


def closest_point_indices(
    scene: jax.Array,
    model: jax.Array,
    *,
    method: str = "auto",
    scene_tile: int = 16,
    model_tile: int = 64,
) -> jax.Array:
    """Dispatching wrapper. ``method`` in {auto, bcast, matmul, blocked,
    pallas}; ``auto`` and the kernel's interpret mode come from the one
    resolver in ``icp_tpu.config``.  Where the resolver would pick the
    kd-grid (an engine-level path that carries bounds across iterations),
    a one-off query takes the dense kernel: exact, and it never
    materializes N x M."""
    from icp_tpu.config import kernel_interpret, resolve_nn_method

    method = resolve_nn_method(
        method, n_points=max(scene.shape[0], model.shape[0]))
    if method == "grid":
        method = "pallas"
    if method == "bcast":
        return closest_point_indices_bcast(scene, model)
    if method == "matmul":
        return closest_point_indices_matmul(scene, model)
    if method == "blocked":
        return closest_point_blocked(scene, model)[0]
    if method == "pallas":
        from icp_tpu.kernels import nn_pallas

        return nn_pallas.closest_point_pallas(
            scene, model, block_n=scene_tile, block_m=model_tile,
            interpret=kernel_interpret(),
        )[0]
    raise ValueError(f"unknown nn method: {method}")


def squared_distances(scene: jax.Array, model: jax.Array) -> jax.Array:
    """Dense N x M squared-distance matrix (test/debug utility only; the
    production paths never materialize it)."""
    return jnp.sum((scene[:, None, :] - model[None, :, :]) ** 2, axis=-1)
