"""Generalized-ICP (plane-to-plane) — Segal et al.'s covariance-weighted
registration.

Each point carries a disk covariance ``C = I - (1 - eps) n n^T`` (large in the
local tangent plane, ``eps`` along the normal).  The per-correspondence
residual ``d = y - T p`` is weighted by ``M = (C_y + R C_p R^T)^-1`` and the
6-vector Gauss-Newton update solves ``sum J^T M J x = sum J^T M d``.
Point-to-point and point-to-plane are the ``eps -> 1`` and ``eps -> 0``
limits; GICP interpolates and is the most accurate of the three on real scan
pairs.  No reference counterpart.

Design: batched closed-form 3x3 inverses (adjugate / det —
branchless, no LAPACK), one einsum pass for the 6x6 system (psum-able),
Rodrigues update — the same building blocks as ``point_to_plane.py``.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from icp_tpu.config import ICPConfig, kernel_interpret
from icp_tpu.engine.icp import ICPResult, ICPTrace, _validate
from icp_tpu.engine.point_to_plane import _rodrigues
from icp_tpu.ops.alignment import Similarity
from icp_tpu.ops.distance import closest_point_indices
from icp_tpu.ops.transform import apply_similarity, compose, identity_similarity


def disk_covariances(normals: jax.Array, eps: float = 1e-3) -> jax.Array:
    """(N, 3) unit normals -> (N, 3, 3) plane-disk covariances
    ``I - (1 - eps) n n^T``."""
    dt = normals.dtype
    eye = jnp.eye(3, dtype=dt)
    nnT = normals[:, :, None] * normals[:, None, :]
    return eye[None] - (1.0 - eps) * nnT


def _inv3_batched(M: jax.Array) -> jax.Array:
    """Closed-form batched inverse of (N, 3, 3) via adjugate / det."""
    a, b, c = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2]
    d, e, f = M[:, 1, 0], M[:, 1, 1], M[:, 1, 2]
    g, h, i = M[:, 2, 0], M[:, 2, 1], M[:, 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-30, 1.0, det)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[:, None, None]


def _gicp_system(p, y, Cy, cov_p, *, weights=None, damping=1e-9, axis=None):
    """Shared GICP Gauss-Newton core: residuals + 6x6 normal equations.

    ``weights``: optional (N,) 0/1 trim mask.  ``axis``: psum the (6,6)/(6,)
    sums over a mesh axis (sharded path).  Returns (sim, p_new, err, M)."""
    dt = p.dtype
    M = _inv3_batched(Cy + cov_p)  # (N, 3, 3)
    d = y - p

    zeros = jnp.zeros_like(p[:, 0])
    px = jnp.stack(
        [
            jnp.stack([zeros, -p[:, 2], p[:, 1]], axis=-1),
            jnp.stack([p[:, 2], zeros, -p[:, 0]], axis=-1),
            jnp.stack([-p[:, 1], p[:, 0], zeros], axis=-1),
        ],
        axis=-2,
    )  # (N, 3, 3) = [p]_x
    J = jnp.concatenate(
        [px, -jnp.broadcast_to(jnp.eye(3, dtype=dt), px.shape)], axis=-1
    )  # (N, 3, 6)
    HI = jax.lax.Precision.HIGHEST
    Mw = M if weights is None else M * weights[:, None, None]
    MJ = jnp.einsum("nij,njk->nik", Mw, J, precision=HI)
    A = jnp.einsum("nji,njk->ik", J, MJ, precision=HI)
    b = jnp.einsum("nji,njk,nk->i", J, Mw, d, precision=HI)
    if axis is not None:
        A = jax.lax.psum(A, axis)
        b = jax.lax.psum(b, axis)
    x = -jnp.linalg.solve(A + damping * jnp.eye(6, dtype=dt), b)

    sim = Similarity(s=jnp.asarray(1.0, dt), R=_rodrigues(x[:3]), t=x[3:])
    p_new = apply_similarity(p, sim)
    dn = y - p_new
    e = jnp.einsum("ni,nij,nj->n", dn, Mw, dn, precision=HI)
    if axis is not None:
        nw = jax.lax.psum(
            jnp.sum(weights) if weights is not None
            else jnp.asarray(p.shape[0], dt), axis
        )
        err = jax.lax.psum(jnp.sum(e), axis) / nw
    else:
        nw = jnp.sum(weights) if weights is not None else jnp.asarray(p.shape[0], dt)
        err = jnp.sum(e) / nw
    return sim, p_new, err


def _gicp_step(p, cov_p, model, cov_m, *, nn_method, scene_tile, model_tile,
               trim_fraction=0.0, damping=1e-9, scene_mask=None):
    """One GICP Gauss-Newton iteration.  ``cov_p`` must already be expressed
    in the CURRENT scene frame (rotated alongside p by the caller)."""
    idx = closest_point_indices(
        p, model, method=nn_method, scene_tile=scene_tile, model_tile=model_tile
    )
    y = jnp.take(model, idx, axis=0)
    Cy = jnp.take(cov_m, idx, axis=0)
    # trim by euclidean distance; bucket-padding mask folded in
    from icp_tpu.engine.icp import _step_weights

    w = _step_weights(p, y, trim_fraction, scene_mask)
    sim, p_new, err = _gicp_system(p, y, Cy, cov_p, weights=w, damping=damping)
    return p_new, sim, err


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "nn_method", "scene_tile", "model_tile",
                     "trim_fraction", "trace"),
)
def _gicp_while(
    model,
    cov_m,
    scene,
    cov_s,
    threshold,
    *,
    max_iter: int,
    nn_method: str,
    scene_tile: int,
    model_tile: int,
    trim_fraction: float = 0.0,
    trace: bool = False,
    init_sim=None,
    scene_n=None,
    model_n=None,
):
    from icp_tpu.engine.icp import _bucket_prologue

    dt = scene.dtype
    model, scene, scene_mask = _bucket_prologue(model, scene, scene_n, model_n)
    if init_sim is not None:
        scene = apply_similarity(scene, init_sim)
        # rotate the scene covariances into the warm-start frame
        cov_s = jnp.einsum(
            "ij,njk,lk->nil", init_sim.R, cov_s, init_sim.R,
            precision=jax.lax.Precision.HIGHEST,
        )

    def cond(carry):
        _, _, _, err, it, _ = carry
        return jnp.logical_and(it < max_iter, err >= threshold)

    def body(carry):
        p, cov_p, sim_tot, _, it, errs = carry
        p_new, sim, err = _gicp_step(
            p, cov_p, model, cov_m, nn_method=nn_method,
            scene_tile=scene_tile, model_tile=model_tile,
            trim_fraction=trim_fraction, scene_mask=scene_mask,
        )
        # rotate the scene covariances with the step: C <- R C R^T
        cov_p = jnp.einsum(
            "ij,njk,lk->nil", sim.R, cov_p, sim.R,
            precision=jax.lax.Precision.HIGHEST,
        )
        if trace:
            errs = jax.lax.dynamic_update_index_in_dim(
                errs, err.astype(errs.dtype), it, 0
            )
        return p_new, cov_p, compose(sim_tot, sim), err, it + 1, errs

    init = (
        scene,
        cov_s,
        identity_similarity(dt) if init_sim is None else init_sim,
        jnp.asarray(jnp.inf, dt),
        jnp.asarray(0, jnp.int32),
        jnp.full((max_iter,), jnp.nan, dt) if trace else 0,
    )
    p, _, sim_tot, err, it, errs = jax.lax.while_loop(cond, body, init)
    result = ICPResult(points=p, transform=sim_tot, err=err, iters=it)
    return ICPTrace(result=result, errs=errs) if trace else result


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "scene_tile_target", "model_tile_target",
                     "max_candidates", "trim_fraction", "eps", "trace"),
)
def _gicp_grid(
    model,
    model_normals,
    scene,
    cov_s,
    threshold,
    *,
    max_iter: int,
    scene_tile_target: int = 256,
    model_tile_target: int = 1024,
    max_candidates: int = 16,
    trim_fraction: float = 0.0,
    eps: float = 1e-3,
    trace: bool = False,
    init_sim=None,
    scene_n=None,  # dynamic bucket-padding valid counts (ops/padding.py)
    model_n=None,
):
    """Grid-pruned GICP loop (``nn_method="grid"``).

    The model covariance is a pure function of the model normal
    (``disk_covariances``: I - (1-eps) n n^T), so only the NORMAL rides the
    grid as payload and the winning covariance is recomputed on the fly
    from the matched normal.  Culling bound ``u`` is the Euclidean residual
    (the Mahalanobis error does not bound the NN distance).
    """
    from icp_tpu.engine.grid import _prepare_scene
    from icp_tpu.kernels.nn_grid import (
        bound_from_indices,
        build_model_grid,
        closest_point_indices_grid,
        initial_bound_indices,
        next_bound,
    )

    _BIG = 3.0e38
    dt = scene.dtype
    interp = kernel_interpret()
    n = scene.shape[0]
    from icp_tpu.engine.icp import _bucket_prologue

    model, scene, _ = _bucket_prologue(model, scene, scene_n, model_n)
    if init_sim is not None:
        scene = apply_similarity(scene, init_sim)
        cov_s = jnp.einsum(
            "ij,njk,lk->nil", init_sim.R, cov_s, init_sim.R,
            precision=jax.lax.Precision.HIGHEST,
        )

    grid = build_model_grid(model, target_tile=model_tile_target,
                            payload=model_normals)
    p0, w, inv_slots, tn, perm = _prepare_scene(scene, scene_tile_target,
                                                n_valid=scene_n)
    n_pad = p0.shape[0]
    # scene covariances ride the kd permutation; pad rows get identity
    # (inert: weight 0 everywhere they appear)
    eye_pad = jnp.broadcast_to(jnp.eye(3, dtype=dt), (n_pad - n, 3, 3))
    cov0 = jnp.concatenate([cov_s, eye_pad], axis=0)[perm]
    stride = max(1, min(16, model.shape[0] // 4))
    idx0 = initial_bound_indices(p0, grid.model_orig, stride=stride,
                                 interpret=interp)
    u0 = bound_from_indices(p0, grid, idx0)

    def body(carry):
        p, cov_p, sim_tot, _, it, u, errs = carry
        _, y, nv, d2 = closest_point_indices_grid(
            p, grid, u, scene_tile=tn, max_candidates=max_candidates,
            interpret=interp,
        )
        y = y.astype(dt)
        Cy = disk_covariances(nv.astype(dt), eps)
        if trim_fraction > 0.0:
            from icp_tpu.ops.quantile import histogram_quantile

            if p.dtype != jnp.float32:
                d2 = jnp.sum((y - p) ** 2, axis=1)
            # masked histogram: padded rows (w=0) are excluded, no q rescale
            tau = histogram_quantile(d2, 1.0 - trim_fraction, w)
            w_eff = w * (d2 <= tau).astype(w.dtype)
        else:
            w_eff = w
        sim, p_new, err = _gicp_system(p, y, Cy, cov_p, weights=w_eff)
        cov_p = jnp.einsum(
            "ij,njk,lk->nil", sim.R, cov_p, sim.R,
            precision=jax.lax.Precision.HIGHEST,
        )
        u_next = next_bound(y, p_new)
        if trace:
            errs = jax.lax.dynamic_update_index_in_dim(
                errs, err.astype(errs.dtype), it, 0
            )
        return p_new, cov_p, compose(sim_tot, sim), err, it + 1, u_next, errs

    init = (
        p0,
        cov0,
        identity_similarity(dt) if init_sim is None else init_sim,
        jnp.asarray(jnp.inf, dt),
        jnp.asarray(0, jnp.int32),
        u0,
        jnp.full((max_iter,), jnp.nan, dt) if trace else 0,
    )
    p, _, sim_tot, err, it, _, errs = jax.lax.while_loop(
        lambda c: jnp.logical_and(c[4] < max_iter, c[3] >= threshold),
        body, init,
    )
    result = ICPResult(points=p[inv_slots], transform=sim_tot, err=err,
                       iters=it)
    return ICPTrace(result=result, errs=errs) if trace else result


def icp_generalized(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    model_normals=None,
    scene_normals=None,
    normal_k: int = 16,
    eps: float = 1e-3,
    init=None,
    trace: bool = False,
    scene_n=None,
    model_n=None,
):
    """Generalized (plane-to-plane) ICP.  Normals for BOTH clouds are
    estimated via kNN-PCA if not given; ``eps`` is the across-surface
    covariance (0 -> pure plane metric, 1 -> point-to-point).  ``init``:
    optional warm-start ``Similarity``.

    ``scene_n`` / ``model_n``: dynamic valid-row counts for bucket-padded
    clouds (``ops/padding.py``) — pad rows must be FAR sentinels
    (``pad_to_bucket``) so the internal normal estimation stays exact for
    real rows; the engine replica-fills them before the hot loop and masks
    them out of every statistic.  One compiled program per bucket."""
    from icp_tpu.engine.icp import _cast_sim
    from icp_tpu.ops.normals import estimate_normals

    cfg = config or ICPConfig()
    model = jnp.asarray(model, cfg.dtype)
    scene = jnp.asarray(scene, cfg.dtype)
    _validate(model, scene, cfg)
    # normals estimated on the clouds AS GIVEN (sentinel pad rows never
    # enter a real row's kNN) — before the engines' in-loop replica fill
    if model_normals is None:
        model_normals = estimate_normals(model, k=normal_k)
    if scene_normals is None:
        scene_normals = estimate_normals(scene, k=normal_k)
    cov_s = disk_covariances(jnp.asarray(scene_normals, cfg.dtype), eps)
    if scene_n is not None:
        scene_n = jnp.asarray(scene_n, jnp.int32)
    if model_n is not None:
        model_n = jnp.asarray(model_n, jnp.int32)
    n_points = max(model.shape[0], scene.shape[0])
    if cfg.resolved_nn_method(n_points=n_points) == "grid":
        return _gicp_grid(
            model,
            jnp.asarray(model_normals, jnp.float32),
            scene,
            cov_s,
            jnp.asarray(cfg.threshold, cfg.dtype),
            max_iter=cfg.max_iter,
            scene_tile_target=cfg.grid_scene_tile,
            model_tile_target=cfg.grid_model_tile,
            max_candidates=cfg.grid_max_candidates,
            trim_fraction=cfg.trim_fraction,
            eps=eps,
            trace=trace,
            init_sim=None if init is None else _cast_sim(init, cfg.dtype),
            scene_n=scene_n,
            model_n=model_n,
        )
    cov_m = disk_covariances(jnp.asarray(model_normals, cfg.dtype), eps)
    return _gicp_while(
        model,
        cov_m,
        scene,
        cov_s,
        jnp.asarray(cfg.threshold, cfg.dtype),
        max_iter=cfg.max_iter,
        nn_method=cfg.resolved_nn_method(n_points=n_points),
        scene_tile=cfg.scene_tile,
        model_tile=cfg.model_tile,
        trim_fraction=cfg.trim_fraction,
        trace=trace,
        init_sim=None if init is None else _cast_sim(init, cfg.dtype),
        scene_n=scene_n,
        model_n=model_n,
    )


def icp_generalized_sharded(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    model_normals=None,
    scene_normals=None,
    normal_k: int = 16,
    eps: float = 1e-3,
    mesh=None,
    trace: bool = False,
):
    """Multi-chip GICP: scene + its covariances sharded over the points
    mesh; model + ITS covariances ride the ring ``ppermute`` fold as payload
    (the winning (point, covariance) pair is gathered during the fold — no
    device ever holds the full model); the 6x6 covariance-weighted normal
    equations are psum-reduced and the solve + Rodrigues run replicated.
    Supports trimmed GICP via the distributed histogram quantile.
    ``trace=True`` returns an ``ICPTrace`` with the per-iteration
    Mahalanobis errors (same observability contract as every other engine)."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from icp_tpu.ops.normals import estimate_normals
    from icp_tpu.parallel.mesh import make_mesh

    if (config or ICPConfig()).resolved_nn_method(
            n_points=max(len(model), len(scene))) == "grid":
        from icp_tpu.parallel.sharded_grid import gn_sharded_grid

        return gn_sharded_grid(
            model, scene, config, engine="gicp",
            model_normals=model_normals, scene_normals=scene_normals,
            normal_k=normal_k, eps=eps, mesh=mesh, trace=trace,
        )
    from icp_tpu.parallel.sharded import (
        _distributed_quantile,
        _pad_rows,
        _ring_correspond,
    )

    cfg = config or ICPConfig()
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    model_j = jnp.asarray(model, cfg.dtype)
    scene_j = jnp.asarray(scene, cfg.dtype)
    if model_normals is None:
        model_normals = estimate_normals(model_j, k=normal_k)
    if scene_normals is None:
        scene_normals = estimate_normals(scene_j, k=normal_k)
    cov_m = disk_covariances(jnp.asarray(model_normals, cfg.dtype), eps)
    cov_s = disk_covariances(jnp.asarray(scene_normals, cfg.dtype), eps)

    dtype = np.dtype(cfg.dtype)
    model_np = np.asarray(model, dtype)
    scene_np = np.asarray(scene, dtype)
    n = scene_np.shape[0]
    m = model_np.shape[0]

    scene_pad = _pad_rows(scene_np, n_dev, 0.0)
    model_pad = _pad_rows(model_np, n_dev, 1.0e17)
    # covariances padded flat (k, 9) then reshaped: identity rows are inert
    covm_flat = _pad_rows(
        np.asarray(cov_m, dtype).reshape(m, 9), n_dev,
        0.0,
    )
    covs_flat = _pad_rows(
        np.asarray(cov_s, dtype).reshape(n, 9), n_dev, 0.0
    )
    # identity covariance on pad rows (inert in the GN stats; guard the
    # no-pad case — _pad_rows then returns the read-only original)
    eye9 = np.eye(3, dtype=dtype).reshape(1, 9)
    if covm_flat.shape[0] > m:
        covm_flat[m:, :] = eye9
    if covs_flat.shape[0] > n:
        covs_flat[n:, :] = eye9
    mask = np.zeros((scene_pad.shape[0],), dtype)
    mask[:n] = 1.0

    shard = NamedSharding(mesh, PartitionSpec(axis, None))
    row = NamedSharding(mesh, PartitionSpec(axis))
    args = (
        jax.device_put(model_pad, shard),
        jax.device_put(covm_flat, shard),
        jax.device_put(scene_pad, shard),
        jax.device_put(covs_flat, shard),
        jax.device_put(mask, row),
    )

    max_iter = cfg.max_iter
    trim_fraction = cfg.trim_fraction
    threshold = jnp.asarray(cfg.threshold, cfg.dtype)
    nn_impl = "pallas" if cfg.resolved_nn_method() == "pallas" else "jnp"

    @functools.partial(jax.jit, static_argnames=())
    def run(m_loc, cm_loc, p_loc, cs_loc, w_loc):
        def local(m_loc, cm_loc, p_loc, cs_loc, w_loc):
            dt = p_loc.dtype

            def cond(carry):
                err, it = carry[3], carry[4]
                return jnp.logical_and(it < max_iter, err >= threshold)

            def body(carry):
                p, cov_p, sim_tot, _, it = carry[:5]
                y, _, (cy_flat,) = _ring_correspond(
                    p, m_loc, axis=axis, n_dev=n_dev, nn_impl=nn_impl,
                    payload=(cm_loc,),
                )
                Cy = cy_flat.reshape(-1, 3, 3)
                if trim_fraction > 0.0:
                    d2 = jnp.sum((y - p) ** 2, axis=1)
                    tau = _distributed_quantile(
                        d2, w_loc, 1.0 - trim_fraction, axis
                    )
                    w_eff = w_loc * (d2 <= tau).astype(dt)
                else:
                    w_eff = w_loc
                sim, p_new, err = _gicp_system(
                    p, y, Cy, cov_p.reshape(-1, 3, 3), weights=w_eff,
                    axis=axis,
                )
                cov_p2 = jnp.einsum(
                    "ij,njk,lk->nil", sim.R, cov_p.reshape(-1, 3, 3), sim.R,
                    precision=jax.lax.Precision.HIGHEST,
                ).reshape(-1, 9)
                out = (p_new, cov_p2, compose(sim_tot, sim), err, it + 1)
                if trace:
                    errs = jax.lax.dynamic_update_index_in_dim(
                        carry[5], err.astype(carry[5].dtype), it, 0
                    )
                    out = out + (errs,)
                return out

            init = (p_loc, cs_loc, identity_similarity(dt),
                    jnp.asarray(jnp.inf, dt), jnp.asarray(0, jnp.int32))
            if trace:
                init = init + (jnp.full((max_iter,), jnp.nan, dt),)
            out = jax.lax.while_loop(cond, body, init)
            p, _, sim_tot, err, it = out[:5]
            return (p, sim_tot, err, it) + ((out[5],) if trace else ())

        from jax.sharding import PartitionSpec as P

        out_specs = (P(axis, None), P(), P(), P()) + ((P(),) if trace else ())
        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis, None),
                      P(axis, None), P(axis)),
            out_specs=out_specs,
            check_vma=False,
        )(m_loc, cm_loc, p_loc, cs_loc, w_loc)

    out = run(*args)
    p, sim_tot, err, it = out[:4]
    result = ICPResult(points=p[:n], transform=sim_tot, err=err, iters=it)
    return ICPTrace(result=result, errs=out[4]) if trace else result
