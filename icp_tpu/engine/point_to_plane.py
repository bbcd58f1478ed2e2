"""Point-to-plane ICP — the production-SLAM variant of the registration loop.

Minimizes ``sum_i (n_i . (T p_i - y_i))^2`` (distance along the matched model
point's surface normal) instead of the point-to-point distance.  Converges in
far fewer iterations on smooth surfaces and tolerates sliding contact — the
standard choice in real scan-matching pipelines.  No reference counterpart
(the reference is point-to-point only; SURVEY.md §2).

Structure mirrors the point-to-point engine:
  * correspondence via the same NN paths (indices gather model points
    AND their precomputed normals);
  * the Gauss-Newton normal equations ``A x = b`` over the 6-vector
    ``x = [omega, t]`` (small-angle rotation + translation) are plain sums of
    per-point outer products — one fused einsum pass, psum-able for sharding;
  * the 6x6 solve is tiny and branchless (Cholesky-free ``jnp.linalg.solve``
    compiles fine at this size, unlike eigh);
  * rotation update via Rodrigues' formula (closed form, branchless).

Rigid (SE(3)) only — scale is not meaningful for the linearized plane metric.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from icp_tpu.config import ICPConfig, kernel_interpret
from icp_tpu.engine.icp import ICPResult, ICPTrace, _validate
from icp_tpu.ops.alignment import Similarity
from icp_tpu.ops.distance import closest_point_indices
from icp_tpu.ops.transform import apply_similarity, compose, identity_similarity


def _rodrigues(omega: jax.Array) -> jax.Array:
    """exp of the skew of a small rotation vector (3,) -> (3, 3)."""
    dt = omega.dtype
    theta = jnp.sqrt(jnp.maximum(jnp.sum(omega * omega), jnp.asarray(1e-30, dt)))
    k = omega / theta
    K = jnp.array(
        [
            [0.0, -k[2], k[1]],
            [k[2], 0.0, -k[0]],
            [-k[1], k[0], 0.0],
        ],
        dt,
    )
    s, c = jnp.sin(theta), jnp.cos(theta)
    KK = jnp.matmul(K, K, precision=jax.lax.Precision.HIGHEST)
    R = jnp.eye(3, dtype=dt) + s * K + (1.0 - c) * KK
    # theta ~ 0: R -> I (the formula above is already stable there thanks to
    # the clamped theta, but guard the k = omega/theta division artifact)
    return jnp.where(theta < 1e-12, jnp.eye(3, dtype=dt), R)


def _p2pl_step(p, model, normals, *, nn_method, scene_tile, model_tile,
               trim_fraction=0.0, damping=1e-9, scene_mask=None):
    idx = closest_point_indices(
        p, model, method=nn_method, scene_tile=scene_tile, model_tile=model_tile
    )
    y = jnp.take(model, idx, axis=0)
    n = jnp.take(normals, idx, axis=0)

    r = jnp.sum(n * (p - y), axis=1)  # (N,) signed plane distances
    J = jnp.concatenate([jnp.cross(p, n), n], axis=1)  # (N, 6)
    # trim by EUCLIDEAN correspondence distance (same robustness notion as
    # the point-to-point/GICP engines — the plane residual can be tiny for a
    # gross outlier sliding along a surface); bucket-padding mask folded in
    # (ops/padding.py)
    from icp_tpu.engine.icp import _step_weights

    w = _step_weights(p, y, trim_fraction, scene_mask)
    if w is not None:
        r = r * w
        J = J * w[:, None]
        n_eff = jnp.sum(w)
    else:
        n_eff = jnp.asarray(p.shape[0], p.dtype)
    A = jnp.einsum("ni,nj->ij", J, J, precision=jax.lax.Precision.HIGHEST)
    b = jnp.einsum("ni,n->i", J, r, precision=jax.lax.Precision.HIGHEST)
    x = -jnp.linalg.solve(A + damping * jnp.eye(6, dtype=p.dtype), b)

    R = _rodrigues(x[:3])
    t = x[3:]
    sim = Similarity(s=jnp.asarray(1.0, p.dtype), R=R, t=t)
    p_new = apply_similarity(p, sim)
    res = jnp.sum(n * (p_new - y), axis=1)
    if w is not None:
        res = res * w
    err = jnp.sum(res ** 2) / n_eff
    return p_new, sim, err


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "scene_tile_target", "model_tile_target",
                     "max_candidates", "trim_fraction", "trace"),
)
def _icp_p2pl_grid(
    model,
    normals,
    scene,
    threshold,
    *,
    max_iter: int,
    scene_tile_target: int = 256,
    model_tile_target: int = 1024,
    max_candidates: int = 16,
    trim_fraction: float = 0.0,
    trace: bool = False,
    init_sim=None,
    scene_n=None,  # dynamic bucket-padding valid counts (ops/padding.py)
    model_n=None,
):
    """Grid-pruned point-to-plane loop (``nn_method="grid"``).

    The model normals ride the grid as its payload (``build_model_grid``),
    and the winning (point, normal) pair is gathered by the index the
    work-list kernel returns, same as ``engine/grid.py``.  The culling
    bound ``u`` is the
    EUCLIDEAN residual ``||y - p_new||^2`` (the plane residual does not
    bound the NN distance).
    """
    from icp_tpu.engine.grid import _prepare_scene
    from icp_tpu.engine.icp import _bucket_prologue
    from icp_tpu.kernels.nn_grid import (
        bound_from_indices,
        build_model_grid,
        closest_point_indices_grid,
        initial_bound_indices,
        next_bound,
    )

    dt = scene.dtype
    interp = kernel_interpret()
    model, scene, _ = _bucket_prologue(model, scene, scene_n, model_n)
    if init_sim is not None:
        scene = apply_similarity(scene, init_sim)

    grid = build_model_grid(model, target_tile=model_tile_target,
                            payload=normals)
    p0, w, inv_slots, tn, _ = _prepare_scene(scene, scene_tile_target,
                                             n_valid=scene_n)
    stride = max(1, min(16, model.shape[0] // 4))
    idx0 = initial_bound_indices(p0, grid.model_orig, stride=stride,
                                 interpret=interp)
    u0 = bound_from_indices(p0, grid, idx0)

    def body(carry):
        p, sim_tot, _, it, u, errs = carry
        _, y, nv, d2 = closest_point_indices_grid(
            p, grid, u, scene_tile=tn, max_candidates=max_candidates,
            interpret=interp,
        )
        y = y.astype(dt)
        nv = nv.astype(dt)
        if trim_fraction > 0.0:
            from icp_tpu.ops.quantile import histogram_quantile

            # Euclidean-distance trim (same notion as the other engines);
            # masked histogram — padded rows (w=0) excluded
            if dt != jnp.float32:
                d2 = jnp.sum((y - p) ** 2, axis=1)
            tau = histogram_quantile(d2, 1.0 - trim_fraction, w)
            w_eff = w * (d2 <= tau).astype(w.dtype)
        else:
            w_eff = w
        r = jnp.sum(nv * (p - y), axis=1) * w_eff
        J = jnp.concatenate([jnp.cross(p, nv), nv], axis=1) * w_eff[:, None]
        A = jnp.einsum("ni,nj->ij", J, J, precision=jax.lax.Precision.HIGHEST)
        b = jnp.einsum("ni,n->i", J, r, precision=jax.lax.Precision.HIGHEST)
        x = -jnp.linalg.solve(A + 1e-9 * jnp.eye(6, dtype=dt), b)
        sim = Similarity(s=jnp.asarray(1.0, dt), R=_rodrigues(x[:3]), t=x[3:])
        p_new = apply_similarity(p, sim)
        d = y - p_new
        err = jnp.sum((jnp.sum(nv * d, axis=1) * w_eff) ** 2) / jnp.sum(w_eff)
        u_next = next_bound(y, p_new)
        if trace:
            errs = jax.lax.dynamic_update_index_in_dim(
                errs, err.astype(errs.dtype), it, 0
            )
        return p_new, compose(sim_tot, sim), err, it + 1, u_next, errs

    init = (
        p0,
        identity_similarity(dt) if init_sim is None else init_sim,
        jnp.asarray(jnp.inf, dt),
        jnp.asarray(0, jnp.int32),
        u0,
        jnp.full((max_iter,), jnp.nan, dt) if trace else 0,
    )
    p, sim_tot, err, it, _, errs = jax.lax.while_loop(
        lambda c: jnp.logical_and(c[3] < max_iter, c[2] >= threshold),
        body, init,
    )
    result = ICPResult(points=p[inv_slots], transform=sim_tot, err=err,
                       iters=it)
    return ICPTrace(result=result, errs=errs) if trace else result


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "nn_method", "scene_tile", "model_tile",
                     "trim_fraction", "trace"),
)
def _icp_p2pl_while(
    model,
    normals,
    scene,
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

    def cond(carry):
        _, _, err, it, _ = carry
        return jnp.logical_and(it < max_iter, err >= threshold)

    def body(carry):
        p, sim_tot, _, it, errs = carry
        p_new, sim, err = _p2pl_step(
            p, model, normals, nn_method=nn_method,
            scene_tile=scene_tile, model_tile=model_tile,
            trim_fraction=trim_fraction, scene_mask=scene_mask,
        )
        if trace:
            errs = jax.lax.dynamic_update_index_in_dim(
                errs, err.astype(errs.dtype), it, 0
            )
        return p_new, compose(sim_tot, sim), err, it + 1, errs

    init = (
        scene,
        identity_similarity(dt) if init_sim is None else init_sim,
        jnp.asarray(jnp.inf, dt),
        jnp.asarray(0, jnp.int32),
        jnp.full((max_iter,), jnp.nan, dt) if trace else 0,
    )
    p, sim_tot, err, it, errs = jax.lax.while_loop(cond, body, init)
    result = ICPResult(points=p, transform=sim_tot, err=err, iters=it)
    return ICPTrace(result=result, errs=errs) if trace else result


def icp_point_to_plane_sharded(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    normals=None,
    normal_k: int = 16,
    mesh=None,
    trace: bool = False,
):
    """Multi-chip point-to-plane: scene AND model sharded over the points
    mesh; correspondence via the ring ``ppermute`` fold with the normals
    riding the ring as payload (the winning normal is gathered during the
    fold — no device ever holds the full model or an O(N_loc x M) buffer,
    unlike the earlier all-gather + bcast formulation); 6x6 normal equations
    psum-reduced, solve + Rodrigues replicated.  ``trace=True`` returns an
    ``ICPTrace`` with the per-iteration plane-residual errors (same
    observability contract as every other engine)."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from icp_tpu.engine.icp import ICPTrace
    from icp_tpu.ops.normals import estimate_normals
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import _pad_rows, _ring_correspond

    cfg = config or ICPConfig()
    mesh = mesh or make_mesh()
    if cfg.resolved_nn_method(
            n_points=max(len(model), len(scene))) == "grid":
        from icp_tpu.parallel.sharded_grid import gn_sharded_grid

        return gn_sharded_grid(
            model, scene, cfg, engine="point_to_plane",
            model_normals=normals, normal_k=normal_k, mesh=mesh,
            trace=trace,
        )
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    model_j = jnp.asarray(model, cfg.dtype)
    if normals is None:
        normals = estimate_normals(model_j, k=normal_k)
    normals_np = np.asarray(normals, np.dtype(cfg.dtype))
    model_np = np.asarray(model, np.dtype(cfg.dtype))
    scene_np = np.asarray(scene, np.dtype(cfg.dtype))
    n = scene_np.shape[0]

    scene_pad = _pad_rows(scene_np, n_dev, 0.0)
    model_pad = _pad_rows(model_np, n_dev, 1.0e17)
    normals_pad = _pad_rows(normals_np, n_dev, 0.0)
    mask = np.zeros((scene_pad.shape[0],), np.dtype(cfg.dtype))
    mask[:n] = 1.0

    shard = NamedSharding(mesh, PartitionSpec(axis, None))
    row = NamedSharding(mesh, PartitionSpec(axis))
    args = (
        jax.device_put(model_pad, shard),
        jax.device_put(normals_pad, shard),
        jax.device_put(scene_pad, shard),
        jax.device_put(mask, row),
    )

    max_iter = cfg.max_iter
    threshold = jnp.asarray(cfg.threshold, cfg.dtype)
    trim_fraction = cfg.trim_fraction
    nn_impl = "pallas" if cfg.resolved_nn_method() == "pallas" else "jnp"

    @functools.partial(jax.jit, static_argnames=())
    def run(m_loc, nrm_loc, p_loc, w_loc):
        def local(m_loc, nrm_loc, p_loc, w_loc):
            dt = p_loc.dtype

            def cond(carry):
                err, it = carry[2], carry[3]
                return jnp.logical_and(it < max_iter, err >= threshold)

            def body(carry):
                p, sim_tot, _, it = carry[:4]
                y, _, (nv,) = _ring_correspond(
                    p, m_loc, axis=axis, n_dev=n_dev, nn_impl=nn_impl,
                    payload=(nrm_loc,),
                )
                if trim_fraction > 0.0:
                    from icp_tpu.parallel.sharded import _distributed_quantile

                    d2 = jnp.sum((y - p) ** 2, axis=1)
                    tau = _distributed_quantile(
                        d2, w_loc, 1.0 - trim_fraction, axis
                    )
                    w_eff = w_loc * (d2 <= tau).astype(w_loc.dtype)
                else:
                    w_eff = w_loc
                r = jnp.sum(nv * (p - y), axis=1) * w_eff
                J = jnp.concatenate([jnp.cross(p, nv), nv], axis=1) * w_eff[:, None]
                A = jax.lax.psum(
                    jnp.einsum("ni,nj->ij", J, J,
                               precision=jax.lax.Precision.HIGHEST), axis)
                b = jax.lax.psum(
                    jnp.einsum("ni,n->i", J, r,
                               precision=jax.lax.Precision.HIGHEST), axis)
                x = -jnp.linalg.solve(A + 1e-9 * jnp.eye(6, dtype=dt), b)
                sim = Similarity(s=jnp.asarray(1.0, dt), R=_rodrigues(x[:3]), t=x[3:])
                p_new = apply_similarity(p, sim)
                nw = jax.lax.psum(jnp.sum(w_eff), axis)
                err = jax.lax.psum(
                    jnp.sum((jnp.sum(nv * (p_new - y), axis=1) * w_eff) ** 2), axis
                ) / nw
                out = (p_new, compose(sim_tot, sim), err, it + 1)
                if trace:
                    errs = jax.lax.dynamic_update_index_in_dim(
                        carry[4], err.astype(carry[4].dtype), it, 0
                    )
                    out = out + (errs,)
                return out

            init = (p_loc, identity_similarity(dt), jnp.asarray(jnp.inf, dt),
                    jnp.asarray(0, jnp.int32))
            if trace:
                init = init + (jnp.full((max_iter,), jnp.nan, dt),)
            return jax.lax.while_loop(cond, body, init)

        from jax.sharding import PartitionSpec as P

        out_specs = (P(axis, None), P(), P(), P()) + ((P(),) if trace else ())
        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
            out_specs=out_specs,
            check_vma=False,
        )(m_loc, nrm_loc, p_loc, w_loc)

    out = run(*args)
    p, sim_tot, err, it = out[:4]
    result = ICPResult(points=p[:n], transform=sim_tot, err=err, iters=it)
    return ICPTrace(result=result, errs=out[4]) if trace else result


def icp_point_to_plane(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    normals=None,
    normal_k: int = 16,
    init=None,
    trace: bool = False,
    scene_n=None,
    model_n=None,
):
    """Register ``scene`` onto ``model`` minimizing point-to-plane distance.

    ``normals``: optional precomputed (M, 3) model normals; estimated via
    kNN-PCA (``ops/normals.py``) if omitted.  Convergence threshold applies
    to the mean squared plane distance.  ``init``: optional warm-start
    ``Similarity`` (the returned transform still maps the caller's scene).

    ``scene_n`` / ``model_n``: dynamic valid-row counts for bucket-padded
    clouds (``ops/padding.py``) — pad rows must be FAR sentinels
    (``pad_to_bucket``) so the internal normal estimation stays exact for
    real rows; the engine replica-fills them before the hot loop and masks
    them out of every statistic.  One compiled program per bucket.
    """
    from icp_tpu.engine.icp import _cast_sim
    from icp_tpu.ops.normals import estimate_normals

    cfg = config or ICPConfig()
    model = jnp.asarray(model, cfg.dtype)
    scene = jnp.asarray(scene, cfg.dtype)
    _validate(model, scene, cfg)
    if normals is None:
        # estimated on the cloud AS GIVEN (sentinel pad rows are never among
        # the k nearest of a real row) — BEFORE the in-loop replica fill,
        # which would flood kNN neighborhoods near the last real point
        normals = estimate_normals(model, k=normal_k)
    else:
        normals = jnp.asarray(normals, cfg.dtype)
    if scene_n is not None:
        scene_n = jnp.asarray(scene_n, jnp.int32)
    if model_n is not None:
        model_n = jnp.asarray(model_n, jnp.int32)
    n_points = max(model.shape[0], scene.shape[0])
    if cfg.resolved_nn_method(n_points=n_points) == "grid":
        return _icp_p2pl_grid(
            model,
            normals,
            scene,
            jnp.asarray(cfg.threshold, cfg.dtype),
            max_iter=cfg.max_iter,
            scene_tile_target=cfg.grid_scene_tile,
            model_tile_target=cfg.grid_model_tile,
            max_candidates=cfg.grid_max_candidates,
            trim_fraction=cfg.trim_fraction,
            trace=trace,
            init_sim=None if init is None else _cast_sim(init, cfg.dtype),
            scene_n=scene_n,
            model_n=model_n,
        )
    return _icp_p2pl_while(
        model,
        normals,
        scene,
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
