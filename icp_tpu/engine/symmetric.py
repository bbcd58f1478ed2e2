"""Symmetric-objective ICP (Rusinkiewicz, SIGGRAPH 2019).

Minimizes ``sum_i [ (R p_i - R^-1 y_i + t) . (n_p_i + n_y_i) ]^2`` — the
residual is measured along the SUM of the two matched surface normals, and
the rotation is split symmetrically between both clouds.  Compared to
point-to-plane this is exact (zero residual) for any pair of points sampled
from the same locally-second-order surface, which widens the convergence
basin and gives quadratic convergence where p2pl is linear — at the cost of
needing normals for BOTH clouds.  No reference counterpart (the reference is
point-to-point only; SURVEY.md §2) — this extends the engine family the same
way point-to-plane/GICP do.

Structure (mirrors ``engine/point_to_plane.py``):
  * correspondence via the same dense NN paths;
  * scene normals are estimated ONCE and carried through the jitted
    ``while_loop``, rotated alongside the points (exact for rigid motion —
    no per-iteration re-estimation);
  * per-pair sign canonicalization ``n_y <- sign(n_p . n_y) n_y`` resolves
    the PCA normal sign ambiguity branch-free (a flipped sign would cancel
    the two normals instead of averaging them);
  * Gauss-Newton over ``x = [a, t]`` with ``J_i = [(p_i + y_i) x n_i, n_i]``
    — one fused einsum pass, 6x6 solve;
  * the incremental scene transform is ``p <- R_a (R_a p + t)`` (both
    half-rotations folded onto the scene so the model stays fixed), applied
    with the exact Rodrigues rotation.

Rigid (SE(3)) only, like point-to-plane.
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


def _sym_step(p, p_normals, model, model_normals, *, nn_method, scene_tile,
              model_tile, trim_fraction=0.0, damping=1e-9, scene_mask=None):
    """One symmetric GN step -> (p_new, n_new, sim, err)."""
    idx = closest_point_indices(
        p, model, method=nn_method, scene_tile=scene_tile, model_tile=model_tile
    )
    y = jnp.take(model, idx, axis=0)
    n_y = jnp.take(model_normals, idx, axis=0)

    # PCA normals carry an arbitrary sign; align each matched model normal
    # with the scene normal so the pair AVERAGES instead of cancelling.
    # sign(0) -> +1 keeps the op branch-free.
    flip = jnp.where(jnp.sum(p_normals * n_y, axis=1) < 0.0, -1.0, 1.0)
    n = p_normals + flip[:, None] * n_y  # (N, 3), unnormalized pair normal

    r = jnp.sum(n * (p - y), axis=1)  # (N,) symmetric plane residuals
    # linearization: r(a, t) ~ r + a.((p + y) x n) + t.n
    J = jnp.concatenate([jnp.cross(p + y, n), n], axis=1)  # (N, 6)
    # trim by euclidean correspondence distance (same robustness notion as
    # every other engine — the plane residual can be tiny for a gross
    # outlier sliding along a surface); bucket-padding mask folded in
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

    # objective transform is p -> R (R p + t): fold both half-rotations onto
    # the scene (R2 = R R, t2 = R t) so the model cloud stays fixed
    R = _rodrigues(x[:3])
    t = x[3:]
    R2 = jnp.matmul(R, R, precision=jax.lax.Precision.HIGHEST)
    t2 = jnp.matmul(R, t, precision=jax.lax.Precision.HIGHEST)
    sim = Similarity(s=jnp.asarray(1.0, p.dtype), R=R2, t=t2)
    p_new = apply_similarity(p, sim)
    n_new = jnp.matmul(p_normals, R2.T, precision=jax.lax.Precision.HIGHEST)  # normals co-rotate with the rigid motion

    res = jnp.sum(n * (p_new - y), axis=1)
    if w is not None:
        res = res * w
    err = jnp.sum(res ** 2) / n_eff
    return p_new, n_new, sim, err


@functools.partial(
    jax.jit,
    static_argnames=("max_iter", "nn_method", "scene_tile", "model_tile",
                     "trim_fraction", "trace"),
)
def _icp_sym_while(
    model,
    model_normals,
    scene,
    scene_normals,
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
        scene_normals = jnp.matmul(scene_normals, init_sim.R.T,
                                   precision=jax.lax.Precision.HIGHEST)

    def cond(carry):
        _, _, _, err, it, _ = carry
        return jnp.logical_and(it < max_iter, err >= threshold)

    def body(carry):
        p, nrm, sim_tot, _, it, errs = carry
        p_new, n_new, sim, err = _sym_step(
            p, nrm, model, model_normals, nn_method=nn_method,
            scene_tile=scene_tile, model_tile=model_tile,
            trim_fraction=trim_fraction, scene_mask=scene_mask,
        )
        if trace:
            errs = jax.lax.dynamic_update_index_in_dim(
                errs, err.astype(errs.dtype), it, 0
            )
        return p_new, n_new, compose(sim_tot, sim), err, it + 1, errs

    init = (
        scene,
        scene_normals,
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
                     "max_candidates", "trim_fraction", "trace"),
)
def _icp_sym_grid(
    model,
    model_normals,
    scene,
    scene_normals,
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
    """Grid-pruned symmetric loop (``nn_method="grid"``).

    Same kd-tile work-list pruning as ``engine/point_to_plane.py``'s grid
    path: the MODEL normals ride the grid as its payload and the winning
    (point, normal) pair is gathered by the kernel's index.  The
    SCENE normals never enter the fold at all — each row's own normal is
    local — they are kd-permuted once alongside the points (the ``perm``
    that ``_prepare_scene`` returns exists exactly for such side data) and
    rotated with the accumulated half-rotations inside the loop.  The
    culling bound is the euclidean residual (the plane residual does not
    bound the NN distance).
    """
    from icp_tpu.engine.grid import _prepare_scene
    from icp_tpu.kernels.nn_grid import (
        bound_from_indices,
        build_model_grid,
        closest_point_indices_grid,
        initial_bound_indices,
        next_bound,
    )
    from icp_tpu.ops.quantile import histogram_quantile

    dt = scene.dtype
    interp = kernel_interpret()
    from icp_tpu.engine.icp import _bucket_prologue

    model, scene, _ = _bucket_prologue(model, scene, scene_n, model_n)
    if init_sim is not None:
        scene = apply_similarity(scene, init_sim)
        scene_normals = jnp.matmul(scene_normals, init_sim.R.T,
                                   precision=jax.lax.Precision.HIGHEST)

    grid = build_model_grid(model, target_tile=model_tile_target,
                            payload=model_normals)
    p0, w, inv_slots, tn, perm = _prepare_scene(scene, scene_tile_target,
                                                n_valid=scene_n)
    n_pad = p0.shape[0] - scene.shape[0]
    sn_pad = jnp.concatenate(
        [scene_normals,
         jnp.broadcast_to(scene_normals[-1], (n_pad, 3)).astype(dt)], axis=0)
    pn0 = sn_pad[perm]
    stride = max(1, min(16, model.shape[0] // 4))
    idx0 = initial_bound_indices(p0, grid.model_orig, stride=stride,
                                 interpret=interp)
    u0 = bound_from_indices(p0, grid, idx0)

    def body(carry):
        p, pn, sim_tot, _, it, u, errs = carry
        _, y, nv, d2 = closest_point_indices_grid(
            p, grid, u, scene_tile=tn, max_candidates=max_candidates,
            interpret=interp,
        )
        y = y.astype(dt)
        nv = nv.astype(dt)
        flip = jnp.where(jnp.sum(pn * nv, axis=1) < 0.0, -1.0, 1.0)
        nsum = pn + flip[:, None] * nv
        if trim_fraction > 0.0:
            if dt != jnp.float32:
                d2 = jnp.sum((y - p) ** 2, axis=1)
            tau = histogram_quantile(d2, 1.0 - trim_fraction, w)
            w_eff = w * (d2 <= tau).astype(w.dtype)
        else:
            w_eff = w
        r = jnp.sum(nsum * (p - y), axis=1) * w_eff
        J = jnp.concatenate(
            [jnp.cross(p + y, nsum), nsum], axis=1) * w_eff[:, None]
        A = jnp.einsum("ni,nj->ij", J, J, precision=jax.lax.Precision.HIGHEST)
        b = jnp.einsum("ni,n->i", J, r, precision=jax.lax.Precision.HIGHEST)
        x = -jnp.linalg.solve(A + 1e-9 * jnp.eye(6, dtype=dt), b)
        R = _rodrigues(x[:3])
        R2 = jnp.matmul(R, R, precision=jax.lax.Precision.HIGHEST)
        sim = Similarity(s=jnp.asarray(1.0, dt), R=R2,
                         t=jnp.matmul(R, x[3:], precision=jax.lax.Precision.HIGHEST))
        p_new = apply_similarity(p, sim)
        pn_new = jnp.matmul(pn, R2.T, precision=jax.lax.Precision.HIGHEST)
        err = jnp.sum(
            (jnp.sum(nsum * (p_new - y), axis=1) * w_eff) ** 2
        ) / jnp.sum(w_eff)
        u_next = next_bound(y, p_new)
        if trace:
            errs = jax.lax.dynamic_update_index_in_dim(
                errs, err.astype(errs.dtype), it, 0
            )
        return p_new, pn_new, compose(sim_tot, sim), err, it + 1, u_next, errs

    init = (
        p0,
        pn0,
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


def icp_symmetric_sharded(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    normals=None,
    scene_normals=None,
    normal_k: int = 16,
    mesh=None,
    trace: bool = False,
):
    """Multi-chip symmetric ICP: scene AND model sharded over the points
    mesh.  Model normals ride the ``ppermute`` ring as payload exactly like
    the sharded point-to-plane engine (the winning normal is gathered during
    the fold); scene normals are estimated once up-front, sharded WITH the
    scene rows, and rotated alongside them inside the loop — no second ring
    is needed because each scene point's own normal is always local.  The
    6x6 normal equations are psum-reduced; solve + Rodrigues replicated.
    A ``grid`` NN request dispatches to the sharded kd-tile work-list loop
    (``parallel/sharded_grid.gn_sharded_grid``), same as point-to-plane and
    GICP."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from icp_tpu.engine.icp import ICPTrace
    from icp_tpu.ops.normals import estimate_normals
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import _pad_rows, _ring_correspond

    cfg = config or ICPConfig()
    if cfg.resolved_nn_method(
            n_points=max(len(model), len(scene))) == "grid":
        from icp_tpu.parallel.sharded_grid import gn_sharded_grid

        return gn_sharded_grid(
            model, scene, cfg, engine="symmetric", model_normals=normals,
            scene_normals=scene_normals, normal_k=normal_k, mesh=mesh,
            trace=trace,
        )
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    model_j = jnp.asarray(model, cfg.dtype)
    scene_j = jnp.asarray(scene, cfg.dtype)
    _validate(model_j, scene_j, cfg)
    if normals is None:
        normals = estimate_normals(model_j, k=normal_k)
    if scene_normals is None:
        scene_normals = estimate_normals(scene_j, k=normal_k)
    model_np = np.asarray(model_j, np.dtype(cfg.dtype))
    scene_np = np.asarray(scene_j, np.dtype(cfg.dtype))
    normals_np = np.asarray(normals, np.dtype(cfg.dtype))
    snormals_np = np.asarray(scene_normals, np.dtype(cfg.dtype))
    n = scene_np.shape[0]

    scene_pad = _pad_rows(scene_np, n_dev, 0.0)
    snormals_pad = _pad_rows(snormals_np, n_dev, 0.0)
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
        jax.device_put(snormals_pad, shard),
        jax.device_put(mask, row),
    )

    max_iter = cfg.max_iter
    threshold = jnp.asarray(cfg.threshold, cfg.dtype)
    trim_fraction = cfg.trim_fraction
    nn_impl = "pallas" if cfg.resolved_nn_method() == "pallas" else "jnp"

    @jax.jit
    def run(m_loc, nrm_loc, p_loc, pn_loc, w_loc):
        def local(m_loc, nrm_loc, p_loc, pn_loc, w_loc):
            dt = p_loc.dtype

            def cond(carry):
                err, it = carry[3], carry[4]
                return jnp.logical_and(it < max_iter, err >= threshold)

            def body(carry):
                p, pn, sim_tot, _, it = carry[:5]
                y, _, (nv,) = _ring_correspond(
                    p, m_loc, axis=axis, n_dev=n_dev, nn_impl=nn_impl,
                    payload=(nrm_loc,),
                )
                flip = jnp.where(jnp.sum(pn * nv, axis=1) < 0.0, -1.0, 1.0)
                nsum = pn + flip[:, None] * nv
                if trim_fraction > 0.0:
                    from icp_tpu.parallel.sharded import _distributed_quantile

                    d2 = jnp.sum((y - p) ** 2, axis=1)
                    tau = _distributed_quantile(
                        d2, w_loc, 1.0 - trim_fraction, axis
                    )
                    w_eff = w_loc * (d2 <= tau).astype(w_loc.dtype)
                else:
                    w_eff = w_loc
                r = jnp.sum(nsum * (p - y), axis=1) * w_eff
                J = jnp.concatenate(
                    [jnp.cross(p + y, nsum), nsum], axis=1
                ) * w_eff[:, None]
                A = jax.lax.psum(
                    jnp.einsum("ni,nj->ij", J, J,
                               precision=jax.lax.Precision.HIGHEST), axis)
                b = jax.lax.psum(
                    jnp.einsum("ni,n->i", J, r,
                               precision=jax.lax.Precision.HIGHEST), axis)
                x = -jnp.linalg.solve(A + 1e-9 * jnp.eye(6, dtype=dt), b)
                R = _rodrigues(x[:3])
                R2 = jnp.matmul(R, R, precision=jax.lax.Precision.HIGHEST)
                sim = Similarity(s=jnp.asarray(1.0, dt), R=R2,
                         t=jnp.matmul(R, x[3:], precision=jax.lax.Precision.HIGHEST))
                p_new = apply_similarity(p, sim)
                pn_new = jnp.matmul(pn, R2.T, precision=jax.lax.Precision.HIGHEST)
                nw = jax.lax.psum(jnp.sum(w_eff), axis)
                err = jax.lax.psum(
                    jnp.sum((jnp.sum(nsum * (p_new - y), axis=1) * w_eff) ** 2),
                    axis,
                ) / nw
                out = (p_new, pn_new, compose(sim_tot, sim), err, it + 1)
                if trace:
                    errs = jax.lax.dynamic_update_index_in_dim(
                        carry[5], err.astype(carry[5].dtype), it, 0
                    )
                    out = out + (errs,)
                return out

            init = (p_loc, pn_loc, identity_similarity(dt),
                    jnp.asarray(jnp.inf, dt), jnp.asarray(0, jnp.int32))
            if trace:
                init = init + (jnp.full((max_iter,), jnp.nan, dt),)
            return jax.lax.while_loop(cond, body, init)

        from jax.sharding import PartitionSpec as P

        out_specs = (P(axis, None), P(axis, None), P(), P(), P()) + (
            (P(),) if trace else ()
        )
        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis, None),
                      P(axis, None), P(axis)),
            out_specs=out_specs,
            check_vma=False,
        )(m_loc, nrm_loc, p_loc, pn_loc, w_loc)

    out = run(*args)
    p, _, sim_tot, err, it = out[:5]
    result = ICPResult(points=p[:n], transform=sim_tot, err=err, iters=it)
    return ICPTrace(result=result, errs=out[5]) if trace else result


def icp_symmetric(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    normals=None,
    scene_normals=None,
    normal_k: int = 16,
    init=None,
    trace: bool = False,
    scene_n=None,
    model_n=None,
):
    """Register ``scene`` onto ``model`` with the symmetric plane objective.

    ``normals`` / ``scene_normals``: optional precomputed (M, 3) / (N, 3)
    unit normals; estimated via kNN-PCA (``ops/normals.py``) if omitted.
    Convergence threshold applies to the mean squared symmetric residual
    (note: ``n_p + n_y`` has magnitude ~2 for agreeing normals, so this
    metric sits ~4x the p2pl plane MSE on the same alignment).  ``init``:
    optional warm-start ``Similarity`` (rotation part must be a pure
    rotation; the returned transform still maps the caller's scene).

    All NN methods are supported: dense (``bcast``/``matmul``/``blocked``/
    ``pallas``, passed through to ``closest_point_indices`` like every
    other engine), and the kd-tile ``grid`` path (``_icp_sym_grid`` — model
    normals ride the tile payload rows, scene normals are kd-permuted side
    data).

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
    # normals estimated on the clouds AS GIVEN (sentinel pad rows never
    # enter a real row's kNN) — before the engines' in-loop replica fill
    if normals is None:
        normals = estimate_normals(model, k=normal_k)
    else:
        normals = jnp.asarray(normals, cfg.dtype)
    if scene_normals is None:
        scene_normals = estimate_normals(scene, k=normal_k)
    else:
        scene_normals = jnp.asarray(scene_normals, cfg.dtype)
    nn_method = cfg.resolved_nn_method(
        n_points=max(model.shape[0], scene.shape[0]))
    if scene_n is not None:
        scene_n = jnp.asarray(scene_n, jnp.int32)
    if model_n is not None:
        model_n = jnp.asarray(model_n, jnp.int32)
    if nn_method == "grid":
        return _icp_sym_grid(
            model,
            normals,
            scene,
            scene_normals,
            jnp.asarray(cfg.threshold, cfg.dtype),
            max_iter=cfg.max_iter,
            scene_tile_target=cfg.grid_scene_tile,
            model_tile_target=cfg.grid_model_tile,
            max_candidates=cfg.grid_max_candidates,
            trim_fraction=cfg.trim_fraction,
            trace=trace,
            init_sim=_cast_sim(init, cfg.dtype) if init is not None else None,
            scene_n=scene_n,
            model_n=model_n,
        )
    return _icp_sym_while(
        model,
        normals,
        scene,
        scene_normals,
        jnp.asarray(cfg.threshold, cfg.dtype),
        max_iter=cfg.max_iter,
        nn_method=nn_method,
        scene_tile=cfg.scene_tile,
        model_tile=cfg.model_tile,
        trim_fraction=cfg.trim_fraction,
        trace=trace,
        init_sim=_cast_sim(init, cfg.dtype) if init is not None else None,
        scene_n=scene_n,
        model_n=model_n,
    )
