"""Sharded spatially-pruned ICP: ring fold + per-shard kd-tile culling.

The at-scale composition of the two round-2 engines: ``parallel/sharded.py``'s
ring ``ppermute`` fold (model shards travel the ring, scene stays put)
with ``kernels/nn_grid.py``'s exact tile culling (kd tiles + upper-bound
pruning + work-list kernel) applied per hop:

  * each device kd-sorts ITS scene shard once and builds a ``ModelGrid`` over
    ITS model shard once; the grid's arrays (transposed tiles, bboxes,
    original-order points) ride the ring as the fold payload;
  * on every hop, the visiting shard's tiles are culled against
    ``min(best_d, u)`` — the running cross-shard best distance *tightens the
    bound hop by hop*, so later hops cull almost everything (strictly more
    pruning than the single-device engine gets);
  * cross-shard ties break to the lowest GLOBAL original index, exactly like
    the dense sharded engine: the pruned kernel and its overflow path
    compute distances with the same broadcast diff-squares f32 math, so
    equality comparisons are bitwise meaningful across hops;
  * the loop carry holds ``u`` — the previous iteration's residual
    ``||y - p_new||^2``, a valid upper bound on the new NN distance (same
    gather-free trick as ``engine/grid.py``).

No reference counterpart (the reference is single-GPU brute force,
``src/GPU/compute.cu:94-245``); this is the framework's own at-scale story:
1M-point clouds sharded over a multi-GPU host at grid-pruned cost, with no
O(N_loc x M) buffer anywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from icp_tpu.config import ICPConfig, kernel_interpret
from icp_tpu.engine.icp import ICPResult, ICPTrace
from icp_tpu.kernels.nn_grid import (
    ModelGrid,
    _round_up,
    bound_from_indices,
    build_model_grid,
    closest_point_indices_grid,
    initial_bound_indices,
    kd_order,
    levels_for,
    next_bound,
)
from icp_tpu.ops.alignment import alignment_from_stats
from icp_tpu.ops.transform import apply_similarity, compose, identity_similarity
from icp_tpu.parallel.mesh import make_mesh
from icp_tpu.parallel.sharded import (
    _check_trace_bound,
    _distributed_quantile,
    _masked_stats,
    _pad_rows,
    _unpad_result,
)

_BIG = 3.0e38


def _prepare_scene_shard(p_loc, w_loc, target_tile: int):
    """kd-sort + pad ONE device's scene rows; returns
    (p_sorted, w_sorted, inv_slots, tn, perm).

    ``w_loc`` marks globally-real rows (global padding lands on the last
    shard); kd padding replicates the last row with weight 0.  Real rows sort
    compactly (padding to segment tails), keeping scene tiles tight.
    ``perm`` maps sorted slots to padded local rows (for permuting per-point
    side data such as GICP covariances alongside the points).
    """
    n = p_loc.shape[0]
    lvl = levels_for(n, target_tile)
    tn = _round_up(-(-n // (2**lvl)), 8)
    n_pad = tn * (2**lvl)
    pad = jnp.broadcast_to(p_loc[-1], (n_pad - n, 3)).astype(p_loc.dtype)
    p_pad = jnp.concatenate([p_loc, pad], axis=0)
    w_pad = jnp.concatenate([w_loc, jnp.zeros((n_pad - n,), w_loc.dtype)])
    perm = kd_order(p_pad, lvl, real=w_pad > 0)
    inv_slots = jnp.argsort(perm)[:n]
    return p_pad[perm], w_pad[perm], inv_slots, tn, perm


def _ring_correspond_grid(p_loc, u, grid_arrays, *, tm: int, axis: str,
                          n_dev: int, m_shard: int, scene_tile: int,
                          max_candidates: int, interpret: bool,
                          payload_dim: int = 0):
    """Grid-pruned ring NN fold.
    Returns (y, global index, best distance[, winning payload]).

    ``u``: (N_loc,) f32 upper bounds on the GLOBAL NN distance (previous
    iteration's residual, or the first-iteration local-shard bound — local
    distances bound the global minimum from above).  ``grid_arrays``: the
    ModelGrid array fields of THIS device's shard; they rotate around the
    ring (``model_tile`` stays static and is passed as ``tm``).

    ``payload_dim`` > 0: the grids were built with an (M, payload_dim)
    payload packed in the spare tile rows (e.g. normals for point-to-plane /
    GICP); the winning payload rows ride the fold carry, so the sharded
    payload engines stay gather-free too.
    """
    my = jax.lax.axis_index(axis).astype(jnp.int32)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    n_loc = p_loc.shape[0]

    def hop(k, carry):
        best_d, best_gi, best_y, best_pl, tiles_t, tile_lo, tile_hi, \
            m_orig, pl_orig = carry
        src = jax.lax.rem(
            my - k.astype(jnp.int32) + jnp.int32(n_dev), jnp.int32(n_dev)
        )
        g = ModelGrid(tiles_t=tiles_t, tile_lo=tile_lo, tile_hi=tile_hi,
                      model_orig=m_orig, model_tile=tm,
                      payload_orig=pl_orig if payload_dim else None)
        # cull bound: both the cross-hop running best and the caller's bound
        # are achieved distances to real model points — exact upper bounds.
        idx, y, pl, d2 = closest_point_indices_grid(
            p_loc, g, jnp.minimum(best_d, u), scene_tile=scene_tile,
            max_candidates=max_candidates, interpret=interpret,
        )
        gi = idx + src * m_shard
        better = jnp.logical_or(
            d2 < best_d, jnp.logical_and(d2 == best_d, gi < best_gi)
        )
        best_d = jnp.where(better, d2, best_d)
        best_gi = jnp.where(better, gi, best_gi)
        best_y = jnp.where(better[:, None], y, best_y)
        if payload_dim:
            best_pl = jnp.where(better[:, None], pl, best_pl)
        tiles_t = jax.lax.ppermute(tiles_t, axis, perm)
        tile_lo = jax.lax.ppermute(tile_lo, axis, perm)
        tile_hi = jax.lax.ppermute(tile_hi, axis, perm)
        m_orig = jax.lax.ppermute(m_orig, axis, perm)
        if payload_dim:
            pl_orig = jax.lax.ppermute(pl_orig, axis, perm)
        return (best_d, best_gi, best_y, best_pl, tiles_t, tile_lo,
                tile_hi, m_orig, pl_orig)

    init = (
        jnp.full((n_loc,), _BIG, jnp.float32),
        jnp.full((n_loc,), 2**31 - 1, jnp.int32),
        jnp.zeros((n_loc, 3), jnp.float32),
        jnp.zeros((n_loc, payload_dim), jnp.float32) if payload_dim else 0,
    ) + grid_arrays
    best_d, best_gi, best_y, best_pl, *_ = jax.lax.fori_loop(
        0, n_dev, hop, init
    )
    if payload_dim:
        return best_y, best_gi, best_d, best_pl
    return best_y, best_gi, best_d


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "max_iter",
        "solver",
        "with_scale",
        "reference_compat",
        "trim_fraction",
        "scene_tile_target",
        "model_tile_target",
        "max_candidates",
        "bound_stride",
        "trace",
    ),
)
def _icp_sharded_grid_jit(
    model_pad,
    scene_pad,
    scene_mask,
    threshold,
    n_iters=None,  # dynamic iteration bound; None -> the static max_iter
    *,
    mesh: Mesh,
    max_iter: int,
    solver: str,
    with_scale: bool,
    reference_compat: bool,
    trim_fraction: float = 0.0,
    scene_tile_target: int = 256,
    model_tile_target: int = 1024,
    max_candidates: int = 16,
    bound_stride: int = 16,
    trace: bool = False,
):
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    dt = scene_pad.dtype
    m_shard = model_pad.shape[0] // n_dev
    interp = kernel_interpret()
    bound = jnp.asarray(max_iter if n_iters is None else n_iters, jnp.int32)

    def local_icp(m_loc, p_loc_raw, w_loc_raw, bound):
        # One-time per-shard setup (hoisted out of the loop by XLA): local
        # model grid, local scene kd sort, first-iteration bounds from a
        # strided subsample of the LOCAL shard (local distances bound the
        # global NN from above — no collective needed).
        grid = build_model_grid(m_loc, target_tile=model_tile_target)
        # 5th slot = payload arrays (0 placeholder without payload)
        grid_arrays = (grid.tiles_t, grid.tile_lo, grid.tile_hi,
                       grid.model_orig, 0)
        p0, w_loc, inv_slots, tn, _ = _prepare_scene_shard(
            p_loc_raw, w_loc_raw, scene_tile_target
        )
        stride = max(1, min(bound_stride, m_shard // 4))
        idx0 = initial_bound_indices(p0, grid.model_orig, stride=stride,
                                     interpret=interp)
        u0 = bound_from_indices(p0, grid, idx0)

        def step(p, sim_tot, it, u):
            y, _, d2 = _ring_correspond_grid(
                p, u, grid_arrays, tm=grid.model_tile, axis=axis,
                n_dev=n_dev, m_shard=m_shard, scene_tile=tn,
                max_candidates=max_candidates, interpret=interp,
            )
            y = y.astype(dt)
            if trim_fraction > 0.0:
                tau = _distributed_quantile(
                    d2.astype(dt), w_loc, 1.0 - trim_fraction, axis
                )
                w_eff = w_loc * (d2.astype(dt) <= tau).astype(w_loc.dtype)
            else:
                w_eff = w_loc
            stats = _masked_stats(p, y, w_eff, axis)
            sim = alignment_from_stats(stats, solver=solver,
                                       with_scale=with_scale)
            p_new = apply_similarity(p, sim)
            derr = y - p_new
            d2_new = jnp.sum(derr * derr, axis=1)
            err_sum = jax.lax.psum(jnp.sum(w_eff * d2_new), axis)
            err = (2.0 * err_sum / stats.n) if reference_compat else (
                err_sum / stats.n
            )
            # next iteration's culling bound: residual to this iteration's
            # match (a model point) — gather-free, same as engine/grid.py
            return p_new, compose(sim_tot, sim), err, it + 1, \
                next_bound(y, p_new)

        init = (
            p0,
            identity_similarity(dt),
            jnp.asarray(jnp.inf, dt),
            jnp.asarray(0, jnp.int32),
            u0,
        )

        if trace:
            # early-exiting while_loop + error buffer (see parallel/sharded.py)
            def cond_t(carry):
                _, _, err, it, _, _ = carry
                return jnp.logical_and(it < bound, err >= threshold)

            def body_t(carry):
                p, sim_tot, _, it, u, errs = carry
                p2, sim2, err2, it2, u2 = step(p, sim_tot, it, u)
                errs = jax.lax.dynamic_update_index_in_dim(
                    errs, err2.astype(errs.dtype), it, 0
                )
                return p2, sim2, err2, it2, u2, errs

            p, sim_tot, err, it, _, errs = jax.lax.while_loop(
                cond_t, body_t, init + (jnp.full((max_iter,), jnp.nan, dt),)
            )
            return p[inv_slots], sim_tot, err, it, errs

        def cond(carry):
            _, _, err, it, _ = carry
            return jnp.logical_and(it < bound, err >= threshold)

        def body(carry):
            p, sim_tot, _, it, u = carry
            return step(p, sim_tot, it, u)

        p, sim_tot, err, it, _ = jax.lax.while_loop(cond, body, init)
        return p[inv_slots], sim_tot, err, it

    shard = PartitionSpec(axis, None)
    mask_spec = PartitionSpec(axis)
    rep = PartitionSpec()
    out_specs = (shard, rep, rep, rep) + ((rep,) if trace else ())
    out = jax.shard_map(
        local_icp,
        mesh=mesh,
        in_specs=(shard, shard, mask_spec, rep),
        out_specs=out_specs,
        check_vma=False,
    )(model_pad, scene_pad, scene_mask, bound)
    if trace:
        p, sim_tot, err, it, errs = out
        return ICPTrace(
            result=ICPResult(points=p, transform=sim_tot, err=err, iters=it),
            errs=errs,
        )
    p, sim_tot, err, it = out
    return ICPResult(points=p, transform=sim_tot, err=err, iters=it)


def icp_sharded_grid(
    model,
    scene,
    config: ICPConfig | None = None,
    *,
    mesh: Mesh | None = None,
    trace: bool = False,
    n_iters=None,
):
    """Multi-device spatially-pruned ICP over a ``points`` mesh.

    API-compatible with ``icp_sharded`` (``icp_sharded(nn_method="grid")``
    dispatches here).  Model padding uses the 1e17 sentinel: pad rows form
    far-away kd tiles whose bbox distance culls them out of every candidate
    list, and their huge distances keep them out of every fold.
    """
    cfg = config or ICPConfig()
    _check_trace_bound(trace, n_iters, cfg.max_iter)
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    dtype = np.dtype(cfg.dtype)
    model_np = np.asarray(model, dtype)
    scene_np = np.asarray(scene, dtype)
    n = scene_np.shape[0]

    scene_pad = _pad_rows(scene_np, n_dev, 0.0)
    model_pad = _pad_rows(model_np, n_dev, 1.0e17)
    mask = np.zeros((scene_pad.shape[0],), dtype)
    mask[:n] = 1.0

    shard = NamedSharding(mesh, PartitionSpec(axis, None))
    mask_shard = NamedSharding(mesh, PartitionSpec(axis))
    out = _icp_sharded_grid_jit(
        jax.device_put(model_pad, shard),
        jax.device_put(scene_pad, shard),
        jax.device_put(mask, mask_shard),
        jnp.asarray(cfg.threshold, cfg.dtype),
        None if n_iters is None else jnp.asarray(n_iters, jnp.int32),
        mesh=mesh,
        max_iter=cfg.max_iter,
        solver=cfg.resolved_solver(),
        with_scale=cfg.with_scale,
        reference_compat=cfg.reference_compat,
        trim_fraction=cfg.trim_fraction,
        scene_tile_target=cfg.grid_scene_tile,
        model_tile_target=cfg.grid_model_tile,
        max_candidates=cfg.grid_max_candidates,
        trace=trace,
    )
    return _unpad_result(out, n, trace)


# ---------------------------------------------------------------------------
# Sharded grid-pruned Gauss-Newton engines: point-to-plane and GICP
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "engine", "max_iter", "trim_fraction", "eps",
        "scene_tile_target", "model_tile_target", "max_candidates", "trace",
    ),
)
def _gn_sharded_grid_jit(
    model_pad,
    normals_pad,
    scene_pad,
    covs_pad,  # per-scene-point side data: (N_pad, 3, 3) covariances (GICP),
    #            (N_pad, 3) scene normals (symmetric), or a 0 placeholder
    scene_mask,
    threshold,
    *,
    mesh: Mesh,
    engine: str,  # "point_to_plane" | "gicp" | "symmetric"
    max_iter: int,
    trim_fraction: float = 0.0,
    eps: float = 1e-3,
    scene_tile_target: int = 256,
    model_tile_target: int = 1024,
    max_candidates: int = 16,
    trace: bool = False,
):
    """Sharded grid-pruned GN loop shared by point-to-plane and GICP.

    Model normals ride each shard's grid as payload and the whole grid
    rotates around the ring; the winning (point, normal) pair comes out of
    the fold carry, like the single-device grid engines.  GICP recomputes the model covariance from the emitted normal
    (``disk_covariances`` is a pure function of it) and rotates the local
    scene covariances with each step.  6x6 normal equations psum-reduced;
    solve + Rodrigues replicated.
    """
    from icp_tpu.engine.gicp import _gicp_system, disk_covariances
    from icp_tpu.engine.point_to_plane import _rodrigues
    from icp_tpu.ops.alignment import Similarity

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    dt = scene_pad.dtype
    m_shard = model_pad.shape[0] // n_dev
    interp = kernel_interpret()
    gicp = engine == "gicp"
    sym = engine == "symmetric"

    def local_icp(m_loc, nrm_loc, p_loc_raw, cov_loc_raw, w_loc_raw):
        grid = build_model_grid(m_loc, target_tile=model_tile_target,
                                payload=nrm_loc)
        grid_arrays = (grid.tiles_t, grid.tile_lo, grid.tile_hi,
                       grid.model_orig, grid.payload_orig)
        p0, w_loc, inv_slots, tn, perm = _prepare_scene_shard(
            p_loc_raw, w_loc_raw, scene_tile_target
        )
        if gicp:
            # kd-permute the local scene covariances alongside the points;
            # kd padding rows get identity (inert: weight 0)
            n_loc = p_loc_raw.shape[0]
            n_pad_loc = p0.shape[0]
            eye_pad = jnp.broadcast_to(
                jnp.eye(3, dtype=dt), (n_pad_loc - n_loc, 3, 3)
            )
            cov0 = jnp.concatenate([cov_loc_raw, eye_pad], axis=0)[perm]
        elif sym:
            # kd-permute the local SCENE normals alongside the points — the
            # symmetric objective's per-row side data (they never enter the
            # ring fold; inert zero rows for kd padding, weight 0 anyway)
            n_loc = p_loc_raw.shape[0]
            zpad = jnp.zeros((p0.shape[0] - n_loc, 3), dt)
            cov0 = jnp.concatenate([cov_loc_raw, zpad], axis=0)[perm]
        else:
            cov0 = 0
        stride = max(1, min(16, m_shard // 4))
        idx0 = initial_bound_indices(p0, grid.model_orig, stride=stride,
                                     interpret=interp)
        u0 = bound_from_indices(p0, grid, idx0)

        def step(p, cov_p, sim_tot, it, u):
            y, _, d2, nv = _ring_correspond_grid(
                p, u, grid_arrays, tm=grid.model_tile, axis=axis,
                n_dev=n_dev, m_shard=m_shard, scene_tile=tn,
                max_candidates=max_candidates, interpret=interp,
                payload_dim=3,
            )
            y = y.astype(dt)
            nv = nv.astype(dt)
            if trim_fraction > 0.0:
                tau = _distributed_quantile(
                    d2.astype(dt), w_loc, 1.0 - trim_fraction, axis
                )
                w_eff = w_loc * (d2.astype(dt) <= tau).astype(w_loc.dtype)
            else:
                w_eff = w_loc
            if gicp:
                Cy = disk_covariances(nv, eps)
                sim, p_new, err = _gicp_system(
                    p, y, Cy, cov_p, weights=w_eff, axis=axis
                )
                cov_p = jnp.einsum(
                    "ij,njk,lk->nil", sim.R, cov_p, sim.R,
                    precision=jax.lax.Precision.HIGHEST,
                )
            elif sym:
                # symmetric plane objective (engine/symmetric.py): residual
                # along the sign-canonicalized normal SUM, J about p + y,
                # both half-rotations folded onto the scene
                HI = jax.lax.Precision.HIGHEST
                pn = cov_p
                flip = jnp.where(jnp.sum(pn * nv, axis=1) < 0.0, -1.0, 1.0)
                nsum = pn + flip[:, None] * nv
                r = jnp.sum(nsum * (p - y), axis=1) * w_eff
                J = jnp.concatenate(
                    [jnp.cross(p + y, nsum), nsum], axis=1
                ) * w_eff[:, None]
                A = jax.lax.psum(
                    jnp.einsum("ni,nj->ij", J, J, precision=HI), axis)
                b = jax.lax.psum(
                    jnp.einsum("ni,n->i", J, r, precision=HI), axis)
                x = -jnp.linalg.solve(A + 1e-9 * jnp.eye(6, dtype=dt), b)
                R = _rodrigues(x[:3])
                R2 = jnp.matmul(R, R, precision=HI)
                sim = Similarity(s=jnp.asarray(1.0, dt), R=R2,
                                 t=jnp.matmul(R, x[3:], precision=HI))
                p_new = apply_similarity(p, sim)
                cov_p = jnp.matmul(pn, R2.T, precision=HI)
                nw = jax.lax.psum(jnp.sum(w_eff), axis)
                err = jax.lax.psum(
                    jnp.sum((jnp.sum(nsum * (p_new - y), axis=1)
                             * w_eff) ** 2), axis
                ) / nw
            else:
                r = jnp.sum(nv * (p - y), axis=1) * w_eff
                J = jnp.concatenate(
                    [jnp.cross(p, nv), nv], axis=1
                ) * w_eff[:, None]
                HI = jax.lax.Precision.HIGHEST
                A = jax.lax.psum(
                    jnp.einsum("ni,nj->ij", J, J, precision=HI), axis)
                b = jax.lax.psum(
                    jnp.einsum("ni,n->i", J, r, precision=HI), axis)
                x = -jnp.linalg.solve(A + 1e-9 * jnp.eye(6, dtype=dt), b)
                sim = Similarity(s=jnp.asarray(1.0, dt),
                                 R=_rodrigues(x[:3]), t=x[3:])
                p_new = apply_similarity(p, sim)
                nw = jax.lax.psum(jnp.sum(w_eff), axis)
                err = jax.lax.psum(
                    jnp.sum((jnp.sum(nv * (p_new - y), axis=1)
                             * w_eff) ** 2), axis
                ) / nw
            u_next = next_bound(y, p_new)
            return p_new, cov_p, compose(sim_tot, sim), err, it + 1, u_next

        def cond(carry):
            err, it = carry[3], carry[4]
            return jnp.logical_and(it < max_iter, err >= threshold)

        def body(carry):
            p, cov_p, sim_tot, _, it, u = carry[:6]
            out = step(p, cov_p, sim_tot, it, u)
            if trace:
                errs = jax.lax.dynamic_update_index_in_dim(
                    carry[6], out[3].astype(carry[6].dtype), it, 0
                )
                out = out + (errs,)
            return out

        init = (
            p0,
            cov0,
            identity_similarity(dt),
            jnp.asarray(jnp.inf, dt),
            jnp.asarray(0, jnp.int32),
            u0,
        )
        if trace:
            init = init + (jnp.full((max_iter,), jnp.nan, dt),)
        out = jax.lax.while_loop(cond, body, init)
        p, _, sim_tot, err, it = out[:5]
        return (p[inv_slots], sim_tot, err, it) + ((out[6],) if trace else ())

    shard = PartitionSpec(axis, None)
    cov_spec = (PartitionSpec(axis, None, None) if gicp
                else shard if sym else PartitionSpec())
    rep = PartitionSpec()
    out = jax.shard_map(
        local_icp,
        mesh=mesh,
        in_specs=(shard, shard, shard, cov_spec, PartitionSpec(axis)),
        out_specs=(shard, rep, rep, rep) + ((rep,) if trace else ()),
        check_vma=False,
    )(model_pad, normals_pad, scene_pad, covs_pad, scene_mask)
    p, sim_tot, err, it = out[:4]
    result = ICPResult(points=p, transform=sim_tot, err=err, iters=it)
    return ICPTrace(result=result, errs=out[4]) if trace else result


def gn_sharded_grid(
    model,
    scene,
    config: ICPConfig | None = None,
    *,
    engine: str,
    model_normals=None,
    scene_normals=None,
    normal_k: int = 16,
    eps: float = 1e-3,
    mesh: Mesh | None = None,
    trace: bool = False,
):
    """Sharded grid-pruned point-to-plane / GICP / symmetric entry
    (dispatched from ``icp_point_to_plane_sharded`` /
    ``icp_generalized_sharded`` / ``icp_symmetric_sharded`` when the NN
    method resolves to ``"grid"``).  ``trace=True`` returns an ``ICPTrace``
    with the per-iteration error sequence."""
    from icp_tpu.engine.gicp import disk_covariances
    from icp_tpu.ops.normals import estimate_normals

    cfg = config or ICPConfig()
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    gicp = engine == "gicp"
    sym = engine == "symmetric"

    model_j = jnp.asarray(model, cfg.dtype)
    if model_normals is None:
        model_normals = estimate_normals(model_j, k=normal_k)
    dtype = np.dtype(cfg.dtype)
    model_np = np.asarray(model, dtype)
    scene_np = np.asarray(scene, dtype)
    normals_np = np.asarray(model_normals, np.float32)
    n = scene_np.shape[0]

    scene_pad = _pad_rows(scene_np, n_dev, 0.0)
    model_pad = _pad_rows(model_np, n_dev, 1.0e17)
    normals_pad = _pad_rows(normals_np, n_dev, 0.0)
    mask = np.zeros((scene_pad.shape[0],), dtype)
    mask[:n] = 1.0

    if gicp:
        if scene_normals is None:
            scene_normals = estimate_normals(
                jnp.asarray(scene, cfg.dtype), k=normal_k
            )
        cov_s = np.asarray(
            disk_covariances(jnp.asarray(scene_normals, cfg.dtype), eps),
            dtype,
        )
        n_extra = scene_pad.shape[0] - n
        covs_pad = cov_s if n_extra == 0 else np.concatenate(
            [cov_s,
             np.broadcast_to(np.eye(3, dtype=dtype), (n_extra, 3, 3))],
            axis=0,
        )
    elif sym:
        if scene_normals is None:
            scene_normals = estimate_normals(
                jnp.asarray(scene, cfg.dtype), k=normal_k
            )
        covs_pad = _pad_rows(np.asarray(scene_normals, dtype), n_dev, 0.0)
    else:
        covs_pad = np.zeros((), dtype)

    shard = NamedSharding(mesh, PartitionSpec(axis, None))
    row = NamedSharding(mesh, PartitionSpec(axis))
    cov_sh = (NamedSharding(mesh, PartitionSpec(axis, None, None)) if gicp
              else shard if sym else NamedSharding(mesh, PartitionSpec()))
    out = _gn_sharded_grid_jit(
        jax.device_put(model_pad, shard),
        jax.device_put(normals_pad, shard),
        jax.device_put(scene_pad, shard),
        jax.device_put(covs_pad, cov_sh),
        jax.device_put(mask, row),
        jnp.asarray(cfg.threshold, cfg.dtype),
        mesh=mesh,
        engine=engine,
        max_iter=cfg.max_iter,
        trim_fraction=cfg.trim_fraction,
        eps=eps,
        scene_tile_target=cfg.grid_scene_tile,
        model_tile_target=cfg.grid_model_tile,
        max_candidates=cfg.grid_max_candidates,
        trace=trace,
    )
    return _unpad_result(out, n, trace)
