"""ICP driver over the spatially-pruned NN path (``kernels/nn_grid.py``).

Same outer loop as ``engine/icp.py`` (one jitted ``lax.while_loop``; reference
``src/cpu.cc:55-79``) with three at-scale changes:

  * the scene is kd-sorted ONCE before the loop (similarity transforms
    preserve neighborhoods, so scene tiles stay spatially compact for the
    whole run) and un-permuted at the end;
  * the loop carry additionally holds ``u`` — each point's squared residual
    to its previous matched point (computed as a byproduct of the error
    term), which upper-bounds its current NN distance and lets the work-list
    kernel cull model tiles (exact; overflowing tiles fold everything).
    Carrying the bound VALUE rather than the matched index saves a gather
    per iteration;
  * the cloud is padded to the kd tile multiple by replicating the last
    point; padded rows ride along with weight 0 (masked out of the alignment
    stats, the error, and the trim quantile).

The alignment solve, trim, and QUIRK-1 error metric are shared with the
dense engine.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

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
from icp_tpu.ops.alignment import alignment_from_stats, compute_alignment_stats
from icp_tpu.ops.transform import apply_similarity, compose

_BIG = 3.0e38


def _prepare_scene(scene: jax.Array, target_tile: int, n_valid=None):
    """kd-sort + pad the scene; returns
    (p_sorted, weights, inv_slots, tn, perm).

    ``inv_slots[r]`` is the sorted-array slot holding original row r, so
    ``points_sorted[inv_slots]`` restores the caller's order; ``perm`` maps
    sorted slots back to padded original rows (for permuting per-point
    side data such as GICP covariances alongside the points).

    ``n_valid``: optional DYNAMIC valid-row count for bucket-padded scenes
    (``ops/padding.py``; bucket pad rows must already be replica-filled so
    kd tiles stay compact) — rows past it get weight 0 exactly like the
    tile-multiple padding this function adds itself.
    """
    n = scene.shape[0]
    lvl = levels_for(n, target_tile)
    tn = _round_up(-(-n // (2**lvl)), 8)
    n_pad = tn * (2**lvl)
    pad = jnp.broadcast_to(scene[-1], (n_pad - n, 3))
    s_pad = jnp.concatenate([scene, pad.astype(scene.dtype)], axis=0)
    perm = kd_order(s_pad, lvl)
    p_sorted = s_pad[perm]
    limit = n if n_valid is None else jnp.asarray(n_valid, perm.dtype)
    w = (perm < limit).astype(scene.dtype)
    inv_slots = jnp.argsort(perm)[:n]
    return p_sorted, w, inv_slots, tn, perm


def _grid_step_fn(grid: ModelGrid, w, *, solver: str, with_scale: bool,
                  reference_compat: bool, trim_fraction: float, tn: int,
                  max_candidates: int, interp: bool):
    """One grid-pruned ICP iteration: (p, state, u_prev) ->
    (p_new, state', err, u_next)."""

    def step(p, state, u_prev):
        _, y, _, d2 = closest_point_indices_grid(
            p, grid, u_prev, scene_tile=tn,
            max_candidates=max_candidates, interpret=interp,
        )
        y = y.astype(p.dtype)
        if trim_fraction > 0.0:
            # kernel d2 is f32; recompute in the engine dtype when wider so
            # the trim threshold matches the dense engine (up to the f32
            # quantization of the matched points y — the grid path's
            # correspondences are f32-exact, not f64-exact)
            if p.dtype != jnp.float32:
                d2 = jnp.sum((y - p) ** 2, axis=1)
            from icp_tpu.ops.quantile import histogram_quantile

            # masked histogram quantile over REAL rows (padded rows have
            # w=0 and are excluded — no prefix rescale needed)
            tau = histogram_quantile(d2, 1.0 - trim_fraction, w)
            w_eff = w * (d2 <= tau).astype(w.dtype)
        else:
            w_eff = w
        stats = compute_alignment_stats(p, y, weights=w_eff)
        sim = alignment_from_stats(stats, solver=solver,
                                   with_scale=with_scale)
        new_state = compose(state, sim)
        p_new = apply_similarity(p, sim)
        d = y - p_new
        err_sum = jnp.sum(w_eff * jnp.sum(d * d, axis=1))
        n_eff = stats.n.astype(err_sum.dtype)
        err = (2.0 * err_sum / n_eff) if reference_compat else (err_sum / n_eff)
        # next iteration's culling bounds: distance to this iteration's
        # match after the transform — a model point, hence a valid upper
        # bound on the new NN distance.  No gather needed.  Computed from
        # the f32-cast pair (NOT the residual downcast) — see next_bound.
        return p_new, new_state, err, next_bound(y, p_new)

    return step


_STATICS = (
    "max_iter",
    "solver",
    "with_scale",
    "reference_compat",
    "trim_fraction",
    "scene_tile_target",
    "model_tile_target",
    "max_candidates",
    "bound_stride",
    "mode",
)


@functools.partial(jax.jit, static_argnames=_STATICS)
def _icp_grid(
    model,
    scene,
    threshold,
    *,
    max_iter: int,
    solver: str,
    with_scale: bool,
    reference_compat: bool,
    trim_fraction: float = 0.0,
    scene_tile_target: int = 256,
    model_tile_target: int = 1024,
    max_candidates: int = 16,
    bound_stride: int = 16,
    mode: str = "while",  # "while" | "trace" | "fixed"
    n_iters=None,  # dynamic iteration count (mode="fixed") or dynamic
    #               early-exit bound <= max_iter (mode="while")
    init_sim=None,  # optional warm-start Similarity (resume / PCA init)
    scene_n=None,  # dynamic bucket-padding valid counts (ops/padding.py)
    model_n=None,
):
    from icp_tpu.config import kernel_interpret
    from icp_tpu.engine.icp import _bucket_prologue, _init_transform_state

    dt = scene.dtype
    interp = kernel_interpret()

    model, scene, _ = _bucket_prologue(model, scene, scene_n, model_n)
    if init_sim is not None:
        scene = apply_similarity(scene, init_sim)

    # One-time (hoisted out of the loop by XLA): model kd index, scene kd
    # sort, first-iteration bounds from a model subsample.
    grid = build_model_grid(model, target_tile=model_tile_target)
    p0, w, inv_slots, tn, _ = _prepare_scene(scene, scene_tile_target,
                                             n_valid=scene_n)
    stride = max(1, min(bound_stride, model.shape[0] // 4))
    idx0 = initial_bound_indices(p0, grid.model_orig, stride=stride,
                                 interpret=interp)
    u0 = bound_from_indices(p0, grid, idx0)  # one-time gather, pre-loop

    step = _grid_step_fn(
        grid, w, solver=solver, with_scale=with_scale,
        reference_compat=reference_compat, trim_fraction=trim_fraction,
        tn=tn, max_candidates=max_candidates, interp=interp,
    )

    state0 = _init_transform_state(dt, init_sim)
    err0 = jnp.asarray(jnp.inf, dt)
    it0 = jnp.asarray(0, jnp.int32)

    if mode == "while":
        # optional dynamic bound (<= max_iter): one compiled program serves
        # every resumable chunk size
        bound = jnp.asarray(max_iter if n_iters is None else n_iters,
                            jnp.int32)

        def cond(carry):
            _, _, err, it, _ = carry
            return jnp.logical_and(it < bound, err >= threshold)

        def body(carry):
            p, state, _, it, u = carry
            p_new, state2, err, u2 = step(p, state, u)
            return p_new, state2, err, it + 1, u2

        p, state, err, it, _ = jax.lax.while_loop(
            cond, body, (p0, state0, err0, it0, u0)
        )
        errs = None
    elif mode == "trace":
        # early-exiting while_loop + error buffer (see engine/icp.py's
        # trace variant); NaN past iters, callers slice errs[:iters]
        def cond_t(carry):
            _, _, err, it, _, _ = carry
            return jnp.logical_and(it < max_iter, err >= threshold)

        def body_t(carry):
            p, state, _, it, u, errs = carry
            p_new, state2, err_new, u2 = step(p, state, u)
            errs = jax.lax.dynamic_update_index_in_dim(
                errs, err_new.astype(errs.dtype), it, 0
            )
            return p_new, state2, err_new, it + 1, u2, errs

        p, state, err, it, _, errs = jax.lax.while_loop(
            cond_t, body_t,
            (p0, state0, err0, it0, u0, jnp.full((max_iter,), jnp.nan, dt)),
        )
    else:  # fixed
        def fbody(_, carry):
            p, state, err, u = carry
            p_new, state2, err2, u2 = step(p, state, u)
            return p_new, state2, err2, u2

        nit = jnp.asarray(n_iters, jnp.int32)
        p, state, err, _ = jax.lax.fori_loop(
            0, nit, fbody, (p0, state0, err0, u0)
        )
        it = nit
        errs = None

    result = ICPResult(
        points=p[inv_slots],
        transform=state,
        err=err,
        iters=it,
    )
    if mode == "trace":
        return ICPTrace(result=result, errs=errs)
    return result
