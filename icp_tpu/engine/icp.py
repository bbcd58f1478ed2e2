"""The ICP outer loop — a single jitted ``lax.while_loop`` resident on device.

Reference counterpart: ``CPU::ICP::find_corresponding`` (``src/cpu.cc:55-79``)
and ``GPU::ICP::find_corresponding_opti`` (``src/GPU/gpu.cc:52-83``): per
iteration, (1) brute-force closest-point correspondence, (2) Horn similarity
solve, (3) apply transform + error, (4) converge when the reported error drops
below ``threshold`` (1e-5, ``src/cpu.hh:113``) or ``max_iter`` is reached.

The reference GPU driver round-trips host<->device for *every op every
iteration* (its report attributes >70% of API time to synchronize/malloc —
SURVEY.md §3.2).  This design keeps the entire loop on the device:
one jitted while_loop carrying ``(cloud, cumulative transform, err, i)``;
nothing touches the host until the final result is fetched.

Error metric (QUIRK-1, ``src/cpu.cc:63-73``): the reference reports
``(err_compute_alignment + err_compute) / np`` — both terms measure the SAME
residual ``sum ||y - (s R p + t)||^2`` (once before, once during the in-place
apply), so the reported error is ~2x the MSE.  With
``reference_compat=True`` (default) we reproduce that metric exactly —
computing the residual once and doubling it, which is mathematically identical
and halves the flops; ``reference_compat=False`` reports the plain MSE.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from icp_tpu.config import ICPConfig
from icp_tpu.ops.alignment import Similarity, alignment_from_stats, compute_alignment_stats
from icp_tpu.ops.distance import closest_point_indices
from icp_tpu.ops.transform import (
    apply_and_error,
    apply_similarity,
    compose,
    identity_similarity,
)


class ICPResult(NamedTuple):
    points: jax.Array  # (N, 3) transformed scene cloud (the reference's new_p)
    transform: Similarity  # cumulative similarity mapping input scene -> points
    err: jax.Array  # last reported per-iteration error
    iters: jax.Array  # iterations actually executed (int32)


class ICPTrace(NamedTuple):
    result: ICPResult
    errs: jax.Array  # (max_iter,) per-iteration reported error (frozen after
    # convergence, mirroring the reference's early break)


def _trim_weights(p: jax.Array, y: jax.Array, trim_fraction: float,
                  mask: jax.Array | None = None):
    """Trimmed-ICP weights: keep the (1 - trim_fraction) best correspondences
    by current squared distance (robust to partial overlap / outliers — a
    capability the reference lacks entirely).  Static trim_fraction == 0.0
    compiles to the exact untrimmed program.

    ``mask``: optional (N,) 0/1 bucket-padding validity mask
    (``ops/padding.py``) — pad rows are excluded from the quantile and get
    weight 0.

    Threshold via the 2-round histogram quantile (``ops/quantile.py``) —
    the ``jnp.quantile`` sort was an O(N log N) device sort per iteration
    (material at 1M-point scale) and diverged from the sharded engines'
    distributed histogram; now every path computes the same tau."""
    from icp_tpu.ops.quantile import histogram_quantile

    d2 = jnp.sum((y - p) ** 2, axis=1)
    tau = histogram_quantile(d2, 1.0 - trim_fraction, mask)
    w = (d2 <= tau).astype(p.dtype)
    return w if mask is None else w * mask


def _step_weights(p, y, trim_fraction: float, mask):
    """Per-correspondence weights for one iteration: trim mask, bucket
    validity mask, their product, or None (the exact unweighted program)."""
    if trim_fraction > 0.0:
        return _trim_weights(p, y, trim_fraction, mask)
    return mask


def icp_step(
    p: jax.Array,
    model: jax.Array,
    *,
    solver: str,
    nn_method: str,
    with_scale: bool,
    reference_compat: bool,
    scene_tile: int,
    model_tile: int,
    acc_dtype=None,
    trim_fraction: float = 0.0,
    scene_mask=None,
):
    """One ICP iteration: correspondence -> alignment -> apply+error.

    ``scene_mask``: optional (N,) validity mask for bucket-padded scenes
    (``ops/padding.py``) — pad rows are excluded from the trim quantile,
    the alignment statistics, and the error mean.

    Returns (p_new, per-iteration Similarity, reported error).
    """
    idx = closest_point_indices(
        p, model, method=nn_method, scene_tile=scene_tile, model_tile=model_tile
    )
    y = jnp.take(model, idx, axis=0)
    w = _step_weights(p, y, trim_fraction, scene_mask)
    if w is not None:
        stats = compute_alignment_stats(p, y, acc_dtype=acc_dtype, weights=w)
        sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
        p_new = apply_similarity(p, sim)
        d = y - p_new
        err_sum = jnp.sum(w * jnp.sum(d * d, axis=1))
        n = stats.n.astype(err_sum.dtype)
    else:
        stats = compute_alignment_stats(p, y, acc_dtype=acc_dtype)
        sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
        p_new, err_sum = apply_and_error(p, y, sim)
        n = jnp.asarray(p.shape[0], err_sum.dtype)
    err = (2.0 * err_sum / n) if reference_compat else (err_sum / n)
    return p_new, sim, err


def _step_and_compose(
    p,
    model,
    sim_tot,
    *,
    solver,
    nn_method,
    with_scale,
    reference_compat,
    scene_tile,
    model_tile,
    trim_fraction: float = 0.0,
    scene_mask=None,
):
    """One iteration + transform composition."""
    p_new, sim, err = icp_step(
        p,
        model,
        solver=solver,
        nn_method=nn_method,
        with_scale=with_scale,
        reference_compat=reference_compat,
        scene_tile=scene_tile,
        model_tile=model_tile,
        trim_fraction=trim_fraction,
        scene_mask=scene_mask,
    )
    return p_new, compose(sim_tot, sim), err


def _bucket_prologue(model, scene, scene_n, model_n):
    """Bucket-padding normalization (``ops/padding.py``), loop-invariant:
    pad rows of both clouds become replicas of the last real row (spatially
    compact, can never win an argmin tie — lowest index wins) and the scene
    gets a validity mask excluding its pad rows from every statistic.
    Returns (model, scene, scene_mask-or-None)."""
    mask = None
    if scene_n is not None:
        from icp_tpu.ops.padding import replica_fill, valid_mask

        scene = replica_fill(scene, scene_n)
        mask = valid_mask(scene.shape[0], scene_n, scene.dtype)
    if model_n is not None:
        from icp_tpu.ops.padding import replica_fill

        model = replica_fill(model, model_n)
    return model, scene, mask


def _init_transform_state(dt, init_sim=None):
    if init_sim is None:
        return identity_similarity(dt)
    return _cast_sim(init_sim, dt)


def _cast_sim(init_sim, dt) -> Similarity:
    return Similarity(
        s=jnp.asarray(init_sim.s, dt),
        R=jnp.asarray(init_sim.R, dt),
        t=jnp.asarray(init_sim.t, dt),
    )


def _warm_start(scene, init_sim):
    """Initial cloud: the raw scene, or scene pushed through the warm-start
    transform (resume / PCA init / coarser multiscale level)."""
    if init_sim is None:
        return scene
    return apply_similarity(scene, _cast_sim(init_sim, scene.dtype))


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter",
        "solver",
        "nn_method",
        "with_scale",
        "reference_compat",
        "scene_tile",
        "model_tile",
        "trim_fraction",
    ),
)
def _icp_while(
    model,
    scene,
    threshold,
    n_iters=None,  # optional DYNAMIC bound <= max_iter: one compiled
    #               program serves every chunk size (resumable chunking)
    *,
    max_iter: int,
    solver: str,
    nn_method: str,
    with_scale: bool,
    reference_compat: bool,
    scene_tile: int,
    model_tile: int,
    trim_fraction: float = 0.0,
    init_sim=None,
    scene_n=None,  # dynamic bucket-padding valid counts (ops/padding.py):
    model_n=None,  # one compiled program serves every cloud in the bucket
):
    dt = scene.dtype
    model, scene, scene_mask = _bucket_prologue(model, scene, scene_n, model_n)
    scene = _warm_start(scene, init_sim)
    bound = jnp.asarray(max_iter if n_iters is None else n_iters, jnp.int32)

    def cond(carry):
        _, _, err, it = carry
        return jnp.logical_and(it < bound, err >= threshold)

    def body(carry):
        p, sim_tot, _, it = carry
        p_new, sim_tot2, err = _step_and_compose(
            p,
            model,
            sim_tot,
            solver=solver,
            nn_method=nn_method,
            with_scale=with_scale,
            reference_compat=reference_compat,
            scene_tile=scene_tile,
            model_tile=model_tile,
            trim_fraction=trim_fraction,
            scene_mask=scene_mask,
        )
        return p_new, sim_tot2, err, it + 1

    init = (
        scene,
        _init_transform_state(dt, init_sim),
        jnp.asarray(jnp.inf, dt),
        jnp.asarray(0, jnp.int32),
    )
    p, total, err, it = jax.lax.while_loop(cond, body, init)
    return ICPResult(points=p, transform=total, err=err, iters=it)


class ICPGuardError(RuntimeError):
    """Raised by ``icp(guard="device")`` when the loop aborts on a
    non-finite or diverging error (status and iteration in the message)."""


# err > factor * best-so-far aborts the guarded loop.  ICP error is not
# strictly monotone (trim/tie churn gives small bumps), so the factor is
# deliberately loose — this catches blow-ups, not plateaus.
_DIVERGE_FACTOR = 100.0

_GUARD_OK, _GUARD_NONFINITE, _GUARD_DIVERGED = 0, 1, 2


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter",
        "solver",
        "nn_method",
        "with_scale",
        "reference_compat",
        "scene_tile",
        "model_tile",
        "trim_fraction",
    ),
)
def _icp_while_guarded(
    model,
    scene,
    threshold,
    *,
    max_iter: int,
    solver: str,
    nn_method: str,
    with_scale: bool,
    reference_compat: bool,
    scene_tile: int,
    model_tile: int,
    trim_fraction: float = 0.0,
    init_sim=None,
    scene_n=None,
    model_n=None,
):
    """``_icp_while`` with an in-loop failure guard: the carry tracks the
    best error seen and a status word; a non-finite or >100x-diverged error
    aborts the while_loop at the NEXT condition check (fail-fast on device —
    no host round-trip per iteration).  The reference exits the process on
    the few errors it checks at all (SURVEY.md §5)."""
    dt = scene.dtype
    model, scene, scene_mask = _bucket_prologue(model, scene, scene_n, model_n)
    scene = _warm_start(scene, init_sim)

    def cond(carry):
        _, _, err, it, _, status = carry
        return jnp.logical_and(
            jnp.logical_and(it < max_iter, err >= threshold),
            status == _GUARD_OK,
        )

    def body(carry):
        p, sim_tot, _, it, best, _ = carry
        p_new, sim_tot2, err = _step_and_compose(
            p,
            model,
            sim_tot,
            solver=solver,
            nn_method=nn_method,
            with_scale=with_scale,
            reference_compat=reference_compat,
            scene_tile=scene_tile,
            model_tile=model_tile,
            trim_fraction=trim_fraction,
            scene_mask=scene_mask,
        )
        status = jnp.where(
            ~jnp.isfinite(err),
            jnp.int32(_GUARD_NONFINITE),
            jnp.where(
                err > _DIVERGE_FACTOR * best,
                jnp.int32(_GUARD_DIVERGED),
                jnp.int32(_GUARD_OK),
            ),
        )
        return p_new, sim_tot2, err, it + 1, jnp.minimum(best, err), status

    init = (
        scene,
        _init_transform_state(dt, init_sim),
        jnp.asarray(jnp.inf, dt),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(jnp.inf, dt),
        jnp.asarray(_GUARD_OK, jnp.int32),
    )
    p, total, err, it, _, status = jax.lax.while_loop(cond, body, init)
    result = ICPResult(points=p, transform=total, err=err, iters=it)
    return result, status


def _raise_on_guard_status(result: ICPResult, status) -> None:
    status = int(status)
    if status == _GUARD_NONFINITE:
        raise ICPGuardError(
            f"non-finite error at iteration {int(result.iters)} "
            f"(err={float(result.err)!r}) — input cloud or transform "
            f"produced NaN/Inf; loop aborted on device"
        )
    if status == _GUARD_DIVERGED:
        raise ICPGuardError(
            f"error diverged (> {_DIVERGE_FACTOR:.0f}x best) at iteration "
            f"{int(result.iters)}: err={float(result.err):.3e}"
        )


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter",
        "solver",
        "nn_method",
        "with_scale",
        "reference_compat",
        "scene_tile",
        "model_tile",
        "trim_fraction",
    ),
)
def _icp_scan_trace(
    model,
    scene,
    threshold,
    *,
    max_iter: int,
    solver: str,
    nn_method: str,
    with_scale: bool,
    reference_compat: bool,
    scene_tile: int,
    model_tile: int,
    trim_fraction: float = 0.0,
    init_sim=None,
    scene_n=None,
    model_n=None,
):
    """Early-exiting trace variant: the reference's loop + per-iteration
    error log (``src/cpu.cc:55-79``).

    A while_loop carrying a preallocated (max_iter,) error buffer —
    iterations past convergence never execute (a scan with done-masking
    would run max_iter trips regardless, ~28x the device work for a
    200-iteration budget converging in 7).  Unwritten tail entries are NaN;
    callers slice ``errs[:iters]``."""
    dt = scene.dtype
    model, scene, scene_mask = _bucket_prologue(model, scene, scene_n, model_n)
    scene = _warm_start(scene, init_sim)

    def cond(carry):
        _, _, err, it, _ = carry
        return jnp.logical_and(it < max_iter, err >= threshold)

    def body(carry):
        p, sim_tot, _, it, errs = carry
        p_new, sim_tot2, err_new = _step_and_compose(
            p,
            model,
            sim_tot,
            solver=solver,
            nn_method=nn_method,
            with_scale=with_scale,
            reference_compat=reference_compat,
            scene_tile=scene_tile,
            model_tile=model_tile,
            trim_fraction=trim_fraction,
            scene_mask=scene_mask,
        )
        errs = jax.lax.dynamic_update_index_in_dim(
            errs, err_new.astype(errs.dtype), it, 0
        )
        return p_new, sim_tot2, err_new, it + 1, errs

    init = (
        scene,
        _init_transform_state(dt, init_sim),
        jnp.asarray(jnp.inf, dt),
        jnp.asarray(0, jnp.int32),
        jnp.full((max_iter,), jnp.nan, dt),
    )
    p, total, err, it, errs = jax.lax.while_loop(cond, body, init)
    return ICPTrace(
        result=ICPResult(points=p, transform=total, err=err, iters=it),
        errs=errs,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "solver",
        "nn_method",
        "with_scale",
        "reference_compat",
        "scene_tile",
        "model_tile",
        "trim_fraction",
    ),
)
def icp_fixed_iters(
    model,
    scene,
    *,
    n_iters,  # dynamic on purpose: one compiled program serves every count
    # (fori_loop takes a traced bound by lowering to while_loop)
    solver: str = "eigh",
    nn_method: str = "bcast",
    with_scale: bool = True,
    reference_compat: bool = True,
    scene_tile: int = 16,
    model_tile: int = 64,
    trim_fraction: float = 0.0,
    scene_n=None,
    model_n=None,
):
    """Run exactly ``n_iters`` iterations with no convergence exit — the
    benchmark workload (reference full-loop benches use 20 iterations,
    ``src/bench.cc:435-445``)."""
    dt = scene.dtype
    model, scene, scene_mask = _bucket_prologue(model, scene, scene_n, model_n)

    def body(_, carry):
        p, sim_tot, __ = carry
        p_new, sim_tot2, err = _step_and_compose(
            p,
            model,
            sim_tot,
            solver=solver,
            nn_method=nn_method,
            with_scale=with_scale,
            reference_compat=reference_compat,
            scene_tile=scene_tile,
            model_tile=model_tile,
            trim_fraction=trim_fraction,
            scene_mask=scene_mask,
        )
        return p_new, sim_tot2, err

    init = (
        scene,
        _init_transform_state(dt),
        jnp.asarray(jnp.inf, dt),
    )
    n = jnp.asarray(n_iters, jnp.int32)
    p, total, err = jax.lax.fori_loop(0, n, body, init)
    return ICPResult(points=p, transform=total, err=err, iters=n)


def _validate(model, scene, cfg: ICPConfig) -> None:
    """Reference input validation (``src/cpu.cc:42-53``).

    The np==nm restriction is an artifact of the reference's array plumbing —
    brute-force NN does not need it — so it is only enforced under
    ``validate_inputs`` for strict compat; >=4 points is always required
    (the similarity solve needs 4 non-degenerate correspondences).
    """
    if scene.shape[0] < 4:
        raise ValueError("[error] Need at least 4 point pairs")
    if cfg.validate_inputs and scene.shape[0] != model.shape[0]:
        raise ValueError(
            "[error] Point sets need to have the same number of points. "
            "(reference restriction; pass validate_inputs=False to lift it)"
        )


def icp(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    trace: bool = False,
    guard=False,
    init: Optional[Similarity] = None,
    n_iters=None,
    scene_n=None,
    model_n=None,
):
    """Register ``scene`` onto ``model``; both (N, 3) arrays.

    Returns ``ICPResult`` (or ``ICPTrace`` when ``trace=True``).  The full
    loop runs as one XLA computation on the default backend.

    ``init``: optional warm-start ``Similarity`` — the loop starts from the
    transformed scene with the cumulative transform seeded to ``init`` (so
    the returned transform still maps the CALLER's scene to the result).
    This is what checkpoint resume, PCA initialization and multiscale
    refinement use; the reference always starts from identity
    (``src/cpu.hh:57-59``).

    ``guard=True`` adds a host-side NaN/divergence check on the result
    (forces a device sync).  ``guard="device"`` additionally carries a
    status word through the while_loop so a non-finite or >100x-diverged
    error aborts the loop at the next condition check and raises
    ``ICPGuardError`` with the failing iteration — fail-fast without a
    per-iteration host sync (dense engines; grid/trace paths get the
    host-side check).  The reference has no failure detection at all
    (SURVEY.md §5).

    ``n_iters``: optional DYNAMIC early-exit bound (must be <=
    ``config.max_iter``, which stays the compiled buffer/loop shape) — one
    compiled program serves every bound, so resumable chunking never
    recompiles for a partial final chunk.  Plain (non-trace, non-guard)
    runs only.

    ``scene_n`` / ``model_n``: optional DYNAMIC valid-row counts for
    bucket-padded clouds (``ops/padding.py``) — rows past the count are
    padding: replica-filled internally and excluded (weight 0) from the trim
    quantile, the alignment statistics, and the error mean.  One compiled
    program serves every cloud in the bucket — the whole point: a scan
    chain over varying cloud sizes pays ONE compile per bucket instead of
    one per shape.  ``result.points`` keeps the padded shape; slice
    ``[:scene_n]``.
    """
    cfg = config or ICPConfig()
    if n_iters is not None and (trace or guard):
        raise ValueError("n_iters is for plain runs; trace/guard paths "
                         "size buffers by config.max_iter")
    if n_iters is not None and int(n_iters) > cfg.max_iter:
        # max_iter is the hard iteration cap callers rely on; n_iters only
        # lowers the bound within one compiled program (resumable chunking).
        raise ValueError(
            f"n_iters={int(n_iters)} exceeds config.max_iter={cfg.max_iter}; "
            "n_iters is an early-exit bound, not a replacement "
            "(use ICPConfig(max_iter=...) or icp_fixed_iters)"
        )
    model = jnp.asarray(model, cfg.dtype)
    scene = jnp.asarray(scene, cfg.dtype)
    _validate(model, scene, cfg)
    if init is not None:
        init = _cast_sim(init, cfg.dtype)
    if scene_n is not None:
        scene_n = jnp.asarray(scene_n, jnp.int32)
    if model_n is not None:
        model_n = jnp.asarray(model_n, jnp.int32)
    n_points = max(model.shape[0], scene.shape[0])
    if cfg.resolved_nn_method(n_points=n_points) == "grid":
        from icp_tpu.engine.grid import _icp_grid

        out = _icp_grid(
            model,
            scene,
            jnp.asarray(cfg.threshold, cfg.dtype),
            max_iter=cfg.max_iter,
            solver=cfg.resolved_solver(),
            with_scale=cfg.with_scale,
            reference_compat=cfg.reference_compat,
            trim_fraction=cfg.trim_fraction,
            scene_tile_target=cfg.grid_scene_tile,
            model_tile_target=cfg.grid_model_tile,
            max_candidates=cfg.grid_max_candidates,
            mode="trace" if trace else "while",
            n_iters=None if n_iters is None else jnp.asarray(n_iters,
                                                             jnp.int32),
            init_sim=init,
            scene_n=scene_n,
            model_n=model_n,
        )
        result = out.result if trace else out
        if guard:
            from icp_tpu.utils.profiling import check_finite

            check_finite("icp", result.err, result.points)
        return out
    kwargs = dict(
        max_iter=cfg.max_iter,
        solver=cfg.resolved_solver(),
        nn_method=cfg.resolved_nn_method(n_points=n_points),
        with_scale=cfg.with_scale,
        reference_compat=cfg.reference_compat,
        scene_tile=cfg.scene_tile,
        model_tile=cfg.model_tile,
        trim_fraction=cfg.trim_fraction,
        init_sim=init,
        scene_n=scene_n,
        model_n=model_n,
    )
    threshold = jnp.asarray(cfg.threshold, cfg.dtype)
    if trace:
        out = _icp_scan_trace(model, scene, threshold, **kwargs)
        result = out.result
    elif guard == "device":
        out, status = _icp_while_guarded(model, scene, threshold, **kwargs)
        _raise_on_guard_status(out, status)
        result = out
    else:
        out = _icp_while(
            model, scene, threshold,
            None if n_iters is None else jnp.asarray(n_iters, jnp.int32),
            **kwargs,
        )
        result = out
    if guard:
        from icp_tpu.utils.profiling import check_finite

        check_finite("icp", result.err, result.points)
    return out


def icp_resumable(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    checkpoint_path: str,
    checkpoint_every: int = 50,
    resume: bool = False,
    init: Optional[Similarity] = None,
):
    """ICP with periodic checkpointing and kill-safe resume (SURVEY.md §5).

    Runs the jitted loop in ``checkpoint_every``-iteration chunks, saving
    ``(transform, total_iters, err)`` after each chunk; each chunk warm-
    starts from the cumulative transform, so a run resumed from the file
    (``resume=True``) reproduces the uninterrupted chunked run bit-for-bit
    (checkpoints store float64 views of the float32 state — an exact
    round-trip).  The reference persists nothing (SURVEY.md §5).
    """
    from icp_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = config or ICPConfig()
    total_iters = 0
    cur = init
    loaded_err = float("nan")
    if resume and os.path.exists(checkpoint_path):
        cur, total_iters, loaded_err, _ = load_checkpoint(checkpoint_path)
    res = None
    # ONE compiled program for every chunk: static shape = checkpoint_every
    # with a DYNAMIC per-chunk bound (the partial final chunk would
    # otherwise trigger a second compile), and an
    # explicit identity warm start for the first chunk (init=None is a
    # different pytree and would compile separately; identity application
    # and composition are IEEE-exact, so results are unchanged bit-for-bit).
    chunk_cfg = dataclasses.replace(cfg, max_iter=min(checkpoint_every,
                                                      cfg.max_iter))
    if cur is None:
        cur = identity_similarity(cfg.dtype)
    while total_iters < cfg.max_iter:
        k = min(checkpoint_every, cfg.max_iter - total_iters)
        res = icp(model, scene, chunk_cfg, init=cur, n_iters=k)
        cur = res.transform
        total_iters += int(res.iters)
        save_checkpoint(
            checkpoint_path, transform=cur, iteration=total_iters,
            err=float(res.err),
        )
        if int(res.iters) < k or float(res.err) < cfg.threshold:
            break
    if res is None:  # resumed past max_iter: re-apply for the points; the
        # error is the checkpoint's stored value (NOT NaN — the CLI re-saves
        # the result, and NaN would destroy the stored error)
        p = _warm_start(scene if isinstance(scene, jax.Array)
                        else jnp.asarray(scene, cfg.dtype), cur)
        return ICPResult(points=p, transform=_cast_sim(cur, cfg.dtype),
                         err=jnp.asarray(loaded_err, cfg.dtype),
                         iters=jnp.asarray(total_iters, jnp.int32))
    return ICPResult(points=res.points, transform=res.transform, err=res.err,
                     iters=jnp.asarray(total_iters, jnp.int32))
