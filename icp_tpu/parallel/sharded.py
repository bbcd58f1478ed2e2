"""Sharded multi-device ICP: scene and model partitioned over a device mesh.

The reference is strictly single-process/single-GPU (SURVEY.md §2); this is
the scaling layer it lacks:

  * Scene points are sharded over the 1-D ``points`` mesh axis; every device
    owns ``N / n_dev`` scene rows for the whole run (zero resharding).
  * Model points are likewise sharded.  The NN search folds over model shards
    with a **ring schedule**: each step computes local (distance, argmin)
    against the currently-held model shard, folds it into a running carry
    (with global indices and lowest-global-index tie-breaking), then
    ``ppermute``s the shard to the next device (NCCL over NVLink on a GPU
    host).  Peak memory per device is O(N/n + M/n); the matched points are
    gathered *during* the fold, so no global gather is ever needed —
    SURVEY.md §7 "hard part #1".
  * Centroids / cross-covariance / scale energies / error are computed from
    masked local partial sums + one fused ``psum`` (``AlignmentStats`` is a
    pytree of plain sums by construction).  The 4x4 Horn solve then runs
    replicated on every device — microseconds of redundant compute instead of
    the reference's per-iteration device->host round trip
    (``src/GPU/gpu.cc:113``).
  * The whole convergence loop is one ``lax.while_loop`` *inside* shard_map:
    one compiled program per run, collectives every iteration.

An ``all_gather`` variant (model replicated before the loop) is provided for
small models where the ring's latency is not worth it.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from icp_tpu.config import ICPConfig, kernel_interpret
from icp_tpu.engine.icp import ICPResult, ICPTrace
from icp_tpu.ops.alignment import AlignmentStats, alignment_from_stats
from icp_tpu.ops.transform import apply_similarity, compose, identity_similarity
from icp_tpu.parallel.mesh import make_mesh

# Plain Python scalars on purpose: jnp scalar construction at module scope
# allocates a device buffer at import time (breaks import in backend-less
# environments and forces early backend init).
_INT_MAX = 2**31 - 1
_BIG = 3.0e38


def _local_partial_argmin(p_loc: jax.Array, m_cur: jax.Array, nn_impl: str):
    """Per scene point: (distance, argmin) against one model shard.

    ``nn_impl="pallas"`` runs the dense Triton kernel — mandatory at scale:
    the jnp path materializes the local N_loc x M_loc matrix (250 GB for a
    1M-point cloud on 4 devices).  Both impls return distances that are
    consistent across shards, so cross-shard tie comparisons are exact.
    """
    if nn_impl == "pallas":
        from icp_tpu.kernels.nn_pallas import closest_point_pallas

        idx, d2 = closest_point_pallas(p_loc, m_cur,
                                       interpret=kernel_interpret())
        return d2, idx
    # jnp fallback (small problems / CPU tests): ||m||^2 - 2 p.m — the
    # ||p||^2 term is constant per scene point and identical across shards,
    # so dropping it preserves both the argmin and tie comparisons.
    cross = jnp.matmul(p_loc, m_cur.T, precision=jax.lax.Precision.HIGHEST)
    d = jnp.sum(m_cur * m_cur, axis=1)[None, :] - 2.0 * cross
    idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    dmin = jnp.take_along_axis(d, idx[:, None].astype(jnp.int32), axis=1)[:, 0]
    return dmin, idx


def _distributed_quantile(d2, w, q, axis: str, rounds: int = 2,
                          bins: int = 32):
    """Approximate global q-quantile of masked values across shards.

    Two rounds of 32-bin histogram refinement = ~1/1024 relative bracket,
    costing ``rounds`` psums of a (bins,) vector — the distributed stand-in
    for ``jnp.quantile`` that trimmed ICP needs (an exact distributed sort
    would be absurd for a 30%-trim threshold).  Shared implementation:
    ``ops/quantile.py`` (the single-device engines use the axis-free
    variant, so trim thresholds agree across shardings by construction).
    """
    from icp_tpu.ops.quantile import histogram_quantile

    return histogram_quantile(d2, q, w, axis=axis, rounds=rounds, bins=bins)


def _masked_stats(p, y, w, axis: str) -> AlignmentStats:
    """Global AlignmentStats from masked local rows via one psum."""
    pw = p * w[:, None]
    local = AlignmentStats(
        sum_p=jnp.sum(pw, axis=0),
        sum_y=jnp.sum(y * w[:, None], axis=0),
        sum_py=jnp.matmul(pw.T, y, precision=jax.lax.Precision.HIGHEST),
        sum_pp=jnp.sum(w * jnp.sum(p * p, axis=1)),
        sum_yy=jnp.sum(w * jnp.sum(y * y, axis=1)),
        n=jnp.sum(w),
    )
    return jax.tree.map(lambda x: jax.lax.psum(x, axis), local)


def _ring_correspond(p_loc, m_loc, *, axis: str, n_dev: int, nn_impl: str = "jnp",
                     payload=()):
    """Ring NN fold: returns (matched model points, global indices[, payloads]).

    Each of the ``n_dev`` hops: fold local argmin vs the held shard, then
    pass the shard one neighbor to the right.

    ``payload``: optional tuple of per-model-point arrays (M_loc, ...) that
    ride the ring alongside the model shard; each winning row is gathered
    during the fold (normals for point-to-plane, covariances for GICP) — no
    global gather is ever needed.
    """
    m_shard = m_loc.shape[0]
    my = jax.lax.axis_index(axis)
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    def body(k, carry):
        best_d, best_i, best_pt, best_pl, m_cur, pl_cur = carry
        # owner of the held shard (all int32 to keep lax.rem happy on x64)
        src = jax.lax.rem(
            my.astype(jnp.int32) - k.astype(jnp.int32) + jnp.int32(n_dev),
            jnp.int32(n_dev),
        )
        d, idx_local = _local_partial_argmin(p_loc, m_cur, nn_impl)
        gi = idx_local + src * m_shard
        pt = jnp.take(m_cur, idx_local, axis=0)
        better = jnp.logical_or(
            d < best_d, jnp.logical_and(d == best_d, gi < best_i)
        )
        best_d = jnp.where(better, d, best_d)
        best_i = jnp.where(better, gi, best_i)
        best_pt = jnp.where(better[:, None], pt, best_pt)
        best_pl = tuple(
            jnp.where(
                better.reshape((-1,) + (1,) * (cur.ndim - 1)),
                jnp.take(cur, idx_local, axis=0),
                best,
            )
            for best, cur in zip(best_pl, pl_cur)
        )
        # Rotate the model shard (+payloads) around the ring (skipped result
        # on the last hop is dead code XLA can elide; keeping it
        # unconditional stays fusable).
        m_cur = jax.lax.ppermute(m_cur, axis, perm)
        pl_cur = tuple(jax.lax.ppermute(x, axis, perm) for x in pl_cur)
        return best_d, best_i, best_pt, best_pl, m_cur, pl_cur

    n_loc = p_loc.shape[0]
    init = (
        jnp.full((n_loc,), _BIG, p_loc.dtype),
        jnp.full((n_loc,), _INT_MAX, jnp.int32),
        jnp.zeros_like(p_loc),
        tuple(jnp.zeros((n_loc,) + x.shape[1:], x.dtype) for x in payload),
        m_loc,
        tuple(payload),
    )
    _, best_i, best_pt, best_pl, _, _ = jax.lax.fori_loop(0, n_dev, body, init)
    if payload:
        return best_pt, best_i, best_pl
    return best_pt, best_i


def _allgather_correspond(p_loc, m_loc, *, axis: str, n_dev: int, nn_impl: str = "jnp"):
    """Small-model variant: gather the full model once, local NN."""
    m_full = jax.lax.all_gather(m_loc, axis, tiled=True)
    d, idx = _local_partial_argmin(p_loc, m_full, nn_impl)
    return jnp.take(m_full, idx, axis=0), idx


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "max_iter",
        "solver",
        "with_scale",
        "reference_compat",
        "ring",
        "nn_impl",
        "trim_fraction",
        "trace",
    ),
)
def _icp_sharded_jit(
    model_pad,
    scene_pad,
    scene_mask,
    threshold,
    n_iters=None,  # dynamic iteration bound (one compile serves all counts);
    #               None -> the static max_iter
    *,
    mesh: Mesh,
    max_iter: int,
    solver: str,
    with_scale: bool,
    reference_compat: bool,
    ring: bool,
    nn_impl: str = "jnp",
    trim_fraction: float = 0.0,
    trace: bool = False,
):
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    dt = scene_pad.dtype
    correspond = _ring_correspond if ring else _allgather_correspond
    bound = jnp.asarray(max_iter if n_iters is None else n_iters, jnp.int32)

    def local_icp(m_loc, p_loc, w_loc, bound):
        def step(p, sim_tot, it):
            y, _ = correspond(p, m_loc, axis=axis, n_dev=n_dev, nn_impl=nn_impl)
            if trim_fraction > 0.0:
                d2 = jnp.sum((y - p) ** 2, axis=1)
                tau = _distributed_quantile(
                    d2, w_loc, 1.0 - trim_fraction, axis
                )
                w_eff = w_loc * (d2 <= tau).astype(w_loc.dtype)
            else:
                w_eff = w_loc
            stats = _masked_stats(p, y, w_eff, axis)
            sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
            p_new = apply_similarity(p, sim)
            derr = y - p_new
            err_sum = jax.lax.psum(jnp.sum(w_eff * jnp.sum(derr * derr, axis=1)), axis)
            err = (2.0 * err_sum / stats.n) if reference_compat else (err_sum / stats.n)
            return p_new, compose(sim_tot, sim), err, it + 1

        init = (
            p_loc,
            identity_similarity(dt),
            jnp.asarray(jnp.inf, dt),
            jnp.asarray(0, jnp.int32),
        )

        if trace:
            # early-exiting while_loop carrying a preallocated (max_iter,)
            # error buffer (a scan with done-masking would run max_iter
            # ring-NN trips regardless of convergence — the at-scale CLI
            # path cannot afford that); NaN past iters, callers slice.
            def cond_t(carry):
                _, _, err, it, _ = carry
                return jnp.logical_and(it < bound, err >= threshold)

            def body_t(carry):
                p, sim_tot, _, it, errs = carry
                p2, sim2, err2, it2 = step(p, sim_tot, it)
                errs = jax.lax.dynamic_update_index_in_dim(
                    errs, err2.astype(errs.dtype), it, 0
                )
                return p2, sim2, err2, it2, errs

            p, sim_tot, err, it, errs = jax.lax.while_loop(
                cond_t, body_t, init + (jnp.full((max_iter,), jnp.nan, dt),)
            )
            return p, sim_tot, err, it, errs

        def cond(carry):
            _, _, err, it = carry
            return jnp.logical_and(it < bound, err >= threshold)

        def body(carry):
            p, sim_tot, _, it = carry
            return step(p, sim_tot, it)

        p, sim_tot, err, it = jax.lax.while_loop(cond, body, init)
        return p, sim_tot, err, it

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


# ---------------------------------------------------------------------------
# 2-D mesh engine: scene sharded over 'sp', model sharded over 'mp'
# ---------------------------------------------------------------------------


def make_mesh_2d(n_sp: int, n_mp: int, devices=None) -> Mesh:
    """(sp, mp) mesh: scene points partitioned over ``sp``, model points over
    ``mp``.  Each device owns an (N/sp, M/mp) block of the correspondence
    problem — the 2-D analog of the reference's 2D CUDA thread grid
    (``src/GPU/compute.cu:94-118``), across devices."""
    if devices is None:
        devices = jax.devices()[: n_sp * n_mp]
    assert len(devices) >= n_sp * n_mp
    return Mesh(np.array(devices[: n_sp * n_mp]).reshape(n_sp, n_mp), ("sp", "mp"))


def _correspond_2d(p_loc, m_loc, *, mp_axis: str, n_mp: int, mp_index,
                   nn_impl: str):
    """Block-local argmin + fold over the model axis via all_gather.

    Each device holds a scene shard (replicated over mp) and a model shard.
    Local partial argmin against the held model shard, then the (dist, index,
    point) candidates are all_gathered over ``mp`` (small: O(N_loc) per
    device) and folded with lowest-global-index tie-breaking.
    """
    m_shard = m_loc.shape[0]
    d, idx_local = _local_partial_argmin(p_loc, m_loc, nn_impl)
    gi = idx_local + mp_index.astype(jnp.int32) * m_shard
    pt = jnp.take(m_loc, idx_local, axis=0)
    # gather candidates from every model shard: (n_mp, N_loc[, 3])
    d_all = jax.lax.all_gather(d, mp_axis)
    gi_all = jax.lax.all_gather(gi, mp_axis)
    pt_all = jax.lax.all_gather(pt, mp_axis)

    def fold(k, carry):
        best_d, best_i, best_pt = carry
        dk, gik, ptk = d_all[k], gi_all[k], pt_all[k]
        better = jnp.logical_or(
            dk < best_d, jnp.logical_and(dk == best_d, gik < best_i)
        )
        return (
            jnp.where(better, dk, best_d),
            jnp.where(better, gik, best_i),
            jnp.where(better[:, None], ptk, best_pt),
        )

    init = (
        jnp.full_like(d, _BIG),
        jnp.full_like(gi, _INT_MAX),
        jnp.zeros_like(pt),
    )
    _, best_i, best_pt = jax.lax.fori_loop(0, n_mp, fold, init)
    return best_pt, best_i


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "max_iter",
        "solver",
        "with_scale",
        "reference_compat",
        "nn_impl",
        "trim_fraction",
        "trace",
    ),
)
def _icp_sharded_2d_jit(
    model_pad,
    scene_pad,
    scene_mask,
    threshold,
    *,
    mesh: Mesh,
    max_iter: int,
    solver: str,
    with_scale: bool,
    reference_compat: bool,
    nn_impl: str = "jnp",
    trim_fraction: float = 0.0,
    trace: bool = False,
):
    n_mp = mesh.shape["mp"]
    dt = scene_pad.dtype

    def local_icp(m_loc, p_loc, w_loc):
        mp_index = jax.lax.axis_index("mp")

        def step(p, sim_tot, it):
            y, _ = _correspond_2d(
                p, m_loc, mp_axis="mp", n_mp=n_mp, mp_index=mp_index,
                nn_impl=nn_impl,
            )
            if trim_fraction > 0.0:
                # Scene rows (and thus y, folded deterministically over mp)
                # are replicated over mp — quantile + stats reduce over sp.
                d2 = jnp.sum((y - p) ** 2, axis=1)
                tau = _distributed_quantile(d2, w_loc, 1.0 - trim_fraction, "sp")
                w_eff = w_loc * (d2 <= tau).astype(w_loc.dtype)
            else:
                w_eff = w_loc
            # stats: scene rows are replicated over mp -> reduce over sp only
            stats = _masked_stats(p, y, w_eff, "sp")
            sim = alignment_from_stats(stats, solver=solver, with_scale=with_scale)
            p_new = apply_similarity(p, sim)
            derr = y - p_new
            err_sum = jax.lax.psum(
                jnp.sum(w_eff * jnp.sum(derr * derr, axis=1)), "sp"
            )
            err = (2.0 * err_sum / stats.n) if reference_compat else (err_sum / stats.n)
            return p_new, compose(sim_tot, sim), err, it + 1

        init = (
            p_loc,
            identity_similarity(dt),
            jnp.asarray(jnp.inf, dt),
            jnp.asarray(0, jnp.int32),
        )

        if trace:
            # early-exiting while_loop + error buffer (see the 1-D engine)
            def cond_t(carry):
                _, _, err, it, _ = carry
                return jnp.logical_and(it < max_iter, err >= threshold)

            def body_t(carry):
                p, sim_tot, _, it, errs = carry
                p2, sim2, err2, it2 = step(p, sim_tot, it)
                errs = jax.lax.dynamic_update_index_in_dim(
                    errs, err2.astype(errs.dtype), it, 0
                )
                return p2, sim2, err2, it2, errs

            p, sim_tot, err, it, errs = jax.lax.while_loop(
                cond_t, body_t, init + (jnp.full((max_iter,), jnp.nan, dt),)
            )
            return p, sim_tot, err, it, errs

        def cond(carry):
            _, _, err, it = carry
            return jnp.logical_and(it < max_iter, err >= threshold)

        def body(carry):
            p, sim_tot, _, it = carry
            return step(p, sim_tot, it)

        p, sim_tot, err, it = jax.lax.while_loop(cond, body, init)
        return p, sim_tot, err, it

    rep = PartitionSpec()
    out_specs = (PartitionSpec("sp", None), rep, rep, rep) + (
        (rep,) if trace else ()
    )
    out = jax.shard_map(
        local_icp,
        mesh=mesh,
        in_specs=(
            PartitionSpec("mp", None),  # model over mp, replicated over sp
            PartitionSpec("sp", None),  # scene over sp, replicated over mp
            PartitionSpec("sp"),
        ),
        out_specs=out_specs,
        check_vma=False,
    )(model_pad, scene_pad, scene_mask)
    if trace:
        p, sim_tot, err, it, errs = out
        return ICPTrace(
            result=ICPResult(points=p, transform=sim_tot, err=err, iters=it),
            errs=errs,
        )
    p, sim_tot, err, it = out
    return ICPResult(points=p, transform=sim_tot, err=err, iters=it)


def icp_sharded_2d(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    mesh: Mesh,
    trace: bool = False,
) -> ICPResult:
    """ICP over a 2-D (sp, mp) mesh: scene and model partitioned on
    independent axes; every device owns one block of the distance problem.

    ``trace=True`` returns an ``ICPTrace`` with the per-iteration error
    sequence (scan-based loop; same observability as the single-device
    engine)."""
    cfg = config or ICPConfig()
    n_sp = mesh.shape["sp"]
    n_mp = mesh.shape["mp"]

    model_np = np.asarray(model, np.dtype(cfg.dtype))
    scene_np = np.asarray(scene, np.dtype(cfg.dtype))
    n = scene_np.shape[0]

    scene_pad = _pad_rows(scene_np, n_sp, 0.0)
    model_pad = _pad_rows(model_np, n_mp, 1.0e17)
    mask = np.zeros((scene_pad.shape[0],), np.dtype(cfg.dtype))
    mask[:n] = 1.0

    model_d = jax.device_put(
        model_pad, NamedSharding(mesh, PartitionSpec("mp", None))
    )
    scene_d = jax.device_put(
        scene_pad, NamedSharding(mesh, PartitionSpec("sp", None))
    )
    mask_d = jax.device_put(mask, NamedSharding(mesh, PartitionSpec("sp")))

    out = _icp_sharded_2d_jit(
        model_d,
        scene_d,
        mask_d,
        jnp.asarray(cfg.threshold, cfg.dtype),
        mesh=mesh,
        max_iter=cfg.max_iter,
        solver=cfg.resolved_solver(),
        with_scale=cfg.with_scale,
        reference_compat=cfg.reference_compat,
        nn_impl="pallas" if cfg.resolved_nn_method() == "pallas" else "jnp",
        trim_fraction=cfg.trim_fraction,
        trace=trace,
    )
    return _unpad_result(out, n, trace)


def _unpad_result(out, n: int, trace: bool):
    res = out.result if trace else out
    res = ICPResult(
        points=res.points[:n],
        transform=res.transform,
        err=res.err,
        iters=res.iters,
    )
    return ICPTrace(result=res, errs=out.errs) if trace else res


def _check_trace_bound(trace: bool, n_iters, max_iter: int) -> None:
    """The trace buffer is statically sized (max_iter,); a dynamic bound
    beyond it would silently overwrite the last slot (dynamic_update clamps
    out-of-range indices).  Reject that combination host-side (n_iters is a
    host value at every call site; skip if it is somehow traced)."""
    if not trace or n_iters is None:
        return
    try:
        bound = int(n_iters)
    except (TypeError, jax.errors.TracerIntegerConversionError):
        return
    if bound > max_iter:
        raise ValueError(
            f"trace=True records at most config.max_iter={max_iter} "
            f"iterations but n_iters={bound}; raise max_iter or drop trace"
        )


def _pad_rows(arr: np.ndarray, mult: int, fill: float) -> np.ndarray:
    n = arr.shape[0]
    n_pad = -(-n // mult) * mult
    if n_pad == n:
        return arr
    pad = np.full((n_pad - n, arr.shape[1]), fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def icp_sharded(
    model,
    scene,
    config: Optional[ICPConfig] = None,
    *,
    mesh: Optional[Mesh] = None,
    ring: bool = True,
    trace: bool = False,
    n_iters=None,
) -> ICPResult:
    """Multi-device ICP over a ``points`` mesh.  API-compatible with
    ``icp_tpu.icp``; returns the same ``ICPResult`` (points un-padded).
    ``trace=True`` returns an ``ICPTrace`` with the per-iteration errors.
    ``n_iters``: optional DYNAMIC iteration bound replacing
    ``config.max_iter`` — one compiled program serves every count
    (benchmarking / chunked runs)."""
    cfg = config or ICPConfig()
    _check_trace_bound(trace, n_iters, cfg.max_iter)
    mesh = mesh or make_mesh()
    if cfg.resolved_nn_method(
            n_points=max(len(model), len(scene))) == "grid":
        # spatially-pruned ring fold (parallel/sharded_grid.py); ``ring``
        # does not apply — the grid path is always a ring
        from icp_tpu.parallel.sharded_grid import icp_sharded_grid

        return icp_sharded_grid(
            model, scene, cfg, mesh=mesh, trace=trace, n_iters=n_iters
        )
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    model_np = np.asarray(model, np.dtype(cfg.dtype))
    scene_np = np.asarray(scene, np.dtype(cfg.dtype))
    n = scene_np.shape[0]

    # Pad: scene rows -> masked out of all reductions; model rows -> placed
    # at +_BIG/2 coordinates so they can never be a nearest neighbor.
    scene_pad = _pad_rows(scene_np, n_dev, 0.0)
    model_pad = _pad_rows(model_np, n_dev, 1.0e17)
    mask = np.zeros((scene_pad.shape[0],), np.dtype(cfg.dtype))
    mask[:n] = 1.0

    shard = NamedSharding(mesh, PartitionSpec(axis, None))
    mask_shard = NamedSharding(mesh, PartitionSpec(axis))
    model_d = jax.device_put(model_pad, shard)
    scene_d = jax.device_put(scene_pad, shard)
    mask_d = jax.device_put(mask, mask_shard)

    out = _icp_sharded_jit(
        model_d,
        scene_d,
        mask_d,
        jnp.asarray(cfg.threshold, cfg.dtype),
        None if n_iters is None else jnp.asarray(n_iters, jnp.int32),
        mesh=mesh,
        max_iter=cfg.max_iter,
        solver=cfg.resolved_solver(),
        with_scale=cfg.with_scale,
        reference_compat=cfg.reference_compat,
        ring=ring,
        nn_impl="pallas" if cfg.resolved_nn_method() == "pallas" else "jnp",
        trim_fraction=cfg.trim_fraction,
        trace=trace,
    )
    return _unpad_result(out, n, trace)
