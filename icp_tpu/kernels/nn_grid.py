"""Spatially-pruned nearest-neighbour search — exact, at scale.

The dense kernel (``nn_pallas.py``) touches every (scene, model) pair.  The
reference has no answer either — its hot loop is the same O(np*nm) sweep
(``src/cpu.cc:5-27``, ``src/GPU/compute.cu:94-245``).  This module prunes
the sweep with a spatial structure built from static shapes rather than a
pointer-chasing k-d tree:

  1. **Static balanced-kd ordering.**  Points are permuted by L rounds of
     widest-axis median splits (one batched segmented argsort per round —
     every shape static), yielding 2^L equal-count, spatially-compact,
     non-overlapping tiles; each tile's bbox is precomputed.  The engine
     kd-sorts the scene ONCE — a similarity transform preserves
     neighborhoods, so scene tiles stay compact for the whole ICP run.
  2. **Upper bounds from the previous iteration.**  ICP's correspondence
     changes slowly: the distance from p_i to its PREVIOUS matched model
     point is a valid upper bound u_i on this iteration's NN distance.
     (First iteration: bound against a model subsample — also valid, since
     the subsample is a subset of the model.)
  3. **Tile culling.**  Model tile j can contain the NN of some point in
     scene tile i only if bboxdist(box_i, box_j)^2 <= U_i = max_{p in i} u_p.
     The (scene-tile x model-tile) mask is tiny; each row's passing tile ids
     are compacted into a (Ni, C) candidate table plus per-row counts.
  4. **Work-list kernel (Pallas, Triton route).**  One block per (scene
     tile, power-of-two row sub-block) loads its own candidate count and
     tile ids and loops over that dynamic count, reading each candidate
     tile's coordinate planes from device memory in 128-point chunks.
     Only the tiles actually needed are read.  XLA cannot skip tiles that
     depend on the data without first gathering them into a dense
     (Ni, C*tm) operand, which moves every candidate slot whether used or
     not.

Exactness: the candidate set provably contains every tile that can hold a
true NN (u is an upper bound; bbox distance is a lower bound; both get an
epsilon margin against f32 rounding), ties resolve to the lowest ORIGINAL
model index (the kd tile's original indices ride along as a row of the
tile), and a scene tile whose candidate count exceeds the static capacity C
folds every model tile in-kernel — the result matches brute force
(``tests/oracle.py`` contract) in every case.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_COORD_ROWS = 8  # tile rows: 0-2 coords, 3 original index, 4.. payload
_BIG = 3.0e38
_CHUNK = 128  # model points per inner step of the work-list kernel
_SUB_BLOCK = 64  # scene rows per kernel block
# f32 safety margins: u must stay an upper bound and bboxdist a lower bound
# through f32 rounding, or a winning tile could be culled by one ulp.
_UPPER_INFLATE = 1.0 + 1e-5
_LOWER_DEFLATE = 1.0 - 1e-5


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kd_order(points: jax.Array, levels: int,
             real: jax.Array | None = None) -> jax.Array:
    """Permutation grouping ``points`` (n, 3) into 2^levels equal segments by
    recursive widest-axis median split.  n must be a multiple of 2^levels.

    ``real``: optional (n,) bool — False rows are padding; they sort to the
    tail of their segment (and are excluded from the axis-extent choice), so
    padding accumulates in the trailing tiles and real tiles stay compact.
    All shapes static: L batched per-segment argsorts, nothing else.
    """
    n = points.shape[0]
    assert n % (2**levels) == 0, (n, levels)
    pts = points.astype(jnp.float32)
    perm = jnp.arange(n, dtype=jnp.int32)
    msk = jnp.ones((n,), bool) if real is None else real
    for lvl in range(levels):
        s = 2**lvl
        seg = n // s
        p3 = pts.reshape(s, seg, 3)
        m3 = msk.reshape(s, seg)
        ext = jnp.max(jnp.where(m3[..., None], p3, -_BIG), axis=1) - jnp.min(
            jnp.where(m3[..., None], p3, _BIG), axis=1
        )  # (s, 3); all-pad segments give negative extents — harmless
        ax = jnp.argmax(ext, axis=1)  # (s,)
        keys = jnp.take_along_axis(p3, ax[:, None, None], axis=2)[..., 0]
        keys = jnp.where(m3, keys, _BIG)  # padding sorts last
        order = jnp.argsort(keys, axis=1)  # (s, seg)
        pts = jnp.take_along_axis(p3, order[..., None], axis=1).reshape(n, 3)
        msk = jnp.take_along_axis(m3, order, axis=1).reshape(n)
        perm = jnp.take_along_axis(perm.reshape(s, seg), order, axis=1).reshape(n)
    return perm


def levels_for(n: int, target_tile: int) -> int:
    """Split depth giving ~target_tile points per kd tile."""
    if n <= target_tile:
        return 0
    return max(0, round(math.log2(n / target_tile)))


class ModelGrid(NamedTuple):
    """kd-sorted model + per-tile bboxes (built once per ICP run)."""

    tiles_t: jax.Array  # (Nj, 8, tm) TRANSPOSED tiles: rows 0-2 coords
    #                     (padding at 1e17), row 3 = ORIGINAL index as f32
    #                     (exact below 2^24), rows 4..4+k = optional
    #                     per-point payload (e.g. normals, k <= 4); each row
    #                     of a tile is contiguous, so a chunk load coalesces
    tile_lo: jax.Array  # (Nj, 3) per-tile bbox minima (real rows only)
    tile_hi: jax.Array  # (Nj, 3)
    model_orig: jax.Array  # (M, 3) f32 original-order model
    model_tile: int
    payload_orig: jax.Array | None = None  # (M, k) original-order payload


def build_model_grid(model: jax.Array, *, target_tile: int = 1024,
                     payload: jax.Array | None = None) -> ModelGrid:
    """kd-sort the model and precompute per-tile bboxes.

    ``payload``: optional (M, k) per-point values (k <= 4, e.g. surface
    normals for point-to-plane) packed into the spare tile rows so that
    sharded engines can rotate them around the ring with the tiles; the
    winning rows are gathered from ``payload_orig`` by index.
    """
    m = model.shape[0]
    if m >= 2**24:
        raise ValueError(
            f"grid NN encodes original indices in f32 (exact below "
            f"2**24); model has {m} points — shard it first"
        )
    dt = jnp.float32
    model = model.astype(dt)
    lvl = levels_for(m, target_tile)
    n_tiles = 2**lvl
    tm = _round_up(-(-m // n_tiles), _CHUNK)
    m_pad = tm * n_tiles

    pts_p = jnp.full((m_pad, 3), 1.0e17, dt).at[:m].set(model)
    real0 = jnp.arange(m_pad) < m
    perm = kd_order(pts_p, lvl, real=real0)
    sorted_pts = pts_p[perm]
    real = perm < m

    buf = jnp.zeros((m_pad, _COORD_ROWS), dt).at[:, :3].set(sorted_pts)
    buf = buf.at[:, 3].set(jnp.where(real, perm.astype(dt), _BIG))
    if payload is not None:
        k = payload.shape[1]
        assert k <= _COORD_ROWS - 4, (
            f"payload width {k} exceeds the {_COORD_ROWS - 4} spare rows"
        )
        pl_pad = jnp.zeros((m_pad, k), dt).at[:m].set(payload.astype(dt))
        buf = buf.at[:, 4:4 + k].set(pl_pad[perm])

    tiled = sorted_pts.reshape(n_tiles, tm, 3)
    r3 = real.reshape(n_tiles, tm)[:, :, None]
    tile_lo = jnp.min(jnp.where(r3, tiled, _BIG), axis=1)
    tile_hi = jnp.max(jnp.where(r3, tiled, -_BIG), axis=1)
    return ModelGrid(
        tiles_t=jnp.transpose(
            buf.reshape(n_tiles, tm, _COORD_ROWS), (0, 2, 1)
        ),
        tile_lo=tile_lo,
        tile_hi=tile_hi,
        model_orig=model,
        model_tile=tm,
        payload_orig=None if payload is None else payload.astype(dt),
    )


def initial_bound_indices(scene: jax.Array, model: jax.Array, *,
                          stride: int = 16, interpret: bool = False):
    """First-iteration upper-bound indices: exact NN against every
    ``stride``-th model point (a subset, so its distance bounds the true NN).
    Returns ORIGINAL model indices."""
    from icp_tpu.kernels.nn_pallas import closest_point_pallas

    sub_idx, _ = closest_point_pallas(scene, model[::stride],
                                      interpret=interpret)
    return sub_idx * stride


def tile_box_dists(p_pad, grid: ModelGrid, *, scene_tile: int):
    """(Ni, Nj) deflated squared box-box distances: scene-tile bbox to every
    model-tile bbox (a lower bound on any point-pair distance between them,
    through f32 rounding)."""
    tn = scene_tile
    ni = p_pad.shape[0] // tn
    tiles = p_pad[:, :3].reshape(ni, tn, 3)
    s_lo = jnp.min(tiles, axis=1)  # (Ni, 3)
    s_hi = jnp.max(tiles, axis=1)
    gap = jnp.maximum(
        grid.tile_lo[None, :, :] - s_hi[:, None, :],
        s_lo[:, None, :] - grid.tile_hi[None, :, :],
    )
    gap = jnp.maximum(gap, 0.0)
    return jnp.sum(gap * gap, axis=-1) * _LOWER_DEFLATE


def _candidates(p_pad, u_pad, grid: ModelGrid, *, scene_tile: int, cap: int):
    """Per-scene-tile candidate model tiles: (Ni, C) ids (ascending j,
    sentinel 0 past the count), (Ni,) counts, overflow flag."""
    tn = scene_tile
    n_pad = p_pad.shape[0]
    ni = n_pad // tn
    nj = grid.tile_lo.shape[0]

    u_tile = jnp.max(u_pad.reshape(ni, tn), axis=1) * _UPPER_INFLATE  # (Ni,)
    bd2 = tile_box_dists(p_pad, grid, scene_tile=tn)  # (Ni, Nj)

    mask = bd2 <= u_tile[:, None]
    counts = jnp.sum(mask, axis=1).astype(jnp.int32)  # (Ni,)
    overflow = jnp.any(counts > cap)

    # compact each row: passing j's ascending, sentinel big past the count
    col = jnp.broadcast_to(jnp.arange(nj, dtype=jnp.int32)[None, :], mask.shape)
    keys = jnp.where(mask, col, jnp.int32(nj))
    keys = jax.lax.sort(keys, dimension=1)[:, :cap]  # (Ni, C)
    cand = jnp.where(keys < nj, keys, 0)  # sentinel -> tile 0 (never read)
    return cand, counts, overflow


def _worklist_kernel(cand_ref, cnt_ref, st_ref, tiles_ref, d_ref, i_ref, *,
                     sb: int, blocks_per_tile: int, nj: int, cap: int,
                     tm: int):
    """One block = ``sb`` rows of one scene tile: fold the tile's (dynamic)
    candidate count of model tiles, ``_CHUNK`` points at a time.

    A tile whose candidate count exceeds the table capacity folds ALL ``nj``
    model tiles (ids = loop index) — a superset of its candidates, exact;
    only the unlucky tile pays.  Ties break to the lowest ORIGINAL index:
    kd order is not index order, so the fold compares (d, index) pairs.
    The running pair is kept per (row, lane) and reduced across lanes once
    at the end (measured 3x faster than reducing every chunk, PERF.md).
    """
    t = pl.program_id(0)
    rows = pl.ds((t * blocks_per_tile + pl.program_id(1)) * sb, sb)
    px = st_ref[0, rows][:, None]
    py = st_ref[1, rows][:, None]
    pz = st_ref[2, rows][:, None]
    cnt_raw = cnt_ref[t]
    use_all = cnt_raw > cap
    # counts >= 1 by construction (the previous-match tile always passes the
    # cull); clamp anyway so every block folds at least one real tile.
    cnt = jnp.where(use_all, jnp.int32(nj), jnp.maximum(cnt_raw, 1))

    def fold_tile(c, carry):
        tile = jnp.where(use_all, c, cand_ref[t, jnp.minimum(c, cap - 1)])

        def fold_chunk(h, carry):
            best_d, best_i = carry
            cols = pl.ds(h * _CHUNK, _CHUNK)
            dx = px - tiles_ref[tile, 0, cols][None, :]
            dy = py - tiles_ref[tile, 1, cols][None, :]
            dz = pz - tiles_ref[tile, 2, cols][None, :]
            d = dx * dx + dy * dy + dz * dz  # (sb, CHUNK)
            oidx = tiles_ref[tile, 3, cols][None, :]
            better = jnp.logical_or(
                d < best_d, jnp.logical_and(d == best_d, oidx < best_i))
            return (jnp.where(better, d, best_d),
                    jnp.where(better, oidx, best_i))

        return jax.lax.fori_loop(0, tm // _CHUNK, fold_chunk, carry)

    best_d, best_i = jax.lax.fori_loop(
        0, cnt, fold_tile,
        (jnp.full((sb, _CHUNK), jnp.inf, jnp.float32),
         jnp.full((sb, _CHUNK), _BIG, jnp.float32)))
    dmin = jnp.min(best_d, axis=1)
    d_ref[rows] = dmin
    i_ref[rows] = jnp.min(jnp.where(best_d == dmin[:, None], best_i, _BIG),
                          axis=1)


def bound_from_indices(scene: jax.Array, grid: ModelGrid,
                       idx: jax.Array) -> jax.Array:
    """(N,) NN-distance upper bounds: squared distance to a known model
    point (first iteration only; after that the engine carries
    ``u = ||y - p_new||^2``, which it computes anyway)."""
    return jnp.sum(
        (scene.astype(jnp.float32) - grid.model_orig[idx]) ** 2, axis=1
    )


def next_bound(y: jax.Array, p_new: jax.Array) -> jax.Array:
    """(N,) f32 culling bounds for the NEXT iteration: squared distance to
    this iteration's matched model point after the transform.

    Always computed from the f32-CAST pair — the same rounded coordinates
    the kernel measures against next iteration — never by downcasting a
    wider-precision residual.  Near convergence an f64 residual can cancel
    BELOW the f32 distance to the very same point, and a bound tighter than
    what the kernel can observe may cull the tile holding the true f32 NN
    (the ~1e-5 relative ``_UPPER_INFLATE`` margin only absorbs f32
    rounding, not f64-vs-f32 cancellation)."""
    d = y.astype(jnp.float32) - p_new.astype(jnp.float32)
    return jnp.sum(d * d, axis=1)


# NOTE: not jax.jit-wrapped; callers jit the enclosing program.
def closest_point_indices_pruned(
    scene: jax.Array,
    grid: ModelGrid,
    u: jax.Array,
    *,
    scene_tile: int = 256,
    max_candidates: int = 16,
    interpret: bool = False,
):
    """Exact NN via tile culling; returns (indices, matched points,
    payload-or-None, squared distances, overflow).

    ``scene`` rows come in kd tiles of ``scene_tile`` rows (the engine
    kd-sorts once); pruning bites only if the tiles are spatially coherent,
    correctness never depends on it.  ``u``: (N,) f32 upper bounds on each
    point's squared NN distance (the previous iteration's residual
    ``||y - p_new||^2``, or ``bound_from_indices`` on the first iteration).
    The result is ALWAYS exact; ``overflow`` is informational (True when
    any tile folded every model tile).  Matched points and payload are
    gathered by index after the kernel.
    """
    n = scene.shape[0]
    dt = jnp.float32
    scene = scene.astype(dt)

    tn = min(scene_tile, _round_up(n, 8))
    n_pad = _round_up(n, tn)
    ni = n_pad // tn
    tm = grid.model_tile
    nj = grid.tile_lo.shape[0]
    cap = min(max_candidates, nj)

    # Pad by replicating the last point: keeps tile bboxes tight and gives
    # padding rows a real (discarded) NN problem.
    p_pad = jnp.zeros((n_pad, _COORD_ROWS), dt)
    p_pad = p_pad.at[:n, :3].set(scene)
    u = u.astype(dt)
    if n_pad > n:
        p_pad = p_pad.at[n:, :3].set(scene[-1])
        u_pad = jnp.concatenate([u, jnp.broadcast_to(u[-1], (n_pad - n,))])
    else:
        u_pad = u

    cand, counts, overflow = _candidates(
        p_pad, u_pad, grid, scene_tile=tn, cap=cap
    )

    # Kernel rows: each tile padded to a multiple of the power-of-two block
    # by replicating its last row (same bbox; rows discarded after).
    sb = 1
    while sb < min(tn, _SUB_BLOCK):
        sb *= 2
    tnp = _round_up(tn, sb)
    tiles = p_pad[:, :3].reshape(ni, tn, 3)
    if tnp > tn:
        tiles = jnp.concatenate(
            [tiles, jnp.broadcast_to(tiles[:, -1:], (ni, tnp - tn, 3))], axis=1)
    st = tiles.reshape(ni * tnp, 3).T  # (3, ni * tnp) coordinate planes
    d_k, i_k = pl.pallas_call(
        functools.partial(_worklist_kernel, sb=sb, blocks_per_tile=tnp // sb,
                          nj=nj, cap=cap, tm=tm),
        grid=(ni, tnp // sb),
        out_shape=[jax.ShapeDtypeStruct((ni * tnp,), dt),
                   jax.ShapeDtypeStruct((ni * tnp,), dt)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="nn_grid",
    )(cand, counts, st, grid.tiles_t)
    d2 = d_k.reshape(ni, tnp)[:, :tn].reshape(n_pad)[:n]
    idx = i_k.reshape(ni, tnp)[:, :tn].reshape(n_pad)[:n].astype(jnp.int32)
    y = grid.model_orig[idx]
    pl_out = None if grid.payload_orig is None else grid.payload_orig[idx]
    return idx, y, pl_out, d2, overflow


def closest_point_indices_grid(
    scene: jax.Array,
    grid: ModelGrid,
    u: jax.Array,
    *,
    scene_tile: int = 256,
    max_candidates: int = 16,
    interpret: bool = False,
):
    """Exact NN via tile culling; returns (indices, matched model points,
    payload-or-None, squared distances).  The payload slot carries the
    winning rows of the (M, k) values given to
    ``build_model_grid(payload=...)`` (None when the grid has none).

    Always identical to brute force (``tests/oracle.py`` contract: squared
    distance, lowest-original-index ties).  Distances use the subtract form
    in f32 everywhere, so they compare bitwise across calls (the sharded
    ring fold relies on this for cross-shard tie-breaking).
    """
    idx, y, pl_out, d2, _ = closest_point_indices_pruned(
        scene, grid, u,
        scene_tile=scene_tile, max_candidates=max_candidates,
        interpret=interpret,
    )
    return idx, y, pl_out, d2
