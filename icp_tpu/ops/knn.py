"""Exact k-nearest-neighbour search in plain XLA.

Normals, FPFH features and closure scoring need the k nearest points of
every point once per cloud — off the per-iteration hot loop, so XLA's own
``lax.top_k`` serves.  No reference counterpart (the reference has no kNN
anywhere; its NN hot loop is ``src/cpu.cc:5-27``).

Contract (shared by both paths and pinned by the tests): ``(d2, idx)`` of
shape (N, k), squared f32 distances in the subtract form, ascending by
(distance, index) — ties resolve to the lowest point index, like the
correspondence kernels.

  * ``knn_dense``: query rows in chunks under ``lax.map``; each chunk
    computes its (chunk, M) distances and one ``lax.top_k``.  Positions are
    point indices, and ``top_k`` puts the lower position first on ties, so
    the order is lexicographic by construction.
  * ``knn_grid``: the kd tiles and bbox culling of ``kernels/nn_grid.py``.
    Each query tile gathers its candidate model tiles and runs the same
    dense distance + ``top_k`` over them.  Bounds come in two phases (kNN
    has no previous iteration to borrow one from): a seed pass over each
    tile's nearest tiles by bbox distance gives a valid k-th-distance bound,
    then every tile that can beat it is a candidate.  Tiles whose count
    exceeds the capacity are redone over every model tile (a ``lax.cond``
    that runs only when some tile overflowed) — the result stays exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from icp_tpu.kernels.nn_grid import (
    _UPPER_INFLATE,
    ModelGrid,
    _round_up,
    tile_box_dists,
)

_INT_MAX = 2**31 - 1
# Distance matrix elements per lax.map step of the dense path (~256 MB f32).
_DENSE_BLOCK_ELEMS = 1 << 26


def _sq_dists(q: jax.Array, pts: jax.Array) -> jax.Array:
    """(Q, 3) x (..., P, 3) -> (Q, P) squared distances, subtract form."""
    d = q[:, None, :] - pts[None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _topk_lex(d: jax.Array, gi: jax.Array, k: int):
    """k smallest (d, gi) pairs per row, ascending lexicographically.

    ``lax.top_k`` breaks ties by position; here positions are not index
    order, so ties at the k-th distance are settled by index: every pair
    strictly below the k-th distance is in, and the remaining slots go to
    the lowest indices among the pairs AT the k-th distance."""
    vals, _ = jax.lax.top_k(-d, k)
    dk = -vals[:, k - 1:k]
    less = d < dk
    n_less = jnp.sum(less, axis=1, keepdims=True)
    lv, lp = jax.lax.top_k(jnp.where(less, -d, -jnp.inf), k)
    less_i = jnp.take_along_axis(gi, lp, axis=1)
    tv, _ = jax.lax.top_k(-jnp.where(d == dk, gi, _INT_MAX), k)
    slot = jnp.arange(k, dtype=jnp.int32)[None, :]
    from_less = slot < n_less
    tie_i = jnp.take_along_axis(-tv, jnp.maximum(slot - n_less, 0), axis=1)
    out_d = jnp.where(from_less, -lv, dk)
    out_i = jnp.where(from_less, less_i, tie_i)
    out_d, out_i = jax.lax.sort((out_d, out_i), dimension=1, num_keys=2)
    return out_d, out_i


def knn_dense(query: jax.Array, points: jax.Array, k: int):
    """k nearest ``points`` (M, 3) for each ``query`` row (N, 3): (d2, idx),
    (N, k), ascending by (distance, index).  Requires ``k <= M``."""
    n = query.shape[0]
    m = points.shape[0]
    if k > m:
        raise ValueError(f"k={k} exceeds point count {m}")
    q = query.astype(jnp.float32)
    pts = points.astype(jnp.float32)
    chunk = max(1, min(n, _DENSE_BLOCK_ELEMS // max(m, 1)))
    n_pad = _round_up(n, chunk)
    q_pad = jnp.concatenate(
        [q, jnp.broadcast_to(q[-1], (n_pad - n, 3))], axis=0)

    def one(qc):
        vals, idx = jax.lax.top_k(-_sq_dists(qc, pts), k)
        return -vals, idx.astype(jnp.int32)

    d2, idx = jax.lax.map(one, q_pad.reshape(n_pad // chunk, chunk, 3))
    return d2.reshape(n_pad, k)[:n], idx.reshape(n_pad, k)[:n]


def knn_grid(query: jax.Array, grid: ModelGrid, k: int, *,
             scene_tile: int = 64, max_candidates: int = 32):
    """Exact k nearest model points per query row, with kd-tile culling.

    Returns ``(d2, idx)`` like ``knn_dense(query, grid.model_orig, k)``
    (ORIGINAL model indices).  ``query`` should come in spatially coherent
    tiles of ``scene_tile`` rows (kd-sorted) for pruning to bite;
    correctness never depends on it."""
    n = query.shape[0]
    m = grid.model_orig.shape[0]
    if k > m:
        raise ValueError(f"k={k} exceeds point count {m}")
    q = query.astype(jnp.float32)
    tn = min(scene_tile, _round_up(n, 8))
    n_pad = _round_up(n, tn)
    ni = n_pad // tn
    nj = grid.tile_lo.shape[0]
    tm = grid.model_tile
    q_pad = jnp.concatenate(
        [q, jnp.broadcast_to(q[-1], (n_pad - n, 3))], axis=0)
    q_tiles = q_pad.reshape(ni, tn, 3)
    # (Nj, tm, 3) coordinates and (Nj, tm) original indices of the kd tiles
    coords = jnp.transpose(grid.tiles_t[:, :3, :], (0, 2, 1))
    gidx = jnp.where(grid.tiles_t[:, 3, :] < m,
                     grid.tiles_t[:, 3, :], -1.0).astype(jnp.int32)
    gidx = jnp.where(gidx < 0, _INT_MAX, gidx)
    bd2 = tile_box_dists(q_pad, grid, scene_tile=tn)  # (Ni, Nj)

    def fold(qt, ids, valid):
        """top-k of one query tile over the candidate tiles ``ids``."""
        d = _sq_dists(qt, coords[ids].reshape(-1, 3))
        d = jnp.where(jnp.repeat(valid, tm)[None, :], d, jnp.inf)
        gi = jnp.broadcast_to(gidx[ids].reshape(1, -1), d.shape)
        return _topk_lex(d, gi, k)

    # Phase 1 — seed bounds from the c0 nearest tiles (enough real points
    # for a finite k-th distance; a shortfall only loosens the bound).
    c0 = min(nj, max(2, -(-k // tm) + 1))
    seed_ids = jnp.argsort(bd2, axis=1)[:, :c0].astype(jnp.int32)
    d_seed, _ = jax.lax.map(
        lambda a: fold(a[0], a[1], jnp.ones((c0,), bool)), (q_tiles, seed_ids),
        batch_size=_batch(tn * c0 * tm))
    u_tile = jnp.max(d_seed[:, :, k - 1], axis=1) * _UPPER_INFLATE  # (Ni,)

    # Phase 2 — every tile whose bbox can beat the bound.
    cap = min(max_candidates, nj)
    mask = bd2 <= u_tile[:, None]
    counts = jnp.sum(mask, axis=1)
    col = jnp.broadcast_to(jnp.arange(nj, dtype=jnp.int32)[None, :], mask.shape)
    keys = jax.lax.sort(jnp.where(mask, col, nj), dimension=1)[:, :cap]
    cand = jnp.where(keys < nj, keys, 0)
    d2, idx = jax.lax.map(
        lambda a: fold(a[0], a[1], jnp.arange(cap) < a[2]),
        (q_tiles, cand, counts), batch_size=_batch(tn * cap * tm))

    # Tiles whose candidates overflow the table: an exact pass over every
    # model tile, tile by tile, only when some tile overflowed.
    all_ids = jnp.arange(nj, dtype=jnp.int32)
    all_valid = jnp.ones((nj,), bool)

    def refold(a):
        qt, over, dd, ii = a
        return jax.lax.cond(over, lambda: fold(qt, all_ids, all_valid),
                            lambda: (dd, ii))

    d2, idx = jax.lax.cond(
        jnp.any(counts > cap),
        lambda: jax.lax.map(refold, (q_tiles, counts > cap, d2, idx)),
        lambda: (d2, idx),
    )
    return d2.reshape(n_pad, k)[:n], idx.reshape(n_pad, k)[:n]


def _batch(elems_per_tile: int) -> int:
    """Query tiles per ``lax.map`` step for a tile of ``elems_per_tile``
    distances."""
    return max(1, _DENSE_BLOCK_ELEMS // max(elems_per_tile, 1))


def knn(points: jax.Array, k: int, *, method: str = "auto",
        scene_tile: int = 64, model_tile: int = 256,
        max_candidates: int = 32):
    """k nearest neighbours of every point of ``points`` within itself
    (the point itself included): ``(d2, idx)``, rows in the caller's order.

    ``method``: ``"dense"``, ``"grid"`` or ``"auto"``
    (``config.resolve_knn_method``).  The grid path kd-sorts the queries
    for tile coherence and un-permutes the rows afterwards (the returned
    index VALUES are already original indices)."""
    from icp_tpu.config import resolve_knn_method

    pts32 = points.astype(jnp.float32)
    if resolve_knn_method(method, points.shape[0]) == "dense":
        return knn_dense(pts32, pts32, k)
    from icp_tpu.engine.grid import _prepare_scene
    from icp_tpu.kernels.nn_grid import build_model_grid

    grid = build_model_grid(pts32, target_tile=model_tile)
    p_sorted, _, inv_slots, tn, _ = _prepare_scene(pts32, scene_tile)
    d2, idx = knn_grid(p_sorted, grid, k, scene_tile=tn,
                       max_candidates=max_candidates)
    return d2[inv_slots], idx[inv_slots]
