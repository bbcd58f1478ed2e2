"""Dense nearest-neighbour kernel — Pallas through Triton.

Replaces the reference's optimized CUDA correspondence path
(``compute_distance`` + ``find_Y`` + the memory-adaptive 1280-column batching
orchestrator, ``src/GPU/compute.cu:94-245``).  Differences by design:

  * The reference materializes a ``batch x nm`` distance matrix in device
    memory per wave, then runs a serial-argmin kernel over it.  Here one
    block owns a power-of-two tile of scene rows and walks the model in
    power-of-two tiles with a ``fori_loop``, holding the running
    (min d^2, argmin) pair per (row, lane) in registers — the N x M matrix
    never exists, in any memory.
  * The distance is the subtract form ``sum_k (p_k - m_k)^2`` in FP32 on the
    CUDA cores: a K=3 product wastes the tensor cores, and TF32 would flip
    argmins.  Squared distance is the reference contract
    (``src/GPU/compute.cu:117``).
  * Ties resolve to the lowest model index (reference ``compute.cu:137``):
    each lane keeps its earliest minimum by a strict ``<`` fold in ascending
    model order, and the final masked index-min across lanes picks the
    lowest of those.
  * Small scenes leave most SMs idle, so the model axis can be split across
    blocks (``splits``); a small XLA pass merges the per-split pairs, taking
    the first split on ties, which keeps the lowest-index rule.
  * The model travels as three coordinate planes (3, M): each tile row is
    one contiguous, coalesced load.  Padded model rows sit at 1e17 per
    coordinate (distance ~3e34, finite) and never win.
  * Where it is used: ``auto`` takes it for mid-size clouds, between
    XLA's fused broadcast (small clouds) and the kd-grid kernel (large
    ones), as measured on the card (PERF.md).  It also serves the grid
    engine's first-iteration bounds and the sharded dense engines.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_PAD = 1.0e17  # coordinate of padded model rows
_INT_MAX = 2**31 - 1
# Blocks to aim for when splitting the model axis: one per streaming
# multiprocessor of the H100 (132; measured at cow against 264 and no split).
_TARGET_BLOCKS = 132


def _pow2_at_most(x: int, cap: int) -> int:
    p = 1
    while p < x and p < cap:
        p *= 2
    return min(p, cap)


def _dense_nn_kernel(s_ref, mt_ref, d_ref, i_ref, *, n: int, bn: int,
                     bm: int, tiles_per_split: int):
    """One block: ``bn`` scene rows against one split of the model tiles.

    The running minimum is kept per (row, lane) across the model tiles, so
    the loop body is subtract, multiply-add, compare and select — no
    cross-lane reduction until the end (measured 4.7x faster at horse than
    reducing every tile, PERF.md)."""
    rows = pl.ds(pl.program_id(0) * bn, bn)
    split = pl.program_id(1)
    live = pl.program_id(0) * bn + jnp.arange(bn, dtype=jnp.int32) < n
    px = plgpu.load(s_ref.at[rows, 0], mask=live, other=0.0)[:, None]
    py = plgpu.load(s_ref.at[rows, 1], mask=live, other=0.0)[:, None]
    pz = plgpu.load(s_ref.at[rows, 2], mask=live, other=0.0)[:, None]
    j0 = split * tiles_per_split

    def fold(t, carry):
        best_d, best_j = carry
        cols = pl.ds((j0 + t) * bm, bm)
        dx = px - mt_ref[0, cols][None, :]
        dy = py - mt_ref[1, cols][None, :]
        dz = pz - mt_ref[2, cols][None, :]
        d = dx * dx + dy * dy + dz * dz  # (bn, bm)
        better = d < best_d  # strict: the earlier tile keeps a tie
        return jnp.where(better, d, best_d), jnp.where(better, j0 + t, best_j)

    best_d, best_j = jax.lax.fori_loop(
        0, tiles_per_split, fold,
        (jnp.full((bn, bm), jnp.inf, jnp.float32),
         jnp.zeros((bn, bm), jnp.int32)))
    dmin = jnp.min(best_d, axis=1)
    # each lane holds its earliest minimum, so the lowest global index among
    # the lanes at the row minimum is the lowest overall
    col = jnp.arange(bm, dtype=jnp.int32)[None, :]
    idx = jnp.min(jnp.where(best_d == dmin[:, None], best_j * bm + col,
                            _INT_MAX), axis=1)
    plgpu.store(d_ref.at[split, rows], dmin, mask=live)
    plgpu.store(i_ref.at[split, rows], idx, mask=live)


def closest_point_pallas(
    scene: jax.Array,
    model: jax.Array,
    *,
    block_n: int = 16,
    block_m: int = 64,
    splits: int | None = None,
    interpret: bool = False,
):
    """Nearest model point for every scene point: ``(idx, d2)``.

    ``idx`` (N,) int32 indices into ``model``, lowest index on ties; ``d2``
    (N,) float32 squared distances.  ``splits``: model-axis splits per scene
    block (``None``: enough to give the card ~two waves of blocks).
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU tests).

    The scene is read as it is, (N, 3), with masked row loads; the model is
    transposed and padded to (3, M_pad), which XLA hoists out of an ICP loop
    (the model is loop-invariant).  Not wrapped in ``jax.jit``: callers jit
    the enclosing program.
    """
    n, dim = scene.shape
    m = model.shape[0]
    assert dim == 3, f"expected 3-D points, got {dim}"
    dt = jnp.float32
    bn = _pow2_at_most(n, block_n)
    bm = _pow2_at_most(m, block_m)
    n_blocks = -(-n // bn)
    m_tiles = -(-m // bm)
    if splits is None:
        splits = -(-_TARGET_BLOCKS // n_blocks)
    splits = max(1, min(splits, m_tiles))
    tiles_per_split = -(-m_tiles // splits)
    m_pad = splits * tiles_per_split * bm

    mt = jnp.full((3, m_pad), _PAD, dt).at[:, :m].set(model.astype(dt).T)
    d_all, i_all = pl.pallas_call(
        functools.partial(_dense_nn_kernel, n=n, bn=bn, bm=bm,
                          tiles_per_split=tiles_per_split),
        grid=(n_blocks, splits),
        out_shape=[
            jax.ShapeDtypeStruct((splits, n), dt),
            jax.ShapeDtypeStruct((splits, n), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="nn_dense",
    )(scene.astype(dt), mt)
    if splits == 1:
        return i_all[0], d_all[0]
    # Merge the splits: argmin returns the first (lowest-model-order) split
    # on ties, preserving the lowest-index rule.
    win = jnp.argmin(d_all, axis=0)
    idx = jnp.take_along_axis(i_all, win[None, :], axis=0)[0]
    return idx, jnp.min(d_all, axis=0)

