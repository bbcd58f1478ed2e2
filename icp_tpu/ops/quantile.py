"""Masked approximate quantile via iterative histogram refinement.

Trimmed ICP needs a per-iteration distance threshold tau with
``count(d2 <= tau) >= q * N``.  ``jnp.quantile`` delivers that through a full
device sort — O(N log N) work, and it cannot be distributed.  A trim
threshold does not need sort precision: two rounds of 32-bin histogram
refinement bracket the quantile to ~1/1024 of the value range using only
fused compare+reduce passes (O(rounds * bins * N) elementwise work, no
materialized N x bins buffer after XLA fusion), and each round reduces to
one (bins,) vector — psum-able, which is how the sharded engines have always
computed it (``parallel/sharded.py``).

This module is the shared implementation: ``axis=None`` is the single-device
variant (plain sums), ``axis="points"`` the sharded one (psum/pmax).  The
returned tau is the upper edge of the first bracket covering the target
count, so ``count(d2 <= tau) >= q * n`` always holds (the kept set can be
slightly larger than q*N, never smaller — the safe direction for a
robustness trim).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def histogram_quantile(d2: jax.Array, q, w: jax.Array | None = None, *,
                       axis: str | None = None, rounds: int = 2,
                       bins: int = 32) -> jax.Array:
    """Approximate q-quantile of ``d2`` rows where ``w > 0``.

    ``d2``: (N,) non-negative values (squared distances).  ``w``: optional
    (N,) mask/weights; rows with ``w <= 0`` are excluded.  ``axis``: mesh
    axis name for the distributed variant (inside ``shard_map``), or None.
    """
    dt = d2.dtype
    wv = None if w is None else w.astype(dt)

    def _sum(x):
        return jax.lax.psum(x, axis) if axis is not None else x

    masked = d2 if wv is None else jnp.where(wv > 0, d2, 0.0)
    hi = jnp.max(masked) + jnp.asarray(1e-12, dt)
    if axis is not None:
        hi = jax.lax.pmax(hi, axis)
    lo = jnp.zeros((), dt)
    n_total = _sum(jnp.sum(wv) if wv is not None
                   else jnp.asarray(d2.shape[0], dt))
    target = q * n_total
    for _ in range(rounds):
        edges = lo + (hi - lo) * jnp.arange(1, bins + 1, dtype=dt) / bins
        le = (d2[:, None] <= edges[None, :]).astype(dt)
        if wv is not None:
            le = wv[:, None] * le
        cnt = _sum(jnp.sum(le, axis=0))
        ok = cnt >= target
        idx = jnp.argmax(ok)  # first bin covering the target count
        lo = jnp.where(idx > 0, edges[jnp.maximum(idx - 1, 0)], lo)
        hi = edges[idx]
    return hi
