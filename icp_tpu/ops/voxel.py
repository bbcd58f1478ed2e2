"""Voxel-grid downsampling (static shapes throughout).

Standard preprocessing for at-scale registration/SLAM: quantize points to a
voxel lattice and replace each occupied voxel's points by their centroid.
The classic implementation (hash map of voxels) is dynamic-shaped and
host-bound; the formulation here is one sort + one segment-sum, all static:

  * voxel key per point: clamped 10-bit integer coordinates packed into one
    int32 (30 bits) — no int64 dependency, grid extent 1024^3 voxels
    anchored at the cloud minimum;
  * sort points by key (single device sort), detect segment starts by key
    change, prefix-sum into dense segment ids;
  * ``segment_sum`` of coordinates and counts into a STATIC ``capacity``
    buffer (caller-chosen; any voxels beyond it are dropped and reported
    via the valid-count output, never silently);
  * centroid = sum / count; a boolean mask marks the live rows.

Cost: O(N log N) sort + O(N) passes — compiles to one fused XLA program,
jit/vmap-friendly, no host round-trip.  The reference has no counterpart
(its datasets are pre-decimated; SURVEY.md §2 C22).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BITS = 10  # per-axis quantization -> 30-bit packed key in int32
_GRID = 1 << _BITS


@functools.partial(jax.jit, static_argnames=("capacity",))
def voxel_downsample(points: jax.Array, voxel_size, *, capacity: int,
                     n_valid=None):
    """Centroid-downsample ``points`` (N, 3) onto a ``voxel_size`` lattice.

    Returns ``(out, mask, n_voxels)``:
      * ``out`` (capacity, 3) — voxel centroids in the first ``n_voxels``
        rows (ordered by voxel key), zeros elsewhere;
      * ``mask`` (capacity,) bool — valid rows;
      * ``n_voxels`` () int32 — occupied voxel count (callers should check
        ``n_voxels <= capacity``; overflowing voxels are dropped from the
        tail, not silently merged).

    ``n_valid``: optional DYNAMIC count of real rows — rows at and past it
    are treated as padding (collapsed onto row 0's voxel with zero weight),
    so one compiled (N, capacity) program serves every smaller cloud padded
    up to N (the size-bucketing convention, CLAUDE.md rule 3).

    The lattice covers 1024 voxels per axis anchored at the cloud min;
    points beyond that extent clamp into the boundary voxels (documented
    trade for an int32 key — pick ``voxel_size >= extent/1024``).
    """
    dt = points.dtype
    n = points.shape[0]
    if n == 0:  # static shape: resolve at trace time
        return (jnp.zeros((capacity, 3), dt),
                jnp.zeros((capacity,), bool),
                jnp.zeros((), jnp.int32))
    if n_valid is None:
        w = jnp.ones((n,), dt)
    else:
        valid = jnp.arange(n, dtype=jnp.int32) < jnp.asarray(n_valid,
                                                             jnp.int32)
        # Padding joins row 0's voxel with zero weight: it never creates a
        # voxel, never moves a centroid, never shifts the lattice anchor.
        points = jnp.where(valid[:, None], points, points[0])
        w = valid.astype(dt)
    v = jnp.asarray(voxel_size, dt)
    lo = jnp.min(points, axis=0)
    q = jnp.clip(((points - lo) / v).astype(jnp.int32), 0, _GRID - 1)
    key = (q[:, 0] << (2 * _BITS)) | (q[:, 1] << _BITS) | q[:, 2]

    order = jnp.argsort(key)
    key_s = key[order]
    pts_s = points[order]
    w_s = w[order]

    start = jnp.concatenate(
        [jnp.ones((1,), jnp.int32),
         (key_s[1:] != key_s[:-1]).astype(jnp.int32)]
    )
    seg = jnp.cumsum(start) - 1  # dense segment ids, 0..n_voxels-1
    n_voxels = seg[-1] + 1

    sums = jax.ops.segment_sum(pts_s * w_s[:, None], seg,
                               num_segments=capacity)
    cnt = jax.ops.segment_sum(w_s, seg, num_segments=capacity)
    mask = cnt > 0
    out = sums / jnp.maximum(cnt, 1.0)[:, None]
    out = jnp.where(mask[:, None], out, jnp.zeros((), dt))
    return out, mask, n_voxels.astype(jnp.int32)


def voxel_downsample_np(points, voxel_size):
    """Host helper: downsample and return only the valid rows as a NumPy
    array (concrete shapes; convenience for pipelines/CLIs).

    Pads the cloud to a power-of-two size bucket so one compiled program
    per bucket serves every scan size — a multi-scan SLAM ingest with N
    distinct point counts costs O(log N) compiles, not N.
    """
    import numpy as np

    pts_np = np.asarray(points)
    n = pts_np.shape[0]
    if n == 0:
        return pts_np.reshape(0, 3).copy(), 0
    bucket = 1 << max(0, (n - 1)).bit_length()  # next power of two >= n
    pad = np.broadcast_to(pts_np[0], (bucket - n, 3))
    pts = jnp.asarray(np.concatenate([pts_np, pad], axis=0))
    out, mask, n_vox = voxel_downsample(pts, voxel_size, capacity=bucket,
                                        n_valid=n)
    n_out = int(n_vox)
    return np.asarray(out)[:n_out], n_out
