"""Static-shape bucketing — one compiled program for a whole scan chain.

XLA compiles one program per distinct input shape.  A registration chain
over real scans (e.g. the 5 bunny views, 31,701-40,256 points each —
``data_students/README.md``) therefore compiles a fresh multi-second program
for EVERY pair and every multiscale level, and the compiles can dominate the
wall time of a chain.  The reference never faces
this — it cannot register unequal-count clouds at all (``src/cpu.cc:42-53``).

The fix is the standard one for dynamic shapes: pad every
cloud up to a quantized *bucket* size and carry the true row count as a
DYNAMIC scalar, so a single compiled program serves every cloud that lands
in the bucket.  Two padding conventions cooperate:

  * **Sentinel padding** (``pad_to_bucket``): pad rows sit at a far-away
    constant (``SENTINEL`` = 1e17 — the same convention as the kd-grid
    internals and the sharded engines' model padding).  Distances from real
    points to sentinels are ~3e34 (finite in f32, never an argmin winner),
    so NN searches and kNN-normal estimation over the padded cloud are
    EXACT for the real rows.  This is the convention for anything that
    *reads geometry*: ``estimate_normals`` on a bucketed cloud is exact.
  * **Replica filling** (``replica_fill``, applied inside the engines):
    before registration the engines overwrite pad rows with a copy of the
    last real row.  Replicas keep kd tiles spatially compact (a sentinel
    clump would stretch candidate bounds) and give pad rows a cheap, real
    NN problem; they can never alter a result because argmin ties resolve
    to the LOWEST index (``tests/oracle.py`` contract) — an original row
    always beats its replicas — and pad rows carry weight 0 in every
    alignment statistic, trim quantile, and error mean (the masked-weights
    machinery the engines already use for their internal tile padding).

Workflow (what ``slam/pairwise.py`` does per chain pair):

    m_pad, m_n = pad_to_bucket(model);  s_pad, s_n = pad_to_bucket(scene)
    icp(m_pad, s_pad, cfg, model_n=m_n, scene_n=s_n)   # one program/bucket
"""

from __future__ import annotations

import numpy as np

# Far-away pad coordinate: squared distances to real points are ~3e34 —
# comfortably finite in f32 (max 3.4e38) and never an argmin winner.  Shared
# with kernels/nn_grid.py tile padding and parallel/sharded.py model padding.
SENTINEL = 1.0e17


def auto_quantum(n_max: int) -> int:
    """Default bucket quantum for a chain whose largest cloud has ``n_max``
    rows: the smallest power of two >= n_max/8 (bounding pad overhead at
    ~12.5% of the largest cloud), clamped to [64, 4096].  4,096 is the
    measured sweet spot at bunny scale (31-40k clouds -> 2 buckets); the
    lower clamp keeps tiny (test-sized) chains from padding 40x.
    """
    if n_max <= 0:
        raise ValueError(f"auto_quantum needs n_max >= 1, got {n_max}")
    # smallest power of two >= ceil(n_max/8): (x-1).bit_length(), not
    # x.bit_length(), which doubles the quantum whenever x is an exact power
    target = (n_max + 7) // 8
    return min(4096, max(64, 1 << max(0, target - 1).bit_length()))


def resolve_auto_bucket(clouds) -> int | None:
    """The chain-level "auto" bucketing policy, in ONE place (used by
    ``slam.register_chain`` and the ``icp-slam`` CLI): bucketing is ON with
    ``auto_quantum`` sizing when the chain has unequal cloud sizes, OFF
    (None) when every cloud already shares one shape — equal shapes reuse a
    compiled program without padding."""
    sizes = {len(c) for c in clouds}
    return auto_quantum(max(sizes)) if len(sizes) > 1 else None


def bucket_size(n: int, quantum: int = 4096) -> int:
    """Smallest multiple of ``quantum`` >= n (the static bucket shape).

    The default quantum of 4,096 bounds pad overhead at one quantum of extra
    rows (<= 12% for clouds >= 32k) while collapsing e.g. all five bunny
    views (31,701-40,256 points) into two buckets of the same program.
    """
    if n <= 0:
        raise ValueError(f"bucket_size needs n >= 1, got {n}")
    return -(-n // quantum) * quantum


def pad_to_bucket(cloud, quantum: int = 4096, n_pad: int | None = None):
    """Sentinel-pad an (n, d) host cloud to its bucket; returns
    ``(padded, n)`` with ``padded`` an (bucket, d) ndarray and ``n`` the true
    row count to pass as the engine's dynamic ``scene_n``/``model_n``.

    ``n_pad`` overrides the computed bucket (must be >= n) — used when two
    clouds should share one bucket shape.
    """
    cloud = np.asarray(cloud)
    n = cloud.shape[0]
    b = bucket_size(n, quantum) if n_pad is None else int(n_pad)
    if b < n:
        raise ValueError(f"n_pad={b} smaller than cloud rows {n}")
    if b == n:
        return cloud, n
    out = np.full((b,) + cloud.shape[1:], SENTINEL, dtype=cloud.dtype)
    out[:n] = cloud
    return out, n


def replica_fill(cloud, n_valid):
    """Overwrite rows >= ``n_valid`` with a copy of row ``n_valid - 1``.

    JAX-traceable in ``n_valid`` (one dynamic row read + a select), so one
    compiled program serves every valid count within the bucket.  Engines
    call this on their inputs before registration — see the module
    docstring for why replicas (not sentinels) are the right pad content
    for the hot loop.
    """
    import jax.numpy as jnp

    cloud = jnp.asarray(cloud)
    n_valid = jnp.asarray(n_valid, jnp.int32)
    row = jnp.take(cloud, n_valid - 1, axis=0)  # dynamic row read
    keep = jnp.arange(cloud.shape[0], dtype=jnp.int32) < n_valid
    return jnp.where(keep[:, None], cloud, row[None, :])


def valid_mask(n_rows: int, n_valid, dtype):
    """(n_rows,) mask: 1.0 for rows < ``n_valid`` (dynamic), else 0.0."""
    import jax.numpy as jnp

    return (
        jnp.arange(n_rows, dtype=jnp.int32) < jnp.asarray(n_valid, jnp.int32)
    ).astype(dtype)
