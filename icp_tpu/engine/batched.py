"""Batched registration: many cloud pairs per device, one program.

The production/serving shape of the problem (BASELINE.json's "frames/s"
metric): registering a stream of frame pairs.  A single cow-sized pair
underutilizes the device; ``vmap`` over the pair axis amortizes every kernel
across the batch.  No reference counterpart (strictly one pair per process —
and its input validation cannot even accept unequal-count pairs,
``src/cpu.cc:42-53``).

Semantics: every pair runs exactly ``n_iters`` iterations (the batch cannot
early-exit together; converged pairs simply keep re-solving — their transform
is a fixed point, so results are unchanged).  For convergence-gated batches,
run ``icp`` per pair instead.

Unequal-count batches: ``scene_ns`` / ``model_ns`` give per-pair
DYNAMIC valid-row counts for bucket-padded inputs (``ops/padding.py``) — the
batch axis carries clouds of *different true sizes* padded to one static
bucket shape, and a 4-pair scan chain becomes ONE batched program.
``batch_pairs`` does the padding; pad rows are replica-filled and weight-0
masked inside the engine exactly as in the single-pair bucketed path.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icp_tpu.engine.icp import ICPResult, icp_fixed_iters


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
def icp_batched(
    models: jax.Array,  # (B, M, 3)
    scenes: jax.Array,  # (B, N, 3)
    *,
    n_iters,
    solver: str = "eigh",
    nn_method: str = "bcast",
    with_scale: bool = True,
    reference_compat: bool = True,
    scene_tile: int = 16,
    model_tile: int = 64,
    trim_fraction: float = 0.0,
    scene_ns=None,  # (B,) per-pair dynamic valid scene rows (bucketed batch)
    model_ns=None,  # (B,) per-pair dynamic valid model rows
) -> ICPResult:
    """Register B pairs in one compiled program; all leaves gain a leading
    batch axis.  With ``scene_ns``/``model_ns``, rows past the per-pair count
    are padding (see module docstring) and ``points`` rows past ``scene_ns[b]``
    are meaningless — slice per pair."""

    def one(model, scene, s_n, m_n):
        return icp_fixed_iters(
            model,
            scene,
            n_iters=n_iters,
            solver=solver,
            nn_method=nn_method,
            with_scale=with_scale,
            reference_compat=reference_compat,
            scene_tile=scene_tile,
            model_tile=model_tile,
            trim_fraction=trim_fraction,
            scene_n=s_n,
            model_n=m_n,
        )

    if scene_ns is None and model_ns is None:
        return jax.vmap(lambda m, s: one(m, s, None, None))(models, scenes)
    B = models.shape[0]
    s_ns = (jnp.full((B,), scenes.shape[1], jnp.int32) if scene_ns is None
            else jnp.asarray(scene_ns, jnp.int32))
    m_ns = (jnp.full((B,), models.shape[1], jnp.int32) if model_ns is None
            else jnp.asarray(model_ns, jnp.int32))
    return jax.vmap(one)(models, scenes, s_ns, m_ns)


def batch_pairs(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    quantum: int | None = None,
):
    """Pack unequal-size (model, scene) pairs into one bucketed batch.

    Every cloud is sentinel-padded (``ops/padding.py``) to the BATCH-WIDE
    maximum bucket per role, so the whole batch is two dense arrays plus the
    per-pair true counts — the inputs ``icp_batched`` needs.  Returns
    ``(models, scenes, model_ns, scene_ns)`` as float32 ndarrays /
    int32 arrays.

    ``quantum=None`` (default) sizes the bucket with
    ``ops/padding.auto_quantum`` of the largest cloud — pad overhead stays
    ~12.5%-bounded for small batches instead of padding everything to a
    fixed 4,096-row bucket.
    """
    from icp_tpu.ops.padding import auto_quantum, bucket_size, pad_to_bucket

    if quantum is None:
        quantum = auto_quantum(max(max(len(m) for m, _ in pairs),
                                   max(len(s) for _, s in pairs)))

    m_pad = bucket_size(max(len(m) for m, _ in pairs), quantum)
    s_pad = bucket_size(max(len(s) for _, s in pairs), quantum)
    models, scenes, m_ns, s_ns = [], [], [], []
    for m, s in pairs:
        mp, mn = pad_to_bucket(np.asarray(m, np.float32), n_pad=m_pad)
        sp, sn = pad_to_bucket(np.asarray(s, np.float32), n_pad=s_pad)
        models.append(mp)
        scenes.append(sp)
        m_ns.append(mn)
        s_ns.append(sn)
    return (
        np.stack(models),
        np.stack(scenes),
        np.asarray(m_ns, np.int32),
        np.asarray(s_ns, np.int32),
    )


def register_chain_batched(
    clouds: Sequence[np.ndarray],
    *,
    n_iters: int,
    quantum: int | None = None,  # None: auto_quantum of the largest cloud
    solver: str = "eigh",
    nn_method: str = "bcast",
    with_scale: bool = True,
    trim_fraction: float = 0.0,
) -> List[ICPResult]:
    """The whole scan chain as ONE batched program: pair b registers
    ``clouds[b+1]`` onto ``clouds[b]`` (the ``slam.register_chain``
    orientation), all pairs concurrently, unequal counts bucketed.

    Fixed-iteration semantics (see ``icp_batched``); sequential
    ``register_chain`` remains the convergence-gated / multiscale /
    initialized path.  Returns one ``ICPResult`` per pair with ``points``
    sliced back to the true scene size.
    """
    pairs = [(clouds[i], clouds[i + 1]) for i in range(len(clouds) - 1)]
    models, scenes, m_ns, s_ns = batch_pairs(pairs, quantum)
    out = icp_batched(
        jnp.asarray(models), jnp.asarray(scenes), n_iters=n_iters,
        solver=solver, nn_method=nn_method, with_scale=with_scale,
        reference_compat=True, trim_fraction=trim_fraction,
        scene_ns=s_ns, model_ns=m_ns,
    )
    results = []
    for b in range(len(pairs)):
        tr = jax.tree.map(lambda x, b=b: x[b], out.transform)
        results.append(
            ICPResult(
                points=out.points[b, : int(s_ns[b])],
                transform=tr,
                err=out.err[b],
                iters=out.iters[b],
            )
        )
    return results
