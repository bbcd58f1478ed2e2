"""Multi-scan pairwise registration chains (the bunny workload).

The reference cannot register the bunny views at all: its input validation
requires equal point counts (``src/cpu.cc:42-53``) and the five Stanford
bunny views have different counts (31,701-40,256) plus real sensor noise
(``data_students/README.md``).  This layer lifts that restriction (brute-force
NN never needed it) and chains pairwise ICP into per-scan world poses — the
front end of the pose-graph extension (BASELINE.json configs 3 and 5).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from icp_tpu.config import ICPConfig
from icp_tpu.engine.icp import ICPResult, icp
from icp_tpu.ops.alignment import Similarity
from icp_tpu.ops.transform import compose, identity_similarity

# (multiscale registration uses every level's result as the next level's
# initialization; see register_pair)


@dataclasses.dataclass
class PairwiseResult:
    """Result of registering scan i onto scan i-1 (or a given target)."""

    transform: Similarity  # maps source scan into the target frame
    err: float
    iters: int


def initialize_pca(
    model: np.ndarray,
    scene: np.ndarray,
    *,
    with_scale: bool = False,
    subsample: int = 8,
) -> Similarity:
    """Global initialization by principal-axis alignment.

    ICP is local: beyond a few tens of degrees of rotation it stalls in a
    local minimum (the reference has no answer to this — its datasets are
    mostly small transforms).  PCA alignment is rotation-global for clouds
    with distinct principal axes: R = U_m D U_s^T over the four proper sign
    flips D, scored by NN residual on subsampled clouds; t = mu_m - s R mu_s.

    Runs ENTIRELY on the host in NumPy: the candidate scoring is 4 small
    (~n/subsample squared) NN sweeps — sub-millisecond-scale FLOPs that
    would otherwise be dispatched eagerly op by op, once per pair at
    varying shapes.
    """
    import jax.numpy as jnp

    # cap the scoring cost for huge clouds: ~2k points resolve the 4-way
    # sign-flip vote just as well (it is a coarse global initializer)
    m_sub = np.asarray(model[::subsample], np.float32)
    s_sub = np.asarray(scene[::subsample], np.float32)
    while m_sub.shape[0] > 4096 or s_sub.shape[0] > 4096:
        m_sub, s_sub = m_sub[::2], s_sub[::2]
    mu_m = np.asarray(model, np.float64)[::subsample].mean(0)
    mu_s = np.asarray(scene, np.float64)[::subsample].mean(0)
    Cm = np.cov((np.asarray(model[::subsample], np.float64) - mu_m).T)
    Cs = np.cov((np.asarray(scene[::subsample], np.float64) - mu_s).T)
    wm, Um = np.linalg.eigh(Cm)
    ws, Us = np.linalg.eigh(Cs)
    if np.linalg.det(Um) < 0:
        Um[:, 0] = -Um[:, 0]
    if np.linalg.det(Us) < 0:
        Us[:, 0] = -Us[:, 0]
    s = float(np.sqrt(np.sum(wm) / np.sum(ws))) if with_scale else 1.0

    m2 = np.sum(m_sub.astype(np.float64) ** 2, axis=1)  # (M,)
    best = None
    for signs in ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1)):
        R = Um @ np.diag(signs) @ Us.T  # proper rotation (det = +1)
        t = mu_m - s * R @ mu_s
        moved = (s_sub.astype(np.float64) @ (s * R).T + t)  # (N, 3)
        # matmul-expansion NN residual: min_j ||moved_i - m_j||^2, without
        # materializing an (N, M, 3) broadcast
        d2 = (
            np.sum(moved * moved, axis=1)[:, None]
            + m2[None, :]
            - 2.0 * moved @ m_sub.astype(np.float64).T
        )
        resid = float(np.mean(np.maximum(d2.min(axis=1), 0.0)))
        if best is None or resid < best[0]:
            best = (resid, (s, R, t))
    s, R, t = best[1]
    return Similarity(
        jnp.asarray(s, jnp.float32),
        jnp.asarray(R, jnp.float32),
        jnp.asarray(t, jnp.float32),
    )


_ENGINES = ("point_to_point", "point_to_plane", "gicp", "symmetric")


def _run_engine(engine: str, model, scene, cfg: ICPConfig,
                init=None, **kw) -> ICPResult:
    if engine == "point_to_point":
        return icp(model, scene, cfg, init=init, **kw)
    if engine == "point_to_plane":
        from icp_tpu.engine.point_to_plane import icp_point_to_plane

        return icp_point_to_plane(model, scene, cfg, init=init, **kw)
    if engine == "gicp":
        from icp_tpu.engine.gicp import icp_generalized

        return icp_generalized(model, scene, cfg, init=init, **kw)
    if engine == "symmetric":
        from icp_tpu.engine.symmetric import icp_symmetric

        return icp_symmetric(model, scene, cfg, init=init, **kw)
    raise ValueError(f"unknown engine {engine!r}; choose from {_ENGINES}")


def register_pair(
    model: np.ndarray,
    scene: np.ndarray,
    config: Optional[ICPConfig] = None,
    *,
    multiscale: Sequence[int] = (1,),
    init: Optional[object] = None,
    engine: str = "point_to_point",
    bucket_quantum: Optional[int] = None,
    pad_sizes: Optional[Sequence[int]] = None,
) -> PairwiseResult:
    """Register ``scene`` onto ``model`` (unequal counts allowed).

    ``multiscale``: subsampling factors, coarse to fine, e.g. ``(16, 4, 1)``.
    Each level runs ICP on every k-th point starting from the previous
    level's transform — most iterations run at coarse (1/k^2-cost) levels.

    ``bucket_quantum``: static-shape bucketing (``ops/padding.py``) — pad
    each level's clouds to the next multiple of this quantum and pass the
    true counts as dynamic ``scene_n``/``model_n``.  Every pair whose
    (model, scene) sizes land in the same buckets then reuses ONE compiled
    program instead of compiling once per shape.

    ``pad_sizes``: per-``multiscale``-level explicit padded sizes (both
    clouds), overriding the per-cloud bucket — ``register_chain`` passes the
    chain-wide maximum per level so EVERY pair of the chain shares one
    compiled program per level.

    ``init``: optional global initialization — a ``Similarity``, the
    string ``"pca"`` for principal-axis alignment (rescues large-rotation
    pairs that stall vanilla ICP; see ``initialize_pca``), or ``"fpfh"``
    for feature-based global registration (FPFH + batched RANSAC,
    ``engine/global_reg.py`` — handles partial overlap, where PCA's
    whole-cloud axes diverge between views).

    ``engine``: registration metric — ``"point_to_point"`` (Horn, scale
    optional), ``"point_to_plane"`` or ``"gicp"`` (both rigid; converge in
    ~3 iterations vs ~7 and tolerate sliding contact / disjoint sampling —
    the right choice for real scan chains).
    """
    cfg = config or ICPConfig()
    if cfg.validate_inputs:
        cfg = dataclasses.replace(cfg, validate_inputs=False)
    if engine != "point_to_point" and cfg.with_scale:
        # plane-based metrics are SE(3)-only; scale is not identifiable
        cfg = dataclasses.replace(cfg, with_scale=False)

    import jax.numpy as jnp

    if init == "pca":
        init = initialize_pca(model, scene,
                              with_scale=cfg.with_scale)
    elif init == "fpfh":
        from icp_tpu.engine.global_reg import global_register

        init = global_register(model, scene,
                               with_scale=cfg.with_scale).transform
    if init is None:
        total = identity_similarity(cfg.dtype)
    else:
        total = Similarity(
            jnp.asarray(init.s, cfg.dtype),
            jnp.asarray(init.R, cfg.dtype),
            jnp.asarray(init.t, cfg.dtype),
        )
    err, iters = float("inf"), 0
    for lvl, k in enumerate(multiscale):
        # warm-start through the engine (init=) instead of pre-transforming
        # the cloud: the engine composes the level's refinement onto `total`
        # and returns the cumulative transform directly.
        sub_model = np.ascontiguousarray(model[::k])
        sub_scene = np.ascontiguousarray(scene[::k])
        kw = {}
        if bucket_quantum or pad_sizes is not None:
            from icp_tpu.ops.padding import pad_to_bucket

            n_pad = None if pad_sizes is None else int(pad_sizes[lvl])
            sub_model, m_n = pad_to_bucket(sub_model, bucket_quantum or 4096,
                                           n_pad=n_pad)
            sub_scene, s_n = pad_to_bucket(sub_scene, bucket_quantum or 4096,
                                           n_pad=n_pad)
            kw = dict(model_n=m_n, scene_n=s_n)
        res: ICPResult = _run_engine(engine, sub_model, sub_scene, cfg,
                                     init=total, **kw)
        total = res.transform
        err, iters = float(res.err), iters + int(res.iters)
    return PairwiseResult(transform=total, err=err, iters=iters)


def register_chain(
    clouds: Sequence[np.ndarray],
    config: Optional[ICPConfig] = None,
    *,
    multiscale: Sequence[int] = (1,),
    init: Optional[object] = None,
    engine: str = "point_to_point",
    bucket_quantum="auto",
) -> List[PairwiseResult]:
    """Register each scan onto its predecessor: results[i] maps cloud i+1
    into cloud i's frame.  ``init="pca"`` applies per-pair PCA initialization
    (recommended for chains with large inter-view rotations); ``engine``
    selects the registration metric per pair (see ``register_pair``);
    ``bucket_quantum`` pads every pair's clouds to the CHAIN-WIDE maximum
    bucket per multiscale level, so the whole chain runs on one compiled
    program per level regardless of per-scan point counts.

    ``bucket_quantum="auto"`` (default): bucketing is ON for unequal-count
    chains (quantum from ``ops/padding.auto_quantum``) and OFF when every
    cloud already has the same size (equal shapes reuse one compiled program
    without padding).  Pass ``None`` to force off, or an int quantum."""
    if bucket_quantum == "auto":
        from icp_tpu.ops.padding import resolve_auto_bucket

        bucket_quantum = resolve_auto_bucket(clouds)
    pad_sizes = None
    if bucket_quantum:
        from icp_tpu.ops.padding import bucket_size

        # shared bucket per level = chain-max subsampled size, rounded up:
        # ONE program per level for every pair (the alternative — per-cloud
        # buckets — still compiles once per distinct bucket combination)
        pad_sizes = [
            bucket_size(max(len(c[::k]) for c in clouds), bucket_quantum)
            for k in multiscale
        ]
    out = []
    for a, b in zip(clouds[:-1], clouds[1:]):
        out.append(register_pair(a, b, config, multiscale=multiscale,
                                 init=init, engine=engine,
                                 bucket_quantum=bucket_quantum,
                                 pad_sizes=pad_sizes))
    return out


def chain_to_world_poses(pairs: Sequence[PairwiseResult]) -> List[Similarity]:
    """Compose pairwise transforms into world poses (frame of scan 0).

    pose[i] maps scan i into scan-0 coordinates; pose[0] = identity.
    """
    import jax.numpy as jnp

    poses = [identity_similarity(jnp.float32)]
    for pr in pairs:
        # scan k+1 -> scan k (pr.transform), then scan k -> world (poses[-1]).
        poses.append(compose(pr.transform, poses[-1]))
    return poses
