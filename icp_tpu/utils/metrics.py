"""Structured run metrics (SURVEY.md §5 metrics/logging subsystem).

The reference logs one stderr line per iteration and relies on the offline
benchmark for op timings (``src/cpu.cc:61,74``, ``README.md:84``).  Here a
run can emit a machine-readable record: per-iteration error trace plus —
optionally — the correspondence/alignment device-time split.

Design note: per-iteration wall timing *inside* the jitted loop would
require a host sync every iteration, destroying the very fusion that makes
the engine fast (the loop runs as ONE XLA program).  The
correspondence/alignment split is therefore measured once per (shape,
backend) with ``bench/harness.op_time`` and attached to the record.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional


@dataclasses.dataclass
class RunMetrics:
    """Structured record for one registration run."""

    iters: int
    err: float
    wall_s: float
    errs: list  # per-iteration error trace (QUIRK-1 metric)
    backend: str
    nn_method: str
    solver: str
    correspondence_us: Optional[float] = None  # per-iteration device time
    alignment_us: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def run_with_metrics(model, scene, config=None, *, measure_ops: bool = False,
                     init=None) -> tuple:
    """Run ``icp(trace=True)`` and build a ``RunMetrics`` record.

    ``measure_ops=True`` additionally measures the per-iteration
    correspondence and alignment times (``bench/harness.op_time``; adds a
    few seconds of warm benchmark time, more on first compile).
    Returns ``(ICPTrace, RunMetrics)``.
    """
    import jax
    import jax.numpy as jnp

    from icp_tpu.config import ICPConfig, kernel_interpret
    from icp_tpu.engine.icp import icp

    cfg = config or ICPConfig()
    t0 = time.perf_counter()
    tr = icp(model, scene, cfg, trace=True, init=init)
    err = float(tr.result.err)  # blocks on the result
    wall = time.perf_counter() - t0
    iters = int(tr.result.iters)
    errs = [float(e) for e in tr.errs[:iters]]

    corr_us = align_us = None
    if measure_ops:
        from icp_tpu.bench.harness import op_time
        from icp_tpu.ops.alignment import (
            alignment_from_stats,
            compute_alignment_stats,
        )
        m = jnp.asarray(model, jnp.float32)
        p = jnp.asarray(scene, jnp.float32)
        nn = cfg.resolved_nn_method(n_points=max(len(model), len(scene)))

        if nn == "grid":
            # steady-state grid NN, same setup as the bench harness: the
            # recorded correspondence split must time the op the run
            # actually used, not a dense stand-in
            from icp_tpu.engine.grid import _prepare_scene
            from icp_tpu.kernels.nn_grid import (
                bound_from_indices,
                build_model_grid,
                closest_point_indices_grid,
                initial_bound_indices,
            )

            grid = build_model_grid(m, target_tile=cfg.grid_model_tile)
            p_kd, _, _, tn, _ = _prepare_scene(p, cfg.grid_scene_tile)
            prev = initial_bound_indices(p_kd, grid.model_orig, stride=4,
                                         interpret=kernel_interpret())
            u_prev = bound_from_indices(p_kd, grid, prev)

            def corr(m_, p_, c):
                return closest_point_indices_grid(
                    p_kd + c * 1e-20, grid, u_prev + c * 1e-20,
                    scene_tile=tn,
                    max_candidates=cfg.grid_max_candidates,
                    interpret=kernel_interpret(),
                )[0]
        else:
            from icp_tpu.ops.distance import closest_point_indices

            def corr(m_, p_, c):
                return closest_point_indices(p_ + c * 1e-20, m_, method=nn)

        def align(m_, p_, c):
            sim = alignment_from_stats(
                compute_alignment_stats(p_ + c * 1e-20, m_),
                solver=cfg.resolved_solver(),
            )
            return sim.R, sim.s, sim.t

        corr_us = op_time(corr, (m, p)) * 1e6
        align_us = op_time(align, (m, p)) * 1e6

    rec = RunMetrics(
        iters=iters,
        err=err,
        wall_s=wall,
        errs=errs,
        backend=jax.default_backend(),
        nn_method=cfg.resolved_nn_method(n_points=max(len(model), len(scene))),
        solver=cfg.resolved_solver(),
        correspondence_us=corr_us,
        alignment_us=align_us,
    )
    return tr, rec
