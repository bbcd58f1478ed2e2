"""Profiling and runtime-guard utilities.

Reference counterpart: offline gprof/callgrind/nvprof artifacts
(``install_prof.sh``, ``benchmark/callgrind.out.76685`` — SURVEY.md §5).
Equivalents here: ``jax.profiler`` traces (viewable in Perfetto/TensorBoard)
plus the op-level timing in ``icp_tpu.bench.harness``.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Iterator

import jax
import numpy as np


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """jax.profiler trace context; view with TensorBoard/Perfetto.

    Degrades to a wall-time log line if the backend does not support
    profiling.
    """
    t0 = time.perf_counter()
    started = False
    try:
        jax.profiler.start_trace(log_dir)
        started = True
    except Exception as e:  # profiling not plumbed on this backend
        print(f"[profile] trace unavailable ({e}); wall-timing only", file=sys.stderr)
    try:
        yield
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass
        print(
            f"[profile] section took {time.perf_counter() - t0:.3f}s",
            file=sys.stderr,
        )


def check_finite(name: str, *arrays) -> None:
    """Host-side NaN/Inf guard (the reference has no failure detection at
    all — errors exit the process, SURVEY.md §5).  Raises with context."""
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        if not np.isfinite(a).all():
            bad = np.size(a) - int(np.isfinite(a).sum())
            raise FloatingPointError(
                f"{name}: array {i} has {bad} non-finite values "
                f"(shape {a.shape}, dtype {a.dtype})"
            )
