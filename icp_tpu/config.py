"""Configuration and the one backend resolver of the ICP engine.

The reference exposes its knobs as 3 positional CLI args, compile-time macros
(``REF_PATH``/``SCENE_PATH``, ``BATCH_SIZE=1280``, thread-block shapes; see
reference ``src/GPU/compute.cu:7-9``, ``src/bench.cc:7-8``) and one hardcoded
convergence threshold (``src/cpu.hh:113``).  Here everything lives in one
dataclass, consumable from Python or CLI flags.

Backend choice lives here and nowhere else.  The engine runs on two
backends:

  * ``"gpu"`` (an NVIDIA H100 is the target): ``auto`` picks by problem
    size among XLA's fused broadcast and the compiled Pallas kernels
    (Triton route), as measured on the card; a kernel never runs in the
    interpreter there.
  * ``"cpu"`` (the test backend): ``auto`` picks the plain XLA paths.  A
    caller that names a kernel method (``nn_method="pallas"``/``"grid"``)
    asks for it explicitly, and on the CPU it then runs in the Pallas
    interpreter — which is how the CPU tests reach the kernels.

Any other backend raises.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

# ``nn_method="auto"`` on the GPU by cloud size (max of model/scene rows),
# from per-iteration sweeps on subsampled horse (H100, PERF.md, PR 1):
# XLA bcast and the dense Triton kernel tie up to 5,120 points (96 vs 97,
# 106 vs 106 us) and the kernel leads from 6,144 (113 vs 118 us); the kd
# grid first beats the dense kernel at 16,384 (158 vs 175 us; at 14,336
# it is behind, 162-169 vs 146-148 us).
DENSE_AUTO_THRESHOLD = 6144
GRID_AUTO_THRESHOLD = 16384

# Smallest cloud at which kNN (normals, FPFH) uses the kd-grid XLA path
# instead of the dense blocked one.  k=17 and k=64 on the card (PERF.md,
# PR 1): dense wins at 32,768 points (67 vs 82 ms) and on the 31,701-point
# bunny scan; the grid wins from the 35,336-point scan (63 vs 82 ms) up.
KNN_GRID_THRESHOLD = 34000

_BACKENDS = ("gpu", "cpu")


def resolve_backend(backend: str | None = None) -> str:
    """The backend the engine runs on; raises for one it does not support."""
    backend = jax.default_backend() if backend is None else backend
    if backend not in _BACKENDS:
        raise ValueError(
            f"unsupported JAX backend {backend!r}: the engine runs on "
            f"{' or '.join(_BACKENDS)}"
        )
    return backend


def kernel_interpret(backend: str | None = None) -> bool:
    """Whether a Pallas kernel that a caller asked for runs interpreted:
    never on the GPU, always on the CPU (which has no compiled route)."""
    return resolve_backend(backend) == "cpu"


def resolve_nn_method(method: str, backend: str | None = None,
                      n_points: int | None = None) -> str:
    """Map ``nn_method`` to a concrete correspondence implementation.

    ``n_points``: the dense problem scale, max(model rows, scene rows), when
    the caller knows it.  On the GPU, ``auto`` is XLA's fused broadcast
    below ``DENSE_AUTO_THRESHOLD``, the dense Triton kernel from it and the
    kd-grid Triton kernel from ``GRID_AUTO_THRESHOLD`` (the reference's
    size-based ``computeDim`` analog, ``src/GPU/compute.cu:66-90``); at an
    unknown size it is the dense Triton kernel, which never materializes
    N x M.  On the CPU ``auto`` is the fused XLA broadcast form.
    """
    backend = resolve_backend(backend)
    if method != "auto":
        return method
    if backend == "gpu":
        if n_points is None or DENSE_AUTO_THRESHOLD <= n_points \
                < GRID_AUTO_THRESHOLD:
            return "pallas"
        return "grid" if n_points >= GRID_AUTO_THRESHOLD else "bcast"
    return "bcast"


def resolve_solver(solver: str, backend: str | None = None) -> str:
    """Map ``solver`` to a concrete Horn eigen solver.  ``qcp`` (a few
    fused scalar kernels) beat ``eigh`` per cow iteration on the card, 112
    vs 270 us (PERF.md, PR 1); the CPU tests keep the oracle-grade
    ``eigh``."""
    backend = resolve_backend(backend)
    if solver != "auto":
        return solver
    return "qcp" if backend == "gpu" else "eigh"


def resolve_knn_method(method: str, n_points: int) -> str:
    """``auto`` kNN: the dense blocked XLA path below ``KNN_GRID_THRESHOLD``
    points, the kd-grid XLA path from it (measured on the card, PERF.md).
    Both are plain XLA, so the choice does not depend on the backend."""
    if method != "auto":
        return method
    return "grid" if n_points >= KNN_GRID_THRESHOLD else "dense"


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """All tunables of the ICP engine.

    Attributes:
      max_iter: maximum outer iterations (reference: argv[3]).
      threshold: convergence threshold on the per-iteration error
        (reference: ``threshold = 1e-5``, ``src/cpu.hh:113``).  Checked against
        the *reported* error, which in ``reference_compat`` mode is ~2x the MSE
        (QUIRK-1, see ``engine/icp.py``).
      dtype: compute dtype for point coordinates / distances / accumulations.
        The reference is float64 throughout; the fast path is float32 with
        every contraction pinned to ``precision=HIGHEST`` (no TF32; validated
        against the float64 oracle in tests; ``compute_alignment_stats``
        accepts a separate ``acc_dtype`` for power users).
      reference_compat: if True, report the reference's error metric
        ``(err_alignment + err_apply) / np`` which double-counts the residual
        (~2x MSE, reference ``src/cpu.cc:63-73``).  If False, report plain MSE.
      solver: alignment eigenproblem solver: ``"eigh"`` (jnp.linalg.eigh on the
        Horn 4x4 N-matrix), ``"qcp"`` (Newton on the quartic characteristic
        polynomial + adjugate eigenvector; branch-free), ``"kabsch"`` (3x3
        SVD), or ``"auto"`` (``resolve_solver``).
      nn_method: correspondence search implementation: ``"bcast"`` (fused XLA
        broadcast), ``"matmul"`` (||a||^2+||b||^2-2ab), ``"pallas"`` (dense
        Triton kernel, ``kernels/nn_pallas.py``), ``"grid"`` (kd-tiled
        spatially-pruned Triton kernel — exact, fastest for large clouds;
        ``kernels/nn_grid.py``), or ``"auto"`` (``resolve_nn_method``).
      scene_tile / model_tile: dense NN kernel block sizes (scene rows x
        model rows per inner step; powers of two).  Replaces the reference's
        empirically found ``BATCH_SIZE=1280`` scene batching
        (``src/GPU/compute.cu:7-9``).
      validate_inputs: if True, enforce the reference's input checks (equal
        point counts, >=4 points, ``src/cpu.cc:42-53``).  The equal-count
        restriction is an artifact (NN correspondence does not need np==nm);
        disable to register e.g. the bunny views.
      with_scale: estimate the similarity scale factor (reference always does);
        False gives rigid (SE(3)) alignment for SLAM use.
      trim_fraction: trimmed-ICP outlier rejection — drop this fraction of
        the worst correspondences (by current distance) from every alignment
        solve.  0.0 (default) reproduces the reference exactly; ~0.1-0.4 is
        typical for partially overlapping real scans.  Reported error becomes
        the mean over KEPT correspondences.
      grid_scene_tile / grid_model_tile: target kd tile sizes for the
        ``"grid"`` NN path (points per scene/model tile).
      grid_max_candidates: candidate-model-tile capacity per scene tile for
        the grid path; a scene tile whose candidate count exceeds it folds
        every model tile (exactness is never affected).
    """

    max_iter: int = 200
    threshold: float = 1e-5
    dtype: jnp.dtype = jnp.float32
    reference_compat: bool = True
    solver: str = "auto"
    nn_method: str = "auto"
    scene_tile: int = 16
    model_tile: int = 64
    validate_inputs: bool = True
    with_scale: bool = True
    trim_fraction: float = 0.0
    grid_scene_tile: int = 256
    grid_model_tile: int = 1024
    grid_max_candidates: int = 16

    def resolved_solver(self, backend: str | None = None) -> str:
        return resolve_solver(self.solver, backend)

    def resolved_nn_method(self, backend: str | None = None,
                           n_points: int | None = None) -> str:
        return resolve_nn_method(self.nn_method, backend, n_points)
