"""The one backend resolver (``icp_tpu.config``).

The reference picks its device execution shape automatically by problem
aspect (``computeDim``, ``src/GPU/compute.cu:66-90``); the engine's analog
is picking the NN implementation by backend and problem SIZE.  On the GPU
``auto`` means what measured fastest on the card — XLA's fused broadcast
below the grid threshold, the compiled kd-grid Triton kernel at or above
it, the dense Triton kernel at an unknown size — and never the
interpreter; on the CPU it means the plain XLA paths; any other backend is
an error.
"""

import numpy as np
import pytest

from icp_tpu.config import (
    DENSE_AUTO_THRESHOLD,
    GRID_AUTO_THRESHOLD,
    KNN_GRID_THRESHOLD,
    ICPConfig,
    kernel_interpret,
    resolve_backend,
    resolve_knn_method,
    resolve_nn_method,
    resolve_solver,
)


def test_auto_gpu_small_is_bcast():
    cfg = ICPConfig()
    assert cfg.resolved_nn_method("gpu", 2903) == "bcast"
    assert cfg.resolved_nn_method("gpu", DENSE_AUTO_THRESHOLD - 1) == "bcast"


def test_auto_gpu_mid_size_is_the_dense_kernel():
    cfg = ICPConfig()
    assert cfg.resolved_nn_method("gpu", DENSE_AUTO_THRESHOLD) == "pallas"
    assert cfg.resolved_nn_method("gpu", 10240) == "pallas"
    assert cfg.resolved_nn_method("gpu", GRID_AUTO_THRESHOLD - 1) == "pallas"


def test_auto_gpu_large_is_grid():
    cfg = ICPConfig()
    assert cfg.resolved_nn_method("gpu", GRID_AUTO_THRESHOLD) == "grid"
    assert cfg.resolved_nn_method("gpu", 48485) == "grid"  # horse
    assert cfg.resolved_nn_method("gpu", 1_000_000) == "grid"


def test_auto_gpu_unknown_size_is_pallas():
    # sites that cannot know the problem size get the dense kernel, which
    # never materializes N x M
    assert ICPConfig().resolved_nn_method("gpu") == "pallas"


def test_auto_cpu_is_bcast_at_every_size():
    cfg = ICPConfig()
    for n in (10, 2903, GRID_AUTO_THRESHOLD, 1_000_000):
        assert cfg.resolved_nn_method("cpu", n) == "bcast"


def test_explicit_method_passes_through():
    for m in ("bcast", "matmul", "blocked", "pallas", "grid"):
        cfg = ICPConfig(nn_method=m)
        assert cfg.resolved_nn_method("gpu", 1_000_000) == m
        assert cfg.resolved_nn_method("cpu", 16) == m


def test_gpu_never_interprets_cpu_always_does():
    assert kernel_interpret("gpu") is False
    assert kernel_interpret("cpu") is True
    # the test suite runs on the CPU backend
    assert kernel_interpret() is True


@pytest.mark.parametrize("backend", ["rocm", "metal", "neuron", ""])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="unsupported JAX backend"):
        resolve_backend(backend)
    with pytest.raises(ValueError):
        kernel_interpret(backend)
    with pytest.raises(ValueError):
        resolve_nn_method("auto", backend, 2903)
    with pytest.raises(ValueError):
        resolve_solver("auto", backend)


def test_solver_resolution():
    assert resolve_solver("auto", "gpu") == "qcp"
    assert resolve_solver("auto", "cpu") == "eigh"
    for s in ("eigh", "qcp", "kabsch"):
        assert resolve_solver(s, "gpu") == s
        assert ICPConfig(solver=s).resolved_solver("cpu") == s


def test_knn_resolution_is_size_based():
    assert resolve_knn_method("auto", KNN_GRID_THRESHOLD - 1) == "dense"
    assert resolve_knn_method("auto", KNN_GRID_THRESHOLD) == "grid"
    assert resolve_knn_method("dense", 10**6) == "dense"
    assert resolve_knn_method("grid", 10) == "grid"


def test_auto_end_to_end_on_cpu_backend():
    """``icp`` under auto must run (bcast) on the CPU test backend for a
    cloud past the GPU grid threshold — the threshold is GPU-only."""
    from icp_tpu.engine.icp import icp

    rng = np.random.default_rng(0)
    n = GRID_AUTO_THRESHOLD + 5
    model = rng.standard_normal((n, 3)).astype(np.float32)
    theta = 0.05
    R = np.array(
        [[np.cos(theta), -np.sin(theta), 0.0],
         [np.sin(theta), np.cos(theta), 0.0],
         [0.0, 0.0, 1.0]], np.float32)
    scene = model @ R.T + np.array([0.01, -0.02, 0.03], np.float32)
    res = icp(model, scene, ICPConfig(max_iter=3, validate_inputs=False))
    assert int(res.iters) >= 1
    assert np.isfinite(float(res.err))


def test_engines_pass_problem_size_to_the_resolver(monkeypatch):
    """Pin the dispatch GLUE, not just the resolver: every engine entry
    must call ``resolved_nn_method`` with the max of the two cloud sizes.
    (A spy records the call; without it, inverting the ``== "grid"``
    branch in an engine would pass every CPU test, because on CPU auto
    always resolves to bcast.)"""
    from icp_tpu.engine.icp import icp
    from icp_tpu.engine.point_to_plane import icp_point_to_plane
    from icp_tpu.engine.symmetric import icp_symmetric

    rng = np.random.default_rng(1)
    model = rng.standard_normal((96, 3)).astype(np.float32)
    scene = (model[:93] +
             0.01 * rng.standard_normal((93, 3)).astype(np.float32))

    calls = []
    orig = ICPConfig.resolved_nn_method

    def spy(self, backend=None, n_points=None):
        calls.append(n_points)
        return orig(self, backend, n_points)

    monkeypatch.setattr(ICPConfig, "resolved_nn_method", spy)
    cfg = ICPConfig(max_iter=2, validate_inputs=False)
    for engine in (icp, icp_point_to_plane, icp_symmetric):
        calls.clear()
        engine(model, scene, cfg)
        assert 96 in calls, (engine.__name__, calls)


def test_gpu_auto_routes_icp_to_the_kernels(monkeypatch):
    """With the backend reported as ``gpu``, ``icp`` under auto must take
    XLA's broadcast for a small cloud, the dense kernel for a mid-size one
    and the grid engine above the grid threshold — and hand the kernels
    ``interpret=False``."""
    import icp_tpu.config as config
    import icp_tpu.engine.grid as grid_engine
    import icp_tpu.engine.icp as icp_engine

    seen = {}
    monkeypatch.setattr(config.jax, "default_backend", lambda: "gpu")

    def fake_while(model, scene, threshold, n_iters=None, **kw):
        seen[model.shape[0]] = (kw["nn_method"], kw["solver"])
        raise StopIteration

    def fake_grid(model, scene, threshold, **kw):
        seen[model.shape[0]] = ("grid", kw["solver"])
        raise StopIteration

    monkeypatch.setattr(icp_engine, "_icp_while", fake_while)
    monkeypatch.setattr(grid_engine, "_icp_grid", fake_grid)
    rng = np.random.default_rng(2)
    for n in (64, DENSE_AUTO_THRESHOLD, GRID_AUTO_THRESHOLD):
        pts = rng.standard_normal((n, 3)).astype(np.float32)
        with pytest.raises(StopIteration):
            icp_engine.icp(pts, pts, ICPConfig(max_iter=2))
    assert seen == {64: ("bcast", "qcp"),
                    DENSE_AUTO_THRESHOLD: ("pallas", "qcp"),
                    GRID_AUTO_THRESHOLD: ("grid", "qcp")}
    assert config.kernel_interpret() is False


def test_grid_auto_threshold_inside_measured_bracket():
    """The thresholds must stay inside the brackets measured on the card
    (PERF.md, PR 1): bcast ties the dense kernel at 5,120 and loses at
    6,144; the dense kernel leads the grid at 14,336 and loses at 16,384;
    dense kNN wins at 32,768 points and the grid kNN at 35,336."""
    assert 5120 < DENSE_AUTO_THRESHOLD <= 6144
    assert 14336 < GRID_AUTO_THRESHOLD <= 16384
    assert 32768 < KNN_GRID_THRESHOLD <= 35336
