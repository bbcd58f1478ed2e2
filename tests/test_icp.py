"""End-to-end ICP engine tests: oracle trace parity, golden cow convergence,
f32 fast path, and the fixed-iteration benchmark loop."""

import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu import ICPConfig, icp, icp_fixed_iters
from tests import oracle


def _subsample(arr, k=10):
    return np.ascontiguousarray(arr[::k])


@pytest.fixture(scope="module")
def cow_small(cow_pair):
    ref, tr1 = cow_pair
    return _subsample(ref), _subsample(tr1)


def test_trace_matches_oracle_f64(cow_small):
    """Per-iteration error sequence must match the f64 oracle exactly
    (same algorithm, same QUIRK-1 metric)."""
    ref, tr1 = cow_small
    want_p, want_errs = oracle.icp(ref, tr1, 30)
    cfg = ICPConfig(max_iter=30, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    tr = icp(ref, tr1, cfg, trace=True)
    got_errs = np.asarray(tr.errs)[: int(tr.result.iters)]
    assert int(tr.result.iters) == len(want_errs)
    np.testing.assert_allclose(got_errs, want_errs, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(tr.result.points), want_p, atol=1e-9)


def test_while_loop_matches_trace(cow_small):
    ref, tr1 = cow_small
    cfg = ICPConfig(max_iter=30, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    res = icp(ref, tr1, cfg)
    tr = icp(ref, tr1, cfg, trace=True)
    assert int(res.iters) == int(tr.result.iters)
    np.testing.assert_allclose(
        np.asarray(res.points), np.asarray(tr.result.points), rtol=1e-12
    )


@pytest.mark.parametrize("solver", ["eigh", "qcp"])
def test_f32_fast_path_converges(cow_small, solver):
    """The f32 numerics policy must still converge within the
    reference threshold on the exact-transform cow pair."""
    ref, tr1 = cow_small
    cfg = ICPConfig(max_iter=30, dtype=jnp.float32, solver=solver, nn_method="bcast")
    res = icp(ref, tr1, cfg)
    assert float(res.err) < 1e-5
    # and the result cloud must coincide with the model-aligned oracle cloud
    want_p, _ = oracle.icp(ref, tr1, 30)
    assert np.abs(np.asarray(res.points) - want_p).max() < 1e-3


def test_full_cow_converges_f32(cow_pair):
    ref, tr1 = cow_pair
    cfg = ICPConfig(max_iter=30, dtype=jnp.float32, nn_method="bcast")
    res = icp(ref, tr1, cfg)
    assert float(res.err) < 1e-5
    assert int(res.iters) <= 10


def test_cumulative_transform_consistent(cow_small):
    """points == transform applied to the original scene (the reference never
    composes transforms; we do, for SLAM/metrics)."""
    from icp_tpu.ops.transform import apply_similarity

    ref, tr1 = cow_small
    cfg = ICPConfig(max_iter=30, dtype=jnp.float64, nn_method="bcast")
    res = icp(ref, tr1, cfg)
    replay = apply_similarity(jnp.asarray(tr1), res.transform)
    np.testing.assert_allclose(np.asarray(replay), np.asarray(res.points), atol=1e-9)


def test_fixed_iters_runs_exact_count(cow_small):
    ref, tr1 = cow_small
    res = icp_fixed_iters(
        jnp.asarray(ref, jnp.float32), jnp.asarray(tr1, jnp.float32), n_iters=5
    )
    assert int(res.iters) == 5
    assert np.isfinite(np.asarray(res.points)).all()


def test_n_iters_beyond_max_iter_rejected(cow_small):
    # max_iter is the hard cap; n_iters may only lower the bound within one
    # compiled program (resumable chunking) — never silently raise it
    ref, tr1 = cow_small
    with pytest.raises(ValueError, match="exceeds config.max_iter"):
        icp(ref, tr1, ICPConfig(max_iter=10, nn_method="bcast"), n_iters=50)


def test_validation_errors():
    p4 = jnp.zeros((3, 3))
    with pytest.raises(ValueError, match="at least 4"):
        icp(jnp.zeros((10, 3)), p4)
    with pytest.raises(ValueError, match="same number"):
        icp(jnp.zeros((10, 3)), jnp.ones((8, 3)))
    # lifting the restriction must work (bunny-style unequal counts)
    cfg = ICPConfig(max_iter=1, validate_inputs=False, nn_method="bcast")
    res = icp(np.random.default_rng(1).standard_normal((10, 3)),
              np.random.default_rng(2).standard_normal((8, 3)), cfg)
    assert res.points.shape == (8, 3)


def test_mse_mode_is_half_compat(cow_small):
    ref, tr1 = cow_small
    compat = icp(ref, tr1, ICPConfig(max_iter=3, threshold=0.0, dtype=jnp.float64,
                                     nn_method="bcast"), trace=True)
    mse = icp(ref, tr1, ICPConfig(max_iter=3, threshold=0.0, dtype=jnp.float64,
                                  nn_method="bcast", reference_compat=False), trace=True)
    np.testing.assert_allclose(np.asarray(compat.errs), 2 * np.asarray(mse.errs), rtol=1e-12)


def test_cow_tr2_five_column_workload(cow_pair):
    """cow_tr2 has 5 CSV columns and a different exact transform; both the
    loader contract and registration must handle it."""
    from icp_tpu.io.csv import load_matrix
    from tests.conftest import data_path

    ref, _ = cow_pair
    tr2 = load_matrix(data_path("cow_tr2.txt"))
    assert tr2.shape == (2903, 3)
    res = icp(ref, tr2, ICPConfig(max_iter=40, dtype=jnp.float64, nn_method="bcast"))
    assert float(res.err) < 1e-5
    assert np.abs(np.asarray(res.points) - np.asarray(ref)).max() < 1e-3
