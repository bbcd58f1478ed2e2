"""Horse workload parity: our engine must reproduce the reference algorithm's
behavior on horse — including its convergence *plateau*.

Finding (pinned here so nobody "fixes" it into a fake regression): vanilla
point-to-point ICP on horse_ref/horse_tr1 stalls around err ~2e-5 (above the
1e-5 threshold) with RMSE ~0.07 vs the reference cloud — in float64, with the
oracle implementing exactly the reference's math.  The reference would behave
identically; matching the reference means matching this plateau, not beating
it."""

import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu import ICPConfig, icp
from tests import oracle
from tests.conftest import data_path


@pytest.fixture(scope="module")
def horse_small():
    from icp_tpu.io.csv import load_matrix

    ref = load_matrix(data_path("horse_ref.txt"))
    tr1 = load_matrix(data_path("horse_tr1.txt"))
    return np.ascontiguousarray(ref[::40]), np.ascontiguousarray(tr1[::40])


def test_horse_trace_matches_oracle(horse_small):
    ref, tr1 = horse_small
    want_p, want_errs = oracle.icp(ref, tr1, 25)
    cfg = ICPConfig(max_iter=25, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    tr = icp(ref, tr1, cfg, trace=True)
    got = np.asarray(tr.errs)[: int(tr.result.iters)]
    assert int(tr.result.iters) == len(want_errs)
    np.testing.assert_allclose(got, want_errs, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(tr.result.points), want_p, atol=1e-8)


def test_horse_f32_matches_f64_plateau(horse_small):
    """The f32 fast path must land on the same plateau as f64."""
    ref, tr1 = horse_small
    cfg64 = ICPConfig(max_iter=25, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    cfg32 = ICPConfig(max_iter=25, dtype=jnp.float32, solver="qcp", nn_method="bcast")
    r64 = icp(ref, tr1, cfg64)
    r32 = icp(ref, tr1, cfg32)
    # errors agree to f32-level relative tolerance
    assert abs(float(r32.err) - float(r64.err)) / float(r64.err) < 1e-2
