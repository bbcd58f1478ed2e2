"""Seeded property sweep: engine-vs-oracle parity on adversarial geometry.

The targeted suites pin parity on the bundled datasets; this sweep runs the
f64 engine against ``tests/oracle.py`` across random AND degenerate cloud
shapes the datasets never produce — duplicated points (exact argmin ties),
coplanar and near-collinear clouds (rank-deficient covariance), the minimum
legal size (4 points), and clouds with wildly different scales — asserting
the per-iteration error TRACE matches the oracle.  Deterministic seeds;
each case is small so the whole sweep stays in the fast tier.
"""

import zlib

import numpy as np
import pytest

from icp_tpu.config import ICPConfig
from icp_tpu.engine.icp import icp
from tests import oracle

import jax.numpy as jnp  # x64 enabled suite-wide by tests/conftest.py


def _rigid(rng, scale=False):
    a, b, c = rng.uniform(-0.4, 0.4, 3)

    def rot(theta, i, j):
        R = np.eye(3)
        R[i, i] = R[j, j] = np.cos(theta)
        R[i, j], R[j, i] = -np.sin(theta), np.sin(theta)
        return R

    R = rot(a, 0, 1) @ rot(b, 1, 2) @ rot(c, 0, 2)
    s = rng.uniform(0.7, 1.4) if scale else 1.0
    t = rng.uniform(-0.5, 0.5, 3)
    return s, R, t


def _cases():
    rng = np.random.default_rng(20260820)
    cases = []
    # random volumetric clouds, assorted sizes
    for n in (4, 5, 17, 64, 201):
        cases.append(("random", rng.standard_normal((n, 3))))
    # duplicated points: exact distance ties — the lowest-index contract
    base = rng.standard_normal((40, 3))
    cases.append(("duplicates", np.concatenate([base, base[:20], base[:7]])))
    # coplanar (z = 0) and near-collinear clouds: degenerate covariance
    flat = rng.standard_normal((90, 3))
    flat[:, 2] = 0.0
    cases.append(("coplanar", flat))
    line = np.linspace(0.0, 1.0, 60)[:, None] * np.array([1.0, 2.0, -0.5])
    cases.append(("near_collinear", line + 1e-4 * rng.standard_normal((60, 3))))
    # extreme coordinate scale
    cases.append(("big_scale", 1e3 * rng.standard_normal((50, 3))))
    return cases


@pytest.mark.parametrize("name,model", _cases(), ids=lambda c: c if isinstance(c, str) else "")
def test_engine_trace_matches_oracle(name, model):
    # zlib.crc32 is stable across processes (str hash() is salted)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    s, R, t = _rigid(rng, scale=(name == "random"))
    scene = (model @ (s * R).T) + t
    max_iter = 25
    want_p, want_errs = oracle.icp(model, scene, max_iter)

    tr = icp(
        jnp.asarray(model, jnp.float64),
        jnp.asarray(scene, jnp.float64),
        ICPConfig(max_iter=max_iter, dtype=jnp.float64, solver="eigh",
                  nn_method="bcast", validate_inputs=False),
        trace=True,
    )
    got_errs = np.asarray(tr.errs)[: int(tr.result.iters)]
    want = np.asarray(want_errs)
    assert len(got_errs) == len(want), (name, got_errs, want)
    # converged errors are f64 rounding dust proportional to the squared
    # coordinate scale (big_scale: 5.5e-25 vs 3.2e-25 on ~1e3 coords —
    # both zero for every purpose); the contract is trace parity, not
    # bit-equal dust
    coord = float(np.max(np.abs(model))) + 1.0
    np.testing.assert_allclose(got_errs, want, rtol=1e-6,
                               atol=1e-28 * coord * coord, err_msg=name)
    np.testing.assert_allclose(np.asarray(tr.result.points), want_p,
                               rtol=1e-6, atol=1e-9 * coord, err_msg=name)
