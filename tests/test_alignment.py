"""Alignment-solve tests: oracle parity, exact transform recovery, and the
three eigen solvers (eigh / qcp / kabsch) agreeing with each other."""

import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu.ops import alignment as al
from icp_tpu.ops.transform import apply_similarity
from tests import oracle
from tests.conftest import random_rotation

SOLVERS = ["eigh", "qcp", "kabsch"]


def _rot_distance(Ra, Rb):
    """Geodesic-ish distance: max abs elementwise difference."""
    return np.abs(np.asarray(Ra) - np.asarray(Rb)).max()


def test_quat_to_rot_matches_reference_construction(rng):
    for _ in range(10):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        want = oracle.quat_to_rot_reference(q)
        got = np.asarray(al.quat_to_rot(jnp.asarray(q)))
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_horn_n_matrix_symmetric_traceless(rng):
    S = jnp.asarray(rng.standard_normal((3, 3)))
    N = np.asarray(al.horn_n_matrix(S))
    np.testing.assert_allclose(N, N.T, atol=1e-15)
    assert abs(np.trace(N)) < 1e-12


@pytest.mark.parametrize("solver", SOLVERS)
def test_exact_similarity_recovery(solver, rng):
    rot_tol, t_tol, err_tol = 1e-7, 1e-8, 1e-16
    for trial in range(5):
        p = rng.standard_normal((40, 3))
        R = random_rotation(rng)
        s = float(rng.uniform(0.5, 2.0))
        t = rng.standard_normal(3)
        y = s * (p @ R.T) + t
        sim, err = al.find_alignment(
            jnp.asarray(p), jnp.asarray(y), solver=solver, with_scale=True
        )
        assert abs(float(sim.s) - s) < 1e-8
        assert _rot_distance(sim.R, R) < rot_tol
        np.testing.assert_allclose(np.asarray(sim.t), t, atol=t_tol)
        assert float(err) < err_tol


@pytest.mark.parametrize("solver", SOLVERS)
def test_matches_oracle_on_noisy_pairs(solver, rng):
    # Noisy correspondences: all solvers must produce the oracle's optimum.
    p = rng.standard_normal((100, 3))
    R = random_rotation(rng)
    y = 1.3 * (p @ R.T) + np.array([1.0, 2.0, 3.0]) + 0.05 * rng.standard_normal((100, 3))
    s_o, R_o, t_o, err_o = oracle.find_alignment(p, y)
    sim, err = al.find_alignment(jnp.asarray(p), jnp.asarray(y), solver=solver)
    assert abs(float(sim.s) - s_o) < 1e-6
    assert _rot_distance(sim.R, R_o) < 1e-5
    np.testing.assert_allclose(np.asarray(sim.t), t_o, atol=1e-5)
    np.testing.assert_allclose(float(err), err_o, rtol=1e-6)


def test_qcp_matches_eigh_f32(rng):
    # The f32 QCP fast path must agree with eigh to f32 tolerance.
    for _ in range(10):
        p = rng.standard_normal((64, 3)).astype(np.float32)
        R = random_rotation(rng).astype(np.float32)
        y = (p @ R.T + 0.1 * rng.standard_normal((64, 3))).astype(np.float32)
        sim_e, _ = al.find_alignment(jnp.asarray(p), jnp.asarray(y), solver="eigh")
        sim_q, _ = al.find_alignment(jnp.asarray(p), jnp.asarray(y), solver="qcp")
        assert _rot_distance(sim_e.R, sim_q.R) < 5e-4
        assert abs(float(sim_e.s) - float(sim_q.s)) < 1e-5


@pytest.mark.parametrize("solver", ["qcp", "eigh"])
def test_qcp_no_overflow_at_scale(solver, rng):
    """Large clouds/coordinates make |S| ~ 1e8; the adjugate's squared
    cofactor norms (~1e48) overflowed f32 to NaN before scale normalization
    (regression: found on a 1M-point run)."""
    p = (rng.standard_normal((10_000, 3)) * 100.0).astype(np.float32)
    R = random_rotation(rng).astype(np.float32)
    y = (p @ R.T + np.float32(5.0)).astype(np.float32)
    sim, err = al.find_alignment(
        jnp.asarray(p, jnp.float32), jnp.asarray(y, jnp.float32), solver=solver
    )
    assert np.isfinite(np.asarray(sim.R)).all()
    assert np.isfinite(float(err))
    assert _rot_distance(sim.R, R) < 1e-4


def test_stats_shift_identity(rng):
    # alignment_from_stats must equal the directly-centered computation.
    p = rng.standard_normal((30, 3)) + 5.0  # offset to stress the shift form
    y = rng.standard_normal((30, 3)) - 3.0
    stats = al.compute_alignment_stats(jnp.asarray(p), jnp.asarray(y))
    sim = al.alignment_from_stats(stats, solver="eigh")
    s_o, R_o, t_o, _ = oracle.find_alignment(p, y)
    assert abs(float(sim.s) - s_o) < 1e-9
    np.testing.assert_allclose(np.asarray(sim.R), R_o, atol=1e-9)
    np.testing.assert_allclose(np.asarray(sim.t), t_o, atol=1e-8)


def test_rigid_mode_keeps_unit_scale(rng):
    p = rng.standard_normal((20, 3))
    y = 2.0 * p  # scale-2 data
    sim, _ = al.find_alignment(jnp.asarray(p), jnp.asarray(y), with_scale=False)
    assert float(sim.s) == 1.0


def test_apply_similarity_matches_reference_order(rng):
    # y = s * R @ p + t with rows-as-points layout.
    p = rng.standard_normal((5, 3))
    R = random_rotation(rng)
    sim = al.Similarity(jnp.asarray(2.0), jnp.asarray(R), jnp.asarray([1.0, 0.0, -1.0]))
    got = np.asarray(apply_similarity(jnp.asarray(p), sim))
    want = (2.0 * (R @ p.T) + np.array([1.0, 0.0, -1.0])[:, None]).T
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("solver", ["qcp", "kabsch", "eigh"])
def test_degenerate_identical_points(solver):
    """All-identical correspondences: S is rank-0, the adjugate collapses —
    the rescue path must produce a finite (identity-ish) rotation, not NaN."""
    p = jnp.ones((10, 3), jnp.float32)
    y = jnp.full((10, 3), 2.0, jnp.float32)
    sim, err = al.find_alignment(p, y, solver=solver, with_scale=False)
    assert np.isfinite(np.asarray(sim.R)).all()
    assert np.isfinite(np.asarray(sim.t)).all()
    # translation alone must map p onto y
    np.testing.assert_allclose(
        np.asarray(sim.R @ np.ones(3) + np.asarray(sim.t)), np.full(3, 2.0),
        atol=1e-5,
    )


@pytest.mark.parametrize("solver", ["qcp", "eigh"])
def test_degenerate_collinear_points(solver, rng):
    """Collinear clouds (rank-1 covariance): rotation about the line is
    unobservable, but the solve must stay finite and map the line onto the
    line."""
    t_param = np.linspace(-1, 1, 50)[:, None]
    d = np.array([[1.0, 2.0, -0.5]])
    p = (t_param * d).astype(np.float32)
    y = (t_param * d + np.array([[0.3, -0.1, 0.2]])).astype(np.float32)
    sim, err = al.find_alignment(jnp.asarray(p), jnp.asarray(y), solver=solver,
                                 with_scale=False)
    assert np.isfinite(np.asarray(sim.R)).all()
    moved = np.asarray(p) @ np.asarray(sim.R).T + np.asarray(sim.t)
    assert np.abs(moved - y).max() < 1e-3
