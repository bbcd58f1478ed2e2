"""Trimmed (robust) ICP: outlier rejection the reference lacks."""

import jax.numpy as jnp
import numpy as np

from icp_tpu import ICPConfig, icp
from tests.conftest import random_rotation


def _make_outlier_problem(rng, n=400, n_out=80):
    """Model + transformed scene where the scene carries gross outliers."""
    world = rng.standard_normal((n, 3))
    R = random_rotation(rng)
    # small rotation (stay in ICP's basin)
    R = np.linalg.svd(np.eye(3) + 0.1 * (R - np.eye(3)))[0] @ \
        np.linalg.svd(np.eye(3) + 0.1 * (R - np.eye(3)))[2]
    t = np.array([0.2, -0.1, 0.15])
    scene = world @ R.T + t
    # corrupt some scene points with gross outliers
    scene_bad = scene.copy()
    scene_bad[:n_out] += 5.0 + rng.standard_normal((n_out, 3))
    return world, scene_bad, R, t


def test_trimmed_rejects_outliers(rng):
    world, scene, R, t = _make_outlier_problem(np.random.default_rng(11))
    base = dict(max_iter=60, dtype=jnp.float64, solver="eigh",
                nn_method="bcast", with_scale=False, validate_inputs=False)
    vanilla = icp(world, scene, ICPConfig(**base))
    trimmed = icp(world, scene, ICPConfig(**base, trim_fraction=0.3))
    # the scene->model inverse transform should be recovered by trimmed ICP
    R_err_v = np.abs(np.asarray(vanilla.transform.R) @ R - np.eye(3)).max()
    R_err_t = np.abs(np.asarray(trimmed.transform.R) @ R - np.eye(3)).max()
    assert R_err_t < 1e-4, R_err_t
    assert R_err_t < R_err_v  # and strictly better than vanilla
    # inliers land on the model
    reg = np.asarray(trimmed.points)[80:]
    d = np.sqrt(((reg - world[80:]) ** 2).sum(1))
    assert np.median(d) < 1e-6


def test_trim_zero_is_bitwise_reference_path(cow_pair):
    """trim_fraction=0.0 must compile to the exact untrimmed program."""
    ref, tr1 = cow_pair
    ref, tr1 = np.ascontiguousarray(ref[::20]), np.ascontiguousarray(tr1[::20])
    base = dict(max_iter=10, dtype=jnp.float64, solver="eigh", nn_method="bcast")
    a = icp(ref, tr1, ICPConfig(**base), trace=True)
    b = icp(ref, tr1, ICPConfig(**base, trim_fraction=0.0), trace=True)
    np.testing.assert_array_equal(np.asarray(a.errs), np.asarray(b.errs))


def test_trimmed_pallas_path_interpret(cow_pair, rng):
    """Trimming works through the dense kernel + qcp path too."""
    world, scene, R, t = _make_outlier_problem(np.random.default_rng(11), n=256, n_out=40)
    cfg = ICPConfig(max_iter=60, dtype=jnp.float32, solver="qcp",
                    nn_method="pallas", with_scale=False,
                    validate_inputs=False, trim_fraction=0.3)
    res = icp(world, scene, cfg)
    R_err = np.abs(np.asarray(res.transform.R) @ R - np.eye(3)).max()
    assert R_err < 1e-3


def test_trimmed_sharded_matches_single(rng):
    """Sharded trimmed ICP (distributed histogram quantile) recovers the
    outlier-corrupted transform like the single-device quantile path."""
    import jax

    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import icp_sharded

    world, scene, R, t = _make_outlier_problem(np.random.default_rng(11))
    base = dict(max_iter=60, dtype=jnp.float64, solver="eigh",
                nn_method="bcast", with_scale=False, validate_inputs=False,
                trim_fraction=0.3)
    single = icp(world, scene, ICPConfig(**base))
    mesh = make_mesh(jax.devices()[:8])
    sharded = icp_sharded(world, scene, ICPConfig(**base), mesh=mesh, ring=True)
    R_err = np.abs(np.asarray(sharded.transform.R) @ R - np.eye(3)).max()
    assert R_err < 1e-3, R_err
    # the approximate quantile may differ from jnp.quantile at the margin;
    # both must land on the same transform
    np.testing.assert_allclose(
        np.asarray(sharded.transform.t), np.asarray(single.transform.t),
        atol=1e-3,
    )


def test_trimmed_sharded_2d_matches_single(rng):
    """Trim on the 2-D (sp, mp) mesh (quantile over sp; scene rows replicated
    over mp) recovers the same transform as the single-device path."""
    import jax

    from icp_tpu.parallel.sharded import icp_sharded_2d, make_mesh_2d

    world, scene, R, t = _make_outlier_problem(np.random.default_rng(11))
    base = dict(max_iter=60, dtype=jnp.float64, solver="eigh",
                nn_method="bcast", with_scale=False, validate_inputs=False,
                trim_fraction=0.3)
    single = icp(world, scene, ICPConfig(**base))
    mesh = make_mesh_2d(4, 2, jax.devices()[:8])
    sharded = icp_sharded_2d(world, scene, ICPConfig(**base), mesh=mesh)
    R_err = np.abs(np.asarray(sharded.transform.R) @ R - np.eye(3)).max()
    assert R_err < 1e-3, R_err
    np.testing.assert_allclose(
        np.asarray(sharded.transform.t), np.asarray(single.transform.t),
        atol=1e-3,
    )


def test_histogram_quantile_brackets_exact(rng):
    from icp_tpu.ops.quantile import histogram_quantile

    d2 = jnp.asarray(rng.gamma(2.0, 1.0, 4096), jnp.float64)
    rng_width = float(jnp.max(d2))
    for q in (0.5, 0.7, 0.9, 0.999):
        tau = float(histogram_quantile(d2, q))
        kept = float(jnp.sum(d2 <= tau)) / d2.shape[0]
        assert kept >= q  # never trims more than asked (the hard guarantee)
        # value-side guarantee: tau is the upper edge of a bracket of width
        # <= range/32^2 containing the count-based order statistic
        # x_(ceil(q*n)) (NOT the interpolated np.quantile — in a sparse tail
        # the interpolation point can sit a whole inter-sample gap below)
        k = int(np.ceil(q * d2.shape[0]))
        x_k = float(np.sort(np.asarray(d2))[k - 1])
        assert x_k <= tau * (1 + 1e-12)
        assert tau - x_k <= rng_width / 32**2 * (1 + 1e-6), (q, tau, x_k)


def test_histogram_quantile_mask_excludes_rows(rng):
    from icp_tpu.ops.quantile import histogram_quantile

    d2 = jnp.asarray(rng.gamma(2.0, 1.0, 1000), jnp.float64)
    w = jnp.ones(1000, jnp.float64).at[::3].set(0.0)
    # huge values on masked rows must not move tau at all
    d2_poison = d2.at[::3].set(1e30)
    t1 = float(histogram_quantile(d2, 0.8, w))
    t2 = float(histogram_quantile(d2_poison, 0.8, w))
    assert t1 == t2


def test_trimmed_single_trace_equals_sharded_trace(rng):
    """Single-device trim now uses the same histogram quantile as the
    sharded engines; w is 0/1 so histogram counts are exact integers and
    tau is bit-identical across shardings -> traces must agree."""
    import jax

    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import icp_sharded

    world, scene, R, t = _make_outlier_problem(np.random.default_rng(11))
    base = dict(max_iter=60, dtype=jnp.float64, solver="eigh",
                nn_method="bcast", with_scale=False, validate_inputs=False,
                trim_fraction=0.3)
    single = icp(world, scene, ICPConfig(**base), trace=True)
    mesh = make_mesh(jax.devices()[:8])
    sharded = icp_sharded(world, scene, ICPConfig(**base), mesh=mesh,
                          ring=True, trace=True)
    it = int(sharded.result.iters)
    assert it == int(single.result.iters)
    np.testing.assert_allclose(np.asarray(sharded.errs)[:it],
                               np.asarray(single.errs)[:it],
                               rtol=1e-9, atol=1e-18)
