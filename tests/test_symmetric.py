"""Symmetric-objective ICP (engine/symmetric.py) — Rusinkiewicz 2019.

No reference counterpart; correctness is pinned against ground-truth rigid
transforms and against the point-to-plane engine's behavior on the same
problems.
"""

import numpy as np
import pytest

from tests.conftest import data_path


def _surface(rng, n=600):
    """Smooth curved surface z = f(x, y) — normals well-defined, the case
    the plane metrics are built for."""
    xy = rng.uniform(-1.0, 1.0, (n, 2))
    z = 0.3 * np.sin(2.0 * xy[:, 0]) + 0.2 * xy[:, 1] ** 2
    return np.column_stack([xy, z])


def _rigid(rng, angle):
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    t = rng.standard_normal(3) * 0.05
    return R, t


def test_recovers_ground_truth_rigid():
    from icp_tpu import ICPConfig, icp_symmetric

    rng = np.random.default_rng(3)
    model = _surface(rng)
    R, t = _rigid(rng, 0.12)
    scene = model @ R.T + t  # same samples => exact correspondence exists

    cfg = ICPConfig(max_iter=50, threshold=1e-12, nn_method="bcast",
                    validate_inputs=False)
    res = icp_symmetric(model, scene, cfg)
    assert float(res.err) < 1e-9
    np.testing.assert_allclose(np.asarray(res.points), model, atol=1e-4)
    # recovered transform inverts the applied one
    np.testing.assert_allclose(np.asarray(res.transform.R), R.T, atol=1e-3)


def test_trace_monotone_and_matches_result():
    from icp_tpu import ICPConfig, icp_symmetric

    rng = np.random.default_rng(5)
    model = _surface(rng)
    R, t = _rigid(rng, 0.1)
    scene = model @ R.T + t
    cfg = ICPConfig(max_iter=30, threshold=1e-12, nn_method="bcast",
                    validate_inputs=False)
    tr = icp_symmetric(model, scene, cfg, trace=True)
    iters = int(tr.result.iters)
    errs = np.asarray(tr.errs)[:iters]
    assert np.isfinite(errs).all()
    assert errs[-1] == pytest.approx(float(tr.result.err))
    assert errs[-1] < errs[0]


def test_converges_at_least_as_fast_as_p2pl_on_curved_surface():
    """The symmetric objective is exact on second-order surfaces where
    point-to-plane is first-order — it must not need MORE iterations."""
    from icp_tpu import ICPConfig, icp_point_to_plane, icp_symmetric
    from icp_tpu.ops.normals import estimate_normals

    rng = np.random.default_rng(7)
    model = _surface(rng, n=800)
    R, t = _rigid(rng, 0.25)
    scene = model @ R.T + t

    cfg = ICPConfig(max_iter=60, threshold=1e-10, nn_method="bcast",
                    validate_inputs=False)
    nrm = estimate_normals(np.asarray(model, np.float32), k=16)
    sym = icp_symmetric(model, scene, cfg, normals=nrm)
    p2pl = icp_point_to_plane(model, scene, cfg, normals=nrm)
    # both should land on the model; symmetric in no more iterations
    assert float(sym.err) < 1e-8
    assert int(sym.iters) <= int(p2pl.iters)


def test_sign_flipped_model_normals_are_canonicalized():
    """PCA normal signs are arbitrary; flipping every model normal must not
    change the result (the per-pair sign canonicalization absorbs it)."""
    from icp_tpu import ICPConfig, icp_symmetric
    from icp_tpu.ops.normals import estimate_normals

    rng = np.random.default_rng(11)
    model = _surface(rng)
    R, t = _rigid(rng, 0.1)
    scene = model @ R.T + t
    cfg = ICPConfig(max_iter=40, threshold=1e-12, nn_method="bcast",
                    validate_inputs=False)
    nrm = np.asarray(estimate_normals(np.asarray(model, np.float32), k=16))
    a = icp_symmetric(model, scene, cfg, normals=nrm)
    b = icp_symmetric(model, scene, cfg, normals=-nrm)
    np.testing.assert_allclose(np.asarray(a.points), np.asarray(b.points),
                               atol=1e-6)


def test_trimmed_ignores_outliers():
    from icp_tpu import ICPConfig, icp_symmetric

    rng = np.random.default_rng(13)
    model = _surface(rng, n=500)
    R, t = _rigid(rng, 0.08)
    scene = model @ R.T + t
    # corrupt 10% of the scene with far-away garbage
    bad = rng.choice(len(scene), size=50, replace=False)
    scene = scene.copy()
    scene[bad] += rng.standard_normal((50, 3)) * 5.0 + 10.0

    cfg = ICPConfig(max_iter=50, threshold=1e-12, nn_method="bcast",
                    validate_inputs=False, trim_fraction=0.2)
    res = icp_symmetric(model, scene, cfg)
    good = np.setdiff1d(np.arange(len(scene)), bad)
    dev = np.linalg.norm(np.asarray(res.points)[good] - model[good], axis=1)
    assert np.median(dev) < 1e-3


def test_wider_basin_than_p2pl_at_large_rotation():
    """The motivating property: at a rotation angle where point-to-plane
    falls into a wrong minimum, symmetric still registers.  The angle was
    chosen by scanning; the assertion is one-sided (symmetric succeeds) so
    a p2pl improvement cannot break the test."""
    from icp_tpu import ICPConfig, icp_symmetric

    rng = np.random.default_rng(17)
    model = _surface(rng, n=800)
    R, t = _rigid(rng, 0.6)  # ~34 degrees
    scene = model @ R.T + t
    cfg = ICPConfig(max_iter=120, threshold=1e-12, nn_method="bcast",
                    validate_inputs=False)
    sym = icp_symmetric(model, scene, cfg)
    dev = np.linalg.norm(np.asarray(sym.points) - model, axis=1)
    assert np.median(dev) < 1e-3


def test_init_warm_start_composes():
    from icp_tpu import ICPConfig, icp_symmetric
    from icp_tpu.ops.alignment import Similarity

    rng = np.random.default_rng(19)
    model = _surface(rng)
    R, t = _rigid(rng, 0.3)
    scene = model @ R.T + t
    # warm-start with the exact inverse: should converge immediately and the
    # RETURNED transform must map the caller's scene onto the model
    import jax.numpy as jnp
    init = Similarity(s=jnp.asarray(1.0, jnp.float32),
                      R=jnp.asarray(R.T, jnp.float32),
                      t=jnp.asarray(-R.T @ t, jnp.float32))
    cfg = ICPConfig(max_iter=20, threshold=1e-10, nn_method="bcast",
                    validate_inputs=False)
    res = icp_symmetric(model, scene, cfg, init=init)
    assert int(res.iters) <= 2
    mapped = scene @ np.asarray(res.transform.R).T + np.asarray(res.transform.t)
    np.testing.assert_allclose(mapped, np.asarray(res.points), atol=1e-5)


def test_cow_pair_registers():
    """Real data smoke: the cow pair (exact rigid+scale transform).  The
    symmetric engine is rigid-only, so assert convergence of the error, not
    exact overlay (cow_tr1's transform may include scale)."""
    from icp_tpu import ICPConfig, icp_symmetric
    from icp_tpu.io.csv import load_matrix

    ref = load_matrix(data_path("cow_ref.txt"))
    tr1 = load_matrix(data_path("cow_tr1.txt"))
    cfg = ICPConfig(max_iter=40, threshold=1e-8, nn_method="bcast")
    tr = icp_symmetric(ref, tr1, cfg, trace=True)
    iters = int(tr.result.iters)
    errs = np.asarray(tr.errs)[:iters]
    assert errs[-1] < 1e-2 * errs[0]


def test_sharded_matches_single_device_trace():
    """8-virtual-device mesh: the sharded engine (ring payload fold, psum'd
    6x6 GN, scene normals sharded with the scene) must reproduce the
    single-device trace."""
    from icp_tpu import ICPConfig, icp_symmetric, icp_symmetric_sharded
    from icp_tpu.ops.normals import estimate_normals

    rng = np.random.default_rng(29)
    model = _surface(rng, n=333)  # odd count exercises padding/masking
    R, t = _rigid(rng, 0.15)
    scene = (model @ R.T + t)[:331]  # unequal counts too
    cfg = ICPConfig(max_iter=25, threshold=1e-12, nn_method="bcast",
                    validate_inputs=False)
    m32 = np.asarray(model, np.float32)
    s32 = np.asarray(scene, np.float32)
    nrm_m = estimate_normals(m32, k=16)
    nrm_s = estimate_normals(s32, k=16)
    single = icp_symmetric(m32, s32, cfg, normals=nrm_m,
                           scene_normals=nrm_s, trace=True)
    sharded = icp_symmetric_sharded(m32, s32, cfg, normals=nrm_m,
                                    scene_normals=nrm_s, trace=True)
    it_a, it_b = int(single.result.iters), int(sharded.result.iters)
    assert it_a == it_b
    np.testing.assert_allclose(
        np.asarray(single.errs)[:it_a], np.asarray(sharded.errs)[:it_b],
        rtol=2e-4, atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(single.result.points), np.asarray(sharded.result.points),
        atol=1e-4,
    )


def test_sharded_trimmed_matches_single_device():
    from icp_tpu import ICPConfig, icp_symmetric, icp_symmetric_sharded
    from icp_tpu.ops.normals import estimate_normals

    rng = np.random.default_rng(31)
    model = _surface(rng, n=300)
    R, t = _rigid(rng, 0.1)
    scene = model @ R.T + t
    bad = rng.choice(len(scene), size=30, replace=False)
    scene = scene.copy()
    scene[bad] += 8.0
    cfg = ICPConfig(max_iter=30, threshold=1e-12, nn_method="bcast",
                    validate_inputs=False, trim_fraction=0.2)
    m32 = np.asarray(model, np.float32)
    s32 = np.asarray(scene, np.float32)
    nrm_m = estimate_normals(m32, k=16)
    nrm_s = estimate_normals(s32, k=16)
    single = icp_symmetric(m32, s32, cfg, normals=nrm_m, scene_normals=nrm_s)
    sharded = icp_symmetric_sharded(m32, s32, cfg, normals=nrm_m,
                                    scene_normals=nrm_s)
    assert int(single.iters) == int(sharded.iters)
    np.testing.assert_allclose(np.asarray(single.points),
                               np.asarray(sharded.points), atol=1e-4)


def test_grid_matches_dense():
    """nn_method="grid" (kd-tile pruned NN, model normals riding the tile
    payload sublanes, scene normals kd-permuted side data) must reproduce
    the dense engine: same iteration count, same registered cloud."""
    from icp_tpu import ICPConfig, icp_symmetric
    from icp_tpu.ops.normals import estimate_normals

    rng = np.random.default_rng(37)
    model = _surface(rng, n=1100)
    R, t = _rigid(rng, 0.15)
    scene = (model @ R.T + t)[:800]  # unequal counts through the grid path
    m32 = np.asarray(model, np.float32)
    s32 = np.asarray(scene, np.float32)
    nrm_m = estimate_normals(m32, k=16)
    nrm_s = estimate_normals(s32, k=16)
    base = dict(max_iter=30, threshold=1e-12, validate_inputs=False)
    dense = icp_symmetric(
        m32, s32, ICPConfig(nn_method="bcast", **base),
        normals=nrm_m, scene_normals=nrm_s, trace=True)
    grid = icp_symmetric(
        m32, s32,
        ICPConfig(nn_method="grid", grid_model_tile=128, grid_scene_tile=64,
                  **base),
        normals=nrm_m, scene_normals=nrm_s, trace=True)
    it_d, it_g = int(dense.result.iters), int(grid.result.iters)
    assert it_g == it_d
    # rtol 1e-3: near the convergence floor the two paths' summation orders
    # differ (kd-permuted vs natural row order) — points must still agree
    np.testing.assert_allclose(
        np.asarray(grid.errs)[:it_g], np.asarray(dense.errs)[:it_d],
        rtol=1e-3, atol=1e-10)
    np.testing.assert_allclose(np.asarray(grid.result.points),
                               np.asarray(dense.result.points), atol=1e-4)


def test_grid_trimmed_ignores_outliers():
    from icp_tpu import ICPConfig, icp_symmetric

    rng = np.random.default_rng(41)
    model = _surface(rng, n=700)
    R, t = _rigid(rng, 0.08)
    scene = model @ R.T + t
    bad = rng.choice(len(scene), size=70, replace=False)
    scene = scene.copy()
    scene[bad] += rng.standard_normal((70, 3)) * 5.0 + 10.0
    cfg = ICPConfig(max_iter=50, threshold=1e-12, nn_method="grid",
                    grid_model_tile=128, grid_scene_tile=64,
                    validate_inputs=False, trim_fraction=0.2)
    res = icp_symmetric(np.asarray(model, np.float32),
                        np.asarray(scene, np.float32), cfg)
    good = np.setdiff1d(np.arange(len(scene)), bad)
    dev = np.linalg.norm(
        np.asarray(res.points)[good] - model[good].astype(np.float32), axis=1)
    assert np.median(dev) < 1e-3


def test_explicit_nn_method_passthrough():
    """An explicit nn_method (here the plain XLA ``blocked`` fold) must
    reach ``closest_point_indices`` and not be silently remapped — on an
    exact-transform problem it registers exactly like ``bcast``."""
    from icp_tpu import ICPConfig, icp_symmetric

    rng = np.random.default_rng(43)
    model = _surface(rng, n=500)
    R, t = _rigid(rng, 0.1)
    scene = model @ R.T + t
    out = {}
    for nn in ("blocked", "bcast"):
        cfg = ICPConfig(max_iter=40, threshold=1e-10, nn_method=nn,
                        validate_inputs=False)
        out[nn] = icp_symmetric(np.asarray(model, np.float32),
                                np.asarray(scene, np.float32), cfg)
    dev = np.linalg.norm(np.asarray(out["blocked"].points)
                         - model.astype(np.float32), axis=1)
    assert np.median(dev) < 1e-2
    assert int(out["blocked"].iters) == int(out["bcast"].iters)
    np.testing.assert_allclose(np.asarray(out["blocked"].points),
                               np.asarray(out["bcast"].points), atol=1e-5)


def test_sharded_grid_matches_single_grid():
    """icp_symmetric_sharded with nn_method="grid" dispatches to the shared
    GN sharded-grid loop — must match the single-device grid engine."""
    import jax

    from icp_tpu import ICPConfig, icp_symmetric, icp_symmetric_sharded
    from icp_tpu.ops.normals import estimate_normals
    from icp_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(47)
    model = _surface(rng, n=1100)
    R, t = _rigid(rng, 0.12)
    scene = (model @ R.T + t)[:801]  # odd count exercises shard padding
    m32 = np.asarray(model, np.float32)
    s32 = np.asarray(scene, np.float32)
    nrm_m = estimate_normals(m32, k=16)
    nrm_s = estimate_normals(s32, k=16)
    cfg = ICPConfig(max_iter=30, threshold=1e-12, nn_method="grid",
                    grid_model_tile=128, grid_scene_tile=64,
                    validate_inputs=False)
    single = icp_symmetric(m32, s32, cfg, normals=nrm_m, scene_normals=nrm_s,
                           trace=True)
    sharded = icp_symmetric_sharded(m32, s32, cfg, normals=nrm_m,
                                    scene_normals=nrm_s,
                                    mesh=make_mesh(), trace=True)
    it_a, it_b = int(single.result.iters), int(sharded.result.iters)
    assert it_a == it_b
    np.testing.assert_allclose(
        np.asarray(single.errs)[:it_a], np.asarray(sharded.errs)[:it_b],
        rtol=2e-4, atol=1e-10)
    np.testing.assert_allclose(np.asarray(single.result.points),
                               np.asarray(sharded.result.points), atol=1e-4)


def test_register_pair_engine_symmetric():
    from icp_tpu.config import ICPConfig
    from icp_tpu.slam.pairwise import register_pair

    rng = np.random.default_rng(23)
    model = _surface(rng, n=400)
    R, t = _rigid(rng, 0.1)
    scene = model @ R.T + t
    cfg = ICPConfig(max_iter=40, threshold=1e-12, nn_method="bcast",
                    validate_inputs=False)
    res = register_pair(model, scene, cfg, engine="symmetric")
    T = res.transform
    mapped = scene @ np.asarray(T.R).T * float(T.s) + np.asarray(T.t)
    np.testing.assert_allclose(mapped, model, atol=1e-3)
