"""Spatially-pruned NN (kernels/nn_grid.py) + grid ICP engine tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu import ICPConfig, icp
from icp_tpu.kernels.nn_grid import (
    bound_from_indices,
    build_model_grid,
    closest_point_indices_grid,
    closest_point_indices_pruned,
    initial_bound_indices,
    kd_order,
)
from tests.conftest import random_rotation


def _oracle_nn(scene, model):
    d2 = ((scene[:, None, :] - model[None, :, :]) ** 2).sum(-1)
    return d2.argmin(1)  # numpy argmin: first occurrence = lowest index


def _sphere(n, noise=0.01, seed=0):
    r = np.random.default_rng(seed)
    v = r.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v + noise * r.standard_normal((n, 3))).astype(np.float32)


def test_kd_order_is_permutation(rng):
    pts = jnp.asarray(rng.standard_normal((64, 3)), jnp.float32)
    perm = np.asarray(kd_order(pts, 3))
    assert sorted(perm) == list(range(64))


def test_kd_order_tiles_are_compact(rng):
    # kd tiles of a 2-D grid-ish cloud must be far tighter than random order
    pts = rng.uniform(0, 1, (256, 3)).astype(np.float32)
    pts[:, 2] *= 0.01  # a flat sheet
    perm = np.asarray(kd_order(jnp.asarray(pts), 4))  # 16 tiles of 16
    tiles = pts[perm].reshape(16, 16, 3)
    ext = (tiles.max(1) - tiles.min(1)).max(-1)
    assert ext.mean() < 0.45  # random tiling would be ~1.0


@pytest.mark.parametrize("n,m", [(500, 800), (1000, 1000)])
@pytest.mark.slow
def test_pruned_matches_oracle_with_fallback(rng, n, m):
    model = _sphere(m, seed=1)
    scene = _sphere(n, seed=2) * 1.02 + np.float32([0.01, -0.02, 0.005])
    grid = build_model_grid(jnp.asarray(model), target_tile=128)
    prev = initial_bound_indices(jnp.asarray(scene), jnp.asarray(model), stride=8,
                                 interpret=True)
    u = bound_from_indices(jnp.asarray(scene), grid, prev)
    idx, y, _, d2 = closest_point_indices_grid(
        jnp.asarray(scene), grid, u, scene_tile=64, max_candidates=16,
        interpret=True,
    )
    want = _oracle_nn(scene, model)
    np.testing.assert_array_equal(np.asarray(idx), want)
    # matched points == gathered winners
    np.testing.assert_array_equal(np.asarray(y), model[want])
    np.testing.assert_allclose(
        np.asarray(d2), np.sum((scene - model[want]) ** 2, axis=1), rtol=1e-5
    )


@pytest.mark.slow
def test_pruned_exact_when_not_overflowing(rng):
    """With tight bounds (prev = true NN) the pruned path itself must be
    exact — this pins the culling math, not just the fallback."""
    model = _sphere(2000, seed=3)
    scene = model + np.float32(1e-3) * rng.standard_normal((2000, 3)).astype(np.float32)
    oracle = _oracle_nn(scene, model)
    # kd-sort the scene for coherent tiles (what the engine does)
    perm = np.asarray(kd_order(jnp.asarray(scene), 4))
    s = scene[perm]
    grid = build_model_grid(jnp.asarray(model), target_tile=256)
    u = bound_from_indices(
        jnp.asarray(s), grid, jnp.asarray(oracle[perm], jnp.int32)
    )
    idx, y, _, _, overflow = closest_point_indices_pruned(
        jnp.asarray(s), grid, u, scene_tile=125, max_candidates=16, interpret=True,
    )
    assert not bool(overflow), "expected no overflow with tight bounds"
    np.testing.assert_array_equal(np.asarray(idx), oracle[perm])
    np.testing.assert_array_equal(np.asarray(y), model[oracle[perm]])


def test_pruned_tie_break_lowest_original_index(rng):
    # duplicated model points land in different kd tiles; ties must resolve
    # to the lowest ORIGINAL index exactly like the dense kernels
    base = _sphere(300, seed=4)
    model = np.concatenate([base, base], axis=0)  # every point duplicated
    scene = base[:100]
    grid = build_model_grid(jnp.asarray(model), target_tile=128)
    prev = initial_bound_indices(jnp.asarray(scene), jnp.asarray(model), stride=4,
                                 interpret=True)
    u = bound_from_indices(jnp.asarray(scene), grid, prev)
    idx, _, _, _ = closest_point_indices_grid(
        jnp.asarray(scene), grid, u, scene_tile=32, max_candidates=32,
        interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(idx), _oracle_nn(scene, model))


def test_icp_grid_converges_like_dense(cow_pair):
    ref, tr1 = cow_pair
    cfg_dense = ICPConfig(max_iter=30, nn_method="bcast", solver="eigh")
    cfg_grid = ICPConfig(max_iter=30, nn_method="grid", solver="eigh")
    a = icp(ref, tr1, cfg_dense)
    b = icp(ref, tr1, cfg_grid)
    assert float(b.err) < 1e-5
    assert int(b.iters) == int(a.iters)
    np.testing.assert_allclose(
        np.asarray(b.points), np.asarray(a.points), atol=1e-4
    )
    # returned in the caller's row order
    np.testing.assert_allclose(
        np.asarray(b.points), np.asarray(ref), atol=1e-3
    )


def test_icp_grid_trace_and_trim(rng):
    from tests.test_trimmed import _make_outlier_problem

    world, scene_bad, R, t = _make_outlier_problem(np.random.default_rng(11))
    cfg = ICPConfig(max_iter=60, nn_method="grid", solver="eigh",
                    dtype=jnp.float64, with_scale=False,
                    validate_inputs=False, trim_fraction=0.3)
    tr = icp(world, scene_bad, cfg, trace=True)
    errs = np.asarray(tr.errs)[: int(tr.result.iters)]
    assert errs[-1] < errs[0]
    reg = np.asarray(tr.result.points)[80:]
    d = np.sqrt(((reg - world[80:]) ** 2).sum(1))
    assert np.median(d) < 1e-6


def test_icp_grid_matches_dense_trace(cow_pair):
    """Grid engine error trace == dense engine error trace (same
    correspondences — only the search is pruned; residual differences come
    from the kd-reordered summation order and the kernels' f32 geometry)."""
    ref, tr1 = cow_pair
    base = dict(max_iter=10, dtype=jnp.float64, solver="eigh")
    a = icp(ref, tr1, ICPConfig(**base, nn_method="bcast"), trace=True)
    b = icp(ref, tr1, ICPConfig(**base, nn_method="grid"), trace=True)
    assert int(a.result.iters) == int(b.result.iters)
    np.testing.assert_allclose(
        np.asarray(a.errs), np.asarray(b.errs), rtol=1e-4, atol=1e-11
    )


def test_payload_emission_matches_gather(rng):
    # normals packed as grid payload: the winning payload must equal an
    # explicit gather by the winning index, through both the pruned path
    # and the overflow (fold-everything) path
    model = _sphere(700, seed=9)
    payload = rng.standard_normal((700, 3)).astype(np.float32)
    scene = _sphere(300, seed=10) * 1.01
    grid = build_model_grid(jnp.asarray(model), target_tile=128,
                            payload=jnp.asarray(payload))
    prev = initial_bound_indices(jnp.asarray(scene), jnp.asarray(model), stride=8,
                                 interpret=True)
    u = bound_from_indices(jnp.asarray(scene), grid, prev)
    idx, y, pl, d2 = closest_point_indices_grid(
        jnp.asarray(scene), grid, u, scene_tile=64, max_candidates=16,
        interpret=True,
    )
    want = _oracle_nn(scene, model)
    np.testing.assert_array_equal(np.asarray(idx), want)
    np.testing.assert_array_equal(np.asarray(pl), payload[want])
    # force the overflow path: infinite bounds + cap=1
    idx2, y2, pl2, _ = closest_point_indices_grid(
        jnp.asarray(scene), grid, jnp.full((300,), 3.0e38, jnp.float32),
        scene_tile=64, max_candidates=1, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(idx2), want)
    np.testing.assert_array_equal(np.asarray(pl2), payload[want])


def test_next_bound_f64_cancellation_stays_valid():
    # ADVICE r2 #1: an f64 residual can cancel BELOW the f32 distance to the
    # same matched point; using it (downcast) as the culling bound could
    # prune the tile holding the true f32 NN.  next_bound computes from the
    # f32-cast pair, so it can never undercut what the kernel measures.
    from icp_tpu.kernels.nn_grid import _UPPER_INFLATE, next_bound

    y = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float64)
    # rounds to f32 1 + 2^-23 but sits 1.5*2^-24 away in f64
    p = jnp.asarray([[1.0 + 1.5 * 2.0 ** -24, 0.0, 0.0]], jnp.float64)
    f32_d2 = float(jnp.sum((y.astype(jnp.float32) - p.astype(jnp.float32)) ** 2))
    old_bound = float(jnp.sum((y - p) ** 2).astype(jnp.float32))
    assert old_bound * _UPPER_INFLATE < f32_d2  # the hazard the fix removes
    assert float(next_bound(y, p)[0]) >= f32_d2
