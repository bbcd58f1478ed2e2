"""Exact kNN in plain XLA (``ops/knn.py``): oracle parity, ties, ragged
shapes, the kd-grid path and its overflow fallback (SURVEY.md §4b)."""

import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu.kernels.nn_grid import build_model_grid
from icp_tpu.ops.knn import _topk_lex, knn, knn_dense, knn_grid


def _oracle_knn(query, points, k):
    """NumPy oracle: k smallest (d2, idx) lexicographic per query row."""
    d2 = ((query[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]  # stable = lowest-index ties
    return np.take_along_axis(d2, idx, axis=1), idx


@pytest.mark.parametrize("n,m,k", [(64, 64, 4), (100, 130, 8), (257, 513, 17)])
def test_knn_matches_oracle(rng, n, m, k):
    q = rng.standard_normal((n, 3)).astype(np.float32)
    p = rng.standard_normal((m, 3)).astype(np.float32)
    d2, idx = knn_dense(q, p, k)
    od2, oidx = _oracle_knn(q, p, k)
    np.testing.assert_array_equal(np.asarray(idx), oidx)
    np.testing.assert_allclose(np.asarray(d2), od2, rtol=1e-5, atol=1e-6)


def test_knn_tie_breaks_to_lowest_index(rng):
    # duplicate points: ties must pick the lowest index
    base = rng.standard_normal((40, 3)).astype(np.float32)
    p = np.concatenate([base, base[::-1]], axis=0)  # every point duplicated
    q = base[:16] + 1e-8
    d2, idx = knn_dense(q, p, 4)
    od2, oidx = _oracle_knn(q, p, 4)
    np.testing.assert_array_equal(np.asarray(idx), oidx)


def test_knn_self_query(rng):
    # query == points: nearest neighbor of each point is itself (d2 = 0)
    p = rng.standard_normal((70, 3)).astype(np.float32)
    d2, idx = knn_dense(p, p, 3)
    np.testing.assert_array_equal(np.asarray(idx)[:, 0], np.arange(70))
    np.testing.assert_allclose(np.asarray(d2)[:, 0], 0.0)


@pytest.mark.parametrize("method", ["dense", "grid"])
def test_knn_k_exceeds_points_raises(rng, method):
    p = rng.standard_normal((5, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        knn(jnp.asarray(p), 6, method=method)


def test_topk_lex_orders_ties_by_index(rng):
    # positions deliberately NOT in index order: ties at the k-th distance
    # must still go to the lowest indices, and the output be lexicographic
    d = np.array([[3.0, 1.0, 2.0, 1.0, 2.0, 2.0, 5.0]], np.float32)
    gi = np.array([[9, 7, 6, 2, 4, 1, 0]], np.int32)
    out_d, out_i = _topk_lex(jnp.asarray(d), jnp.asarray(gi), 4)
    np.testing.assert_array_equal(np.asarray(out_i), [[2, 7, 1, 4]])
    np.testing.assert_array_equal(np.asarray(out_d), [[1.0, 1.0, 2.0, 2.0]])
    # random rows vs a lexsort oracle
    d = rng.integers(0, 4, (20, 30)).astype(np.float32)
    gi = np.stack([rng.permutation(30) for _ in range(20)]).astype(np.int32)
    out_d, out_i = _topk_lex(jnp.asarray(d), jnp.asarray(gi), 7)
    for r in range(20):
        order = np.lexsort((gi[r], d[r]))[:7]
        np.testing.assert_array_equal(np.asarray(out_i)[r], gi[r][order])


def test_normals_use_knn(rng):
    """estimate_normals on a noisy plane recovers the plane normal."""
    from icp_tpu.ops.normals import estimate_normals

    xy = rng.uniform(-1, 1, (300, 2))
    pts = np.column_stack([xy, 1e-3 * rng.standard_normal(300)])
    n = np.asarray(estimate_normals(jnp.asarray(pts, jnp.float32), k=12))
    assert np.all(np.abs(n[:, 2]) > 0.99)


def _sphere(n, seed):
    r = np.random.default_rng(seed)
    v = r.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v + 0.01 * r.standard_normal((n, 3))).astype(np.float32)


def test_knn_grid_matches_dense(rng):
    pts = _sphere(900, 0)
    q = jnp.asarray(_sphere(300, 1))
    grid = build_model_grid(jnp.asarray(pts), target_tile=128)
    d_g, i_g = knn_grid(q, grid, 8, scene_tile=64, max_candidates=16)
    d_d, i_d = knn_dense(q, jnp.asarray(pts), 8)
    np.testing.assert_array_equal(np.asarray(i_g), np.asarray(i_d))
    np.testing.assert_allclose(np.asarray(d_g), np.asarray(d_d), rtol=1e-6)


def test_knn_grid_tie_break(rng):
    base = _sphere(200, 2)
    pts = np.concatenate([base, base[::-1]], axis=0)  # duplicates far apart
    q = jnp.asarray(base[:100])
    grid = build_model_grid(jnp.asarray(pts), target_tile=64)
    d_g, i_g = knn_grid(q, grid, 6, scene_tile=32, max_candidates=32)
    d_d, i_d = knn_dense(q, jnp.asarray(pts), 6)
    np.testing.assert_array_equal(np.asarray(i_g), np.asarray(i_d))


def test_knn_grid_overflow_falls_back_dense(rng):
    # capacity 1 forces the whole-model pass on (almost) every tile
    pts = _sphere(600, 3)
    q = jnp.asarray(_sphere(200, 4))
    grid = build_model_grid(jnp.asarray(pts), target_tile=64)
    d_g, i_g = knn_grid(q, grid, 5, scene_tile=32, max_candidates=1)
    d_d, i_d = knn_dense(q, jnp.asarray(pts), 5)
    np.testing.assert_array_equal(np.asarray(i_g), np.asarray(i_d))
    np.testing.assert_allclose(np.asarray(d_g), np.asarray(d_d), rtol=1e-6)


def test_knn_grid_rows_in_caller_order(rng):
    # the grid path kd-sorts the queries internally; rows must come back
    # in the caller's order with the same answer as the dense path
    pts = jnp.asarray(_sphere(700, 5))
    d_g, i_g = knn(pts, 7, method="grid", scene_tile=32, model_tile=64)
    d_d, i_d = knn(pts, 7, method="dense")
    np.testing.assert_array_equal(np.asarray(i_g), np.asarray(i_d))
    np.testing.assert_array_equal(np.asarray(i_g)[:, 0], np.arange(700))
