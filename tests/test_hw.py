"""Compiled-kernel tests on the GPU.

Every kernel test in the CPU suite runs the Pallas INTERPRETER, which cannot
see what the GPU compiler does: register and shared-memory limits, the
Triton lowering itself, and TF32 products where a precision pin is missing.
This suite re-checks kernel correctness and convergence with the compiled
Triton kernels on the card.  ``chip_smoke.py`` runs it in its own process
(one process per card); by hand on a GPU host:

    ICP_TESTS_GPU=1 python -m pytest tests/test_hw.py -q

On the CPU every test here skips (the ``gpu_device`` fixture).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import data_path

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu_device")]


@pytest.fixture(scope="module")
def cow_f32():
    from icp_tpu.io.csv import load_matrix

    ref = load_matrix(data_path("cow_ref.txt")).astype(np.float32)
    tr1 = load_matrix(data_path("cow_tr1.txt")).astype(np.float32)
    return ref, tr1


def _nn_oracle_check(p, m, got):
    """Compiled argmin vs the f64 oracle: achieved distances must match to
    f32 rounding, and indices agree except at genuine f32 near-ties."""
    from tests import oracle

    want = oracle.closest_indices(p.astype(np.float64), m.astype(np.float64))
    d_got = np.sum((p - m[got]) ** 2, axis=1)
    d_want = np.sum((p - m[want]) ** 2, axis=1)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-4, atol=1e-6)
    assert (got == want).mean() > 0.99


@pytest.mark.parametrize("block_n,block_m,splits", [
    (64, 128, None), (32, 128, 1), (128, 64, 3), (64, 256, 7)])
def test_hw_dense_nn_matches_oracle(block_n, block_m, splits, cow_f32):
    from icp_tpu.kernels.nn_pallas import closest_point_pallas

    ref, tr1 = cow_f32
    p, m = tr1[::4], ref[::2]  # ragged sizes: 726 x 1452
    got, d2 = closest_point_pallas(
        jnp.asarray(p), jnp.asarray(m), block_n=block_n, block_m=block_m,
        splits=splits)
    got = np.asarray(got)
    _nn_oracle_check(p, m, got)
    np.testing.assert_allclose(np.asarray(d2),
                               np.sum((p - m[got]) ** 2, axis=1),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("splits", [1, 3])
def test_hw_dense_nn_tie_break_lowest_index(splits, rng):
    # all-identical model points: index 0 must win in every tile fold and
    # in the split merge — compiled comparison semantics
    from icp_tpu.kernels.nn_pallas import closest_point_pallas

    m = np.ones((300, 3), np.float32)
    p = rng.standard_normal((16, 3)).astype(np.float32)
    got, _ = closest_point_pallas(jnp.asarray(p), jnp.asarray(m),
                                  block_n=16, block_m=32, splits=splits)
    np.testing.assert_array_equal(np.asarray(got), np.zeros(16, np.int32))


def test_hw_grid_nn_exact_and_overflow(cow_f32):
    # the compiled work-list kernel on both paths: tight culling
    # bounds (pruning bites) and a forced-overflow tile (cap=1) that must
    # fall back to folding every model tile — exact either way
    from icp_tpu.kernels.nn_grid import (
        bound_from_indices,
        build_model_grid,
        closest_point_indices_pruned,
        initial_bound_indices,
    )

    ref, tr1 = cow_f32
    p = jnp.asarray(tr1[::4], jnp.float32)
    grid = build_model_grid(jnp.asarray(ref, jnp.float32), target_tile=256)

    idx0 = initial_bound_indices(p, grid.model_orig, stride=8)
    tight = bound_from_indices(p, grid, idx0)
    big = jnp.full((p.shape[0],), 3.0e38, jnp.float32)
    for u, cap, want_overflow in ((tight, 16, None), (big, 1, True)):
        idx, y, _, d2, overflow = closest_point_indices_pruned(
            p, grid, u, scene_tile=128, max_candidates=cap)
        idx = np.asarray(idx)
        if want_overflow:
            assert bool(overflow)
        _nn_oracle_check(np.asarray(p), np.asarray(grid.model_orig), idx)
        np.testing.assert_array_equal(np.asarray(y), np.asarray(
            grid.model_orig)[idx])


def test_hw_knn_dense_and_grid_agree(cow_f32):
    from icp_tpu.kernels.nn_grid import build_model_grid
    from icp_tpu.ops.knn import knn_dense, knn_grid

    ref, _ = cow_f32
    q = jnp.asarray(ref[::8], jnp.float32)  # 363 queries
    pts = jnp.asarray(ref[::2], jnp.float32)
    k = 8
    d_a, i_a = knn_dense(q, pts, k)
    grid = build_model_grid(pts, target_tile=256)
    d_b, i_b = knn_grid(q, grid, k, scene_tile=128)
    np.testing.assert_array_equal(np.asarray(i_a), np.asarray(i_b))
    np.testing.assert_allclose(np.asarray(d_a), np.asarray(d_b),
                               rtol=1e-5, atol=1e-6)
    # vs numpy oracle on a subsample
    qn, pn = np.asarray(q), np.asarray(pts)
    d_full = np.sum((qn[:32, None, :] - pn[None, :, :]) ** 2, axis=2)
    want = np.argsort(d_full, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(np.asarray(i_a)[:32], want)


def test_hw_auto_converges_and_matches_eigh(cow_f32):
    from icp_tpu import ICPConfig, icp

    ref, tr1 = cow_f32
    base = dict(max_iter=30, dtype=jnp.float32)
    auto = icp(ref, tr1, ICPConfig(**base))
    plain = icp(ref, tr1, ICPConfig(solver="eigh", nn_method="blocked",
                                    **base))
    assert float(auto.err) < 1e-5  # the f32 convergence gate: a floor far
    # above it means a product lost precision=HIGHEST
    assert int(auto.iters) == int(plain.iters)
    np.testing.assert_allclose(np.asarray(auto.transform.R),
                               np.asarray(plain.transform.R), atol=1e-5)
    np.testing.assert_allclose(np.asarray(auto.points),
                               np.asarray(plain.points), atol=1e-4)


def test_hw_cow_gate_holds_under_tf32_default(cow_f32):
    """With the process default at TF32, the cow gate must still hold:
    every product on the path pins precision=HIGHEST."""
    from icp_tpu import ICPConfig, icp

    ref, tr1 = cow_f32
    with jax.default_matmul_precision("tensorfloat32"):
        res = icp(ref, tr1, ICPConfig(max_iter=10, dtype=jnp.float32))
        err = float(res.err)
    assert err < 1e-5
    rmse = float(np.sqrt(np.mean(np.sum(
        (np.asarray(res.points) - ref) ** 2, axis=1))))
    assert rmse < 1e-4


def test_hw_grid_engine_converges(cow_f32):
    from icp_tpu import ICPConfig, icp

    ref, tr1 = cow_f32
    res = icp(ref, tr1, ICPConfig(max_iter=30, dtype=jnp.float32,
                                  nn_method="grid"))
    assert float(res.err) < 1e-5
    assert int(res.iters) <= 10


def test_hw_sharded_engines_one_chip_mesh(cow_f32):
    # 1-device mesh: the shard_map programs (ring fold degenerates to a
    # single hop, psums to copies) compiled by the REAL backend must
    # reproduce the single-device engines
    from jax.sharding import Mesh

    from icp_tpu import ICPConfig, icp
    from icp_tpu.parallel.sharded import icp_sharded

    ref, tr1 = cow_f32
    ref, tr1 = np.ascontiguousarray(ref[::4]), np.ascontiguousarray(tr1[::4])
    mesh = Mesh(np.array(jax.devices()[:1]), ("points",))
    for nn in ("pallas", "grid"):
        cfg = ICPConfig(max_iter=20, dtype=jnp.float32, nn_method=nn,
                        solver="qcp")
        single = icp(ref, tr1, cfg)
        sharded = icp_sharded(ref, tr1, cfg, mesh=mesh)
        assert int(sharded.iters) == int(single.iters), nn
        np.testing.assert_allclose(np.asarray(sharded.points),
                                   np.asarray(single.points), atol=1e-5,
                                   err_msg=nn)


def test_hw_gn_engines_one_chip_mesh(cow_f32):
    from jax.sharding import Mesh

    from icp_tpu import ICPConfig
    from icp_tpu.engine.gicp import icp_generalized, icp_generalized_sharded
    from icp_tpu.engine.point_to_plane import (
        icp_point_to_plane,
        icp_point_to_plane_sharded,
    )
    from icp_tpu.ops.normals import estimate_normals

    ref, tr1 = cow_f32
    ref, tr1 = np.ascontiguousarray(ref[::4]), np.ascontiguousarray(tr1[::4])
    mesh = Mesh(np.array(jax.devices()[:1]), ("points",))
    cfg = ICPConfig(max_iter=15, dtype=jnp.float32, nn_method="pallas",
                    threshold=1e-10)
    nm = estimate_normals(jnp.asarray(ref, jnp.float32), k=12)
    ns = estimate_normals(jnp.asarray(tr1, jnp.float32), k=12)

    s = icp_point_to_plane(ref, tr1, cfg, normals=nm)
    d = icp_point_to_plane_sharded(ref, tr1, cfg, normals=nm, mesh=mesh)
    assert int(d.iters) == int(s.iters)
    np.testing.assert_allclose(np.asarray(d.points), np.asarray(s.points),
                               atol=1e-5)

    s = icp_generalized(ref, tr1, cfg, model_normals=nm, scene_normals=ns)
    d = icp_generalized_sharded(ref, tr1, cfg, model_normals=nm,
                                scene_normals=ns, mesh=mesh)
    assert int(d.iters) == int(s.iters)
    np.testing.assert_allclose(np.asarray(d.points), np.asarray(s.points),
                               atol=1e-5)


def test_hw_symmetric_engine_one_chip_mesh(cow_f32):
    """Symmetric objective (engine/symmetric.py) compiled on the card:
    single-device convergence on cow + sharded==single on the 1-device mesh
    (scene normals carried/rotated inside the compiled while_loop)."""
    from jax.sharding import Mesh

    from icp_tpu import ICPConfig
    from icp_tpu.engine.symmetric import icp_symmetric, icp_symmetric_sharded
    from icp_tpu.ops.normals import estimate_normals

    ref, tr1 = cow_f32
    ref, tr1 = np.ascontiguousarray(ref[::4]), np.ascontiguousarray(tr1[::4])
    mesh = Mesh(np.array(jax.devices()[:1]), ("points",))
    cfg = ICPConfig(max_iter=15, dtype=jnp.float32, nn_method="pallas",
                    threshold=1e-10)
    nm = estimate_normals(jnp.asarray(ref, jnp.float32), k=12)
    ns = estimate_normals(jnp.asarray(tr1, jnp.float32), k=12)

    s = icp_symmetric(ref, tr1, cfg, normals=nm, scene_normals=ns,
                      trace=True)
    iters = int(s.result.iters)
    errs = np.asarray(s.errs)[:iters]
    assert errs[-1] < 1e-2 * errs[0]  # compiled convergence

    d = icp_symmetric_sharded(ref, tr1, cfg, normals=nm, scene_normals=ns,
                              mesh=mesh)
    assert int(d.iters) == iters
    np.testing.assert_allclose(np.asarray(d.points),
                               np.asarray(s.result.points), atol=1e-5)


def test_hw_symmetric_grid_matches_dense(cow_f32):
    """Grid-pruned symmetric (kd tiles, model normals as grid payload,
    kd-permuted scene normals) compiled on the card must reproduce the
    dense engine's registration."""
    from icp_tpu import ICPConfig
    from icp_tpu.engine.symmetric import icp_symmetric
    from icp_tpu.ops.normals import estimate_normals

    ref, tr1 = cow_f32
    ref, tr1 = np.ascontiguousarray(ref[::4]), np.ascontiguousarray(tr1[::4])
    nm = estimate_normals(jnp.asarray(ref, jnp.float32), k=12)
    ns = estimate_normals(jnp.asarray(tr1, jnp.float32), k=12)
    base = dict(max_iter=15, dtype=jnp.float32, threshold=1e-10)
    dense = icp_symmetric(ref, tr1, ICPConfig(nn_method="pallas", **base),
                          normals=nm, scene_normals=ns)
    grid = icp_symmetric(ref, tr1, ICPConfig(nn_method="grid", **base),
                         normals=nm, scene_normals=ns)
    assert int(grid.iters) == int(dense.iters)
    np.testing.assert_allclose(np.asarray(grid.points),
                               np.asarray(dense.points), atol=1e-4)


def test_hw_bucketed_and_batched_match_exact(cow_f32):
    """Bucketing machinery under the compiled kernels: a sentinel-padded
    cloud with dynamic counts must reproduce the unpadded run on the dense
    kernel path, and the bucketed 2-pair vmapped batch must match its
    per-pair runs."""
    from icp_tpu import ICPConfig
    from icp_tpu.engine.batched import batch_pairs, icp_batched
    from icp_tpu.engine.icp import icp, icp_fixed_iters
    from icp_tpu.ops.padding import pad_to_bucket

    ref, tr1 = cow_f32
    cfg = ICPConfig(max_iter=12, dtype=jnp.float32, validate_inputs=False,
                    nn_method="pallas")
    base = icp(ref, tr1, cfg)
    m_pad, m_n = pad_to_bucket(ref, quantum=512)
    s_pad, s_n = pad_to_bucket(tr1, quantum=512, n_pad=len(tr1) + 512)
    bucketed = icp(m_pad, s_pad, cfg, scene_n=s_n, model_n=m_n)
    assert int(bucketed.iters) == int(base.iters)
    np.testing.assert_allclose(np.asarray(bucketed.points[:s_n]),
                               np.asarray(base.points), atol=1e-4)

    pairs = [(ref, tr1), (ref[: len(ref) - 377], tr1[: len(tr1) - 123])]
    models_b, scenes_b, m_ns, s_ns = batch_pairs(pairs, quantum=512)
    batch = icp_batched(jnp.asarray(models_b), jnp.asarray(scenes_b),
                        n_iters=8, solver="qcp", nn_method="pallas",
                        scene_ns=s_ns, model_ns=m_ns)
    for b in range(2):
        single = icp_fixed_iters(
            jnp.asarray(models_b[b]), jnp.asarray(scenes_b[b]), n_iters=8,
            solver="qcp", nn_method="pallas",
            scene_n=int(s_ns[b]), model_n=int(m_ns[b]))
        np.testing.assert_allclose(np.asarray(batch.points[b]),
                                   np.asarray(single.points), atol=1e-4)
