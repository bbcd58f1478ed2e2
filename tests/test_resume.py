"""Warm-start (icp(init=)) + periodic checkpointing / kill-safe resume."""

import jax.numpy as jnp
import numpy as np

from icp_tpu import ICPConfig, icp
from icp_tpu.engine.icp import icp_resumable
from icp_tpu.ops.alignment import Similarity
from icp_tpu.utils.checkpoint import load_checkpoint


def _cfg(**kw):
    base = dict(max_iter=60, dtype=jnp.float64, solver="eigh",
                nn_method="bcast")
    base.update(kw)
    return ICPConfig(**base)


def test_icp_init_warm_start_converges_immediately(cow_pair):
    """Seeding with the converged transform finishes in one check-iteration
    and returns the SAME cumulative transform (maps the caller's scene)."""
    ref, tr1 = cow_pair
    full = icp(ref, tr1, _cfg())
    warm = icp(ref, tr1, _cfg(), init=full.transform)
    assert int(warm.iters) <= 2
    np.testing.assert_allclose(np.asarray(warm.transform.R),
                               np.asarray(full.transform.R), atol=1e-9)
    np.testing.assert_allclose(np.asarray(warm.points),
                               np.asarray(full.points), atol=1e-9)


def test_icp_init_halfway_matches_total(cow_pair):
    """init=T then refining equals running the refinement on the
    pre-transformed cloud, composed — the identity init= replaces."""
    ref, tr1 = cow_pair
    # a deliberately wrong-ish warm start: small rotation
    th = 0.05
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1.0]])
    init = Similarity(jnp.asarray(1.0, jnp.float64), jnp.asarray(R),
                      jnp.asarray(np.array([0.01, 0.0, -0.02])))
    # tight threshold: run past the 1e-5 reference exit to the exact floor
    res = icp(ref, tr1, _cfg(threshold=1e-11), init=init)
    assert float(res.err) < 1e-11
    rmse = np.sqrt(np.mean(np.sum((np.asarray(res.points) - ref) ** 2, 1)))
    assert rmse < 1e-5


def test_kill_and_resume_bit_for_bit(cow_pair, tmp_path):
    ref, tr1 = cow_pair
    ck_a = str(tmp_path / "uninterrupted.npz")
    ck_b = str(tmp_path / "killed.npz")

    # uninterrupted chunked run (chunks of 3)
    full = icp_resumable(ref, tr1, _cfg(), checkpoint_path=ck_a,
                         checkpoint_every=3)

    # "killed" after the first chunk: run with max_iter=3, then resume
    icp_resumable(ref, tr1, _cfg(max_iter=3), checkpoint_path=ck_b,
                  checkpoint_every=3)
    sim, iters, err, _ = load_checkpoint(ck_b)
    assert iters == 3
    resumed = icp_resumable(ref, tr1, _cfg(), checkpoint_path=ck_b,
                            checkpoint_every=3, resume=True)

    # bit-for-bit: identical transform, points, error, iteration count
    assert int(resumed.iters) == int(full.iters)
    np.testing.assert_array_equal(np.asarray(resumed.points),
                                  np.asarray(full.points))
    np.testing.assert_array_equal(np.asarray(resumed.transform.R),
                                  np.asarray(full.transform.R))
    np.testing.assert_array_equal(np.asarray(resumed.transform.t),
                                  np.asarray(full.transform.t))
    assert float(resumed.err) == float(full.err)


def test_cli_resume_roundtrip(cow_pair, tmp_path, monkeypatch):
    from icp_tpu.engine.cli import main
    from tests.conftest import data_path

    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck.npz")
    out = str(tmp_path / "out.txt")
    # interrupted: only 4 iterations allowed
    rc = main([data_path("cow_ref.txt"), data_path("cow_tr1.txt"), "4",
               "--checkpoint", ck, "--checkpoint-every", "4",
               "--output", out, "--solver", "eigh", "--nn", "bcast"])
    assert rc == 0
    _, iters, _, _ = load_checkpoint(ck)
    assert iters == 4
    # resumed to convergence
    rc = main([data_path("cow_ref.txt"), data_path("cow_tr1.txt"), "60",
               "--checkpoint", ck, "--checkpoint-every", "4", "--resume",
               "--output", out, "--solver", "eigh", "--nn", "bcast"])
    assert rc == 0
    _, iters2, err2, _ = load_checkpoint(ck)
    assert iters2 > 4 and err2 < 1e-5


def test_resumable_partial_chunk_reuses_compiled_program(cow_pair, tmp_path):
    """A partial final chunk must NOT trigger a new compile: the chunk bound
    is dynamic, the compiled shape is checkpoint_every."""
    from icp_tpu.engine.icp import _icp_while

    ref, tr1 = cow_pair
    ref, tr1 = np.ascontiguousarray(ref[::10]), np.ascontiguousarray(tr1[::10])
    # threshold=0 never converges -> runs chunks of 4,4,2
    cfg = _cfg(max_iter=10, threshold=0.0)
    before = _icp_while._cache_size()
    res = icp_resumable(ref, tr1, cfg, checkpoint_path=str(tmp_path / "c.npz"),
                        checkpoint_every=4)
    assert int(res.iters) == 10  # total across chunks of 4, 4, 2
    assert _icp_while._cache_size() == before + 1, (
        "partial final chunk recompiled the loop"
    )
    # chunked re-application composes per chunk: equal to the monolithic
    # run to f64 roundoff (bit-exactness only holds chunked-vs-chunked)
    mono = icp(ref, tr1, cfg)
    np.testing.assert_allclose(np.asarray(res.points),
                               np.asarray(mono.points), atol=1e-12)


def test_resumable_partial_chunk_grid_engine(cow_pair, tmp_path):
    # same property on the grid path (where resumable matters most: 1M runs)
    from icp_tpu.engine.grid import _icp_grid

    ref, tr1 = cow_pair
    ref, tr1 = np.ascontiguousarray(ref[::10]), np.ascontiguousarray(tr1[::10])
    cfg = _cfg(max_iter=10, threshold=0.0, nn_method="grid",
               grid_model_tile=64, grid_scene_tile=32)
    before = _icp_grid._cache_size()
    res = icp_resumable(ref, tr1, cfg, checkpoint_path=str(tmp_path / "g.npz"),
                        checkpoint_every=4)
    assert int(res.iters) == 10
    assert _icp_grid._cache_size() == before + 1
    mono = icp(ref, tr1, cfg)
    np.testing.assert_allclose(np.asarray(res.points),
                               np.asarray(mono.points), atol=1e-12)
