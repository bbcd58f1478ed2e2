"""Batched multi-pair registration (the frames/s serving path)."""

import jax.numpy as jnp
import numpy as np

from icp_tpu.engine.batched import icp_batched


def _pairs(rng, B=4, N=200):
    models = rng.standard_normal((B, N, 3)).astype(np.float32)
    th = 0.1
    R = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
        np.float32,
    )
    scenes = models @ R.T + np.array([0.1, -0.05, 0.2], np.float32)
    return models, scenes


def test_batched_matches_per_pair(rng):
    models, scenes = _pairs(rng)
    res = icp_batched(jnp.asarray(models), jnp.asarray(scenes), n_iters=20)
    assert res.points.shape == scenes.shape
    np.testing.assert_allclose(np.asarray(res.points), models, atol=1e-5)
    assert (np.asarray(res.err) < 1e-5).all()


def test_batched_pallas_path(rng):
    # the dense Triton kernel under vmap (interpret mode on CPU)
    models, scenes = _pairs(rng)
    res = icp_batched(
        jnp.asarray(models), jnp.asarray(scenes), n_iters=20,
        solver="qcp", nn_method="pallas",
    )
    np.testing.assert_allclose(np.asarray(res.points), models, atol=5e-5)


def test_batched_bucketed_unequal_pairs(rng):
    """Unequal-size pairs padded into one bucket run as ONE batched program
    and match the sequential single-pair bucketed engine exactly (VERDICT
    r4 #6 — the replica-fill + per-pair count machinery composed with vmap)."""
    from icp_tpu.engine.batched import batch_pairs
    from icp_tpu.engine.icp import icp_fixed_iters

    sizes = [(96, 150), (128, 97), (150, 150), (101, 133)]
    pairs = []
    for k, (nm, ns) in enumerate(sizes):
        m = rng.standard_normal((nm, 3)).astype(np.float32)
        th = 0.04 * (k + 1)
        R = np.array(
            [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
             [0, 0, 1]], np.float32)
        # scene = transformed subset/superset of the model rows
        src = m[np.arange(ns) % nm]
        pairs.append((m, src @ R.T + np.array([0.02 * k, -0.01, 0.03],
                                              np.float32)))

    models, scenes, m_ns, s_ns = batch_pairs(pairs, quantum=64)
    res = icp_batched(
        jnp.asarray(models), jnp.asarray(scenes), n_iters=15,
        scene_ns=s_ns, model_ns=m_ns,
    )
    assert res.err.shape == (4,)
    for b, (m, s) in enumerate(pairs):
        single = icp_fixed_iters(
            jnp.asarray(models[b]), jnp.asarray(scenes[b]), n_iters=15,
            scene_n=int(s_ns[b]), model_n=int(m_ns[b]),
        )
        np.testing.assert_allclose(np.asarray(res.err[b]),
                                   np.asarray(single.err), rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(
            np.asarray(res.points[b, : len(s)]),
            np.asarray(single.points[: len(s)]), atol=1e-5)
        # and the registration itself is correct: scene lands on the model
        d = np.asarray(res.points[b, : len(s)]) - np.asarray(
            m[np.arange(len(s)) % len(m)])
        assert float(np.sqrt((d ** 2).sum(1)).mean()) < 1e-2


def test_register_chain_batched_matches_sequential(rng):
    """A 4-pair unequal-count chain as one batched program vs the sequential
    bucketed engine — same transforms, pair by pair."""
    from icp_tpu.engine.batched import register_chain_batched
    from icp_tpu.engine.icp import icp_fixed_iters
    from icp_tpu.ops.padding import pad_to_bucket

    base = rng.standard_normal((160, 3)).astype(np.float32)
    clouds = []
    for k, n in enumerate((160, 120, 140, 100, 130)):
        th = 0.03 * k
        R = np.array(
            [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
             [0, 0, 1]], np.float32)
        clouds.append((base[np.arange(n) % 160] @ R.T
                       + 0.02 * k).astype(np.float32))

    res = register_chain_batched(clouds, n_iters=12, quantum=64)
    assert len(res) == 4
    for b in range(4):
        mp, mn = pad_to_bucket(clouds[b], n_pad=192)
        sp, sn = pad_to_bucket(clouds[b + 1], n_pad=192)
        single = icp_fixed_iters(jnp.asarray(mp), jnp.asarray(sp),
                                 n_iters=12, scene_n=sn, model_n=mn)
        np.testing.assert_allclose(np.asarray(res[b].transform.R),
                                   np.asarray(single.transform.R), atol=1e-5)
        np.testing.assert_allclose(np.asarray(res[b].transform.t),
                                   np.asarray(single.transform.t), atol=1e-5)
        assert res[b].points.shape == (len(clouds[b + 1]), 3)


def test_batched_heterogeneous_transforms(rng):
    # each pair gets a different transform; all must be recovered
    models = rng.standard_normal((3, 150, 3)).astype(np.float32)
    scenes = np.empty_like(models)
    for b in range(3):
        th = 0.05 * (b + 1)
        R = np.array(
            [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]],
            np.float32,
        )
        scenes[b] = models[b] @ R.T + 0.1 * (b + 1)
    res = icp_batched(jnp.asarray(models), jnp.asarray(scenes), n_iters=30)
    np.testing.assert_allclose(np.asarray(res.points), models, atol=1e-4)
