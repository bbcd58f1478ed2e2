"""Dense Triton NN kernel vs the oracle (interpret mode on CPU), and the
plain XLA blocked fold it is compared with at scale."""

import jax.numpy as jnp
import numpy as np
import pytest

from icp_tpu.kernels.nn_pallas import _pow2_at_most, closest_point_pallas
from icp_tpu.ops.distance import closest_point_blocked
from tests import oracle


def _check_against_oracle(p, mm, got, d2=None):
    want = oracle.closest_indices(p.astype(np.float64), mm.astype(np.float64))
    # f32 rounding may flip near-ties: compare achieved distances.
    d_got = np.sum((p - mm[got]) ** 2, axis=1)
    d_want = np.sum((p - mm[want]) ** 2, axis=1)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-4, atol=1e-5)
    assert (got == want).mean() > 0.99
    if d2 is not None:
        np.testing.assert_allclose(d2, d_got, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "n,m,bn,bm",
    [
        (16, 128, 16, 128),  # single tile
        (40, 300, 16, 128),  # ragged: padding in both axes
        (100, 1000, 32, 256),  # multiple model tiles (carry fold)
        (257, 129, 64, 32),  # scene blocks > 1, model ragged
    ],
)
def test_pallas_matches_oracle(n, m, bn, bm, rng):
    p = rng.standard_normal((n, 3)).astype(np.float32)
    mm = rng.standard_normal((m, 3)).astype(np.float32)
    idx, d2 = closest_point_pallas(jnp.asarray(p), jnp.asarray(mm),
                                   block_n=bn, block_m=bm, interpret=True)
    _check_against_oracle(p, mm, np.asarray(idx), np.asarray(d2))


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_split_model_merge_matches_oracle(splits, rng):
    # the model axis split across blocks; the XLA merge must reproduce the
    # single-split fold, including splits that do not divide the tiles
    p = rng.standard_normal((70, 3)).astype(np.float32)
    mm = rng.standard_normal((611, 3)).astype(np.float32)
    idx, d2 = closest_point_pallas(jnp.asarray(p), jnp.asarray(mm),
                                   block_n=32, block_m=64, splits=splits,
                                   interpret=True)
    _check_against_oracle(p, mm, np.asarray(idx), np.asarray(d2))


@pytest.mark.parametrize("splits", [1, 4])
def test_tie_break_lowest_index(splits, rng):
    # every model point duplicated in a later tile (and a later split):
    # the lowest index must win within tiles, across tiles and splits
    base = rng.standard_normal((48, 3)).astype(np.float32)
    mm = np.concatenate([base, base[::-1], base], axis=0)
    p = base[:20] + np.float32(1e-4) * rng.standard_normal(
        (20, 3)).astype(np.float32)
    idx, _ = closest_point_pallas(jnp.asarray(p), jnp.asarray(mm),
                                  block_n=8, block_m=16, splits=splits,
                                  interpret=True)
    want = oracle.closest_indices(p.astype(np.float64),
                                  mm.astype(np.float64))
    np.testing.assert_array_equal(np.asarray(idx), want)
    assert np.asarray(idx).max() < 48  # never a later duplicate
    # all-identical model: index 0 everywhere
    idx1, _ = closest_point_pallas(jnp.asarray(p),
                                   jnp.ones((300, 3), jnp.float32),
                                   block_n=8, block_m=32, splits=splits,
                                   interpret=True)
    np.testing.assert_array_equal(np.asarray(idx1), np.zeros(20, np.int32))


def test_padded_model_rows_never_win(rng):
    # scene points far out where the pad sentinel would be closer than any
    # real point if it were at the origin: the 1e17 pads must still lose
    p = (rng.standard_normal((5, 3)) * 1e3).astype(np.float32)
    mm = rng.standard_normal((7, 3)).astype(np.float32)
    idx, d2 = closest_point_pallas(jnp.asarray(p), jnp.asarray(mm),
                                   interpret=True)
    idx = np.asarray(idx)
    assert idx.max() < 7 and idx.min() >= 0
    _check_against_oracle(p, mm, idx, np.asarray(d2))


def test_block_shapes_are_powers_of_two():
    # Triton wants power-of-two blocks: the wrapper clamps to the data
    assert _pow2_at_most(5, 64) == 8
    assert _pow2_at_most(64, 64) == 64
    assert _pow2_at_most(3000, 128) == 128
    assert _pow2_at_most(1, 64) == 1
    for x in (3, 17, 100, 129):
        v = _pow2_at_most(x, 256)
        assert v & (v - 1) == 0 and v >= min(x, 256)


def test_dispatcher_resolves_interpret_mode(rng):
    from icp_tpu.ops.distance import closest_point_indices

    p = rng.standard_normal((33, 3)).astype(np.float32)
    mm = rng.standard_normal((90, 3)).astype(np.float32)
    a = np.asarray(closest_point_pallas(
        jnp.asarray(p), jnp.asarray(mm), interpret=True)[0])
    # the dispatcher resolves the CPU interpret mode itself
    b = np.asarray(closest_point_indices(jnp.asarray(p), jnp.asarray(mm),
                                         method="pallas"))
    c = np.asarray(closest_point_indices(jnp.asarray(p), jnp.asarray(mm),
                                         method="bcast"))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("n,m,sc,mc", [(50, 70, 16, 32), (129, 1000, 64, 128)])
def test_blocked_xla_fold_matches_oracle(n, m, sc, mc, rng):
    p = rng.standard_normal((n, 3)).astype(np.float32)
    mm = rng.standard_normal((m, 3)).astype(np.float32)
    mm[m - 1] = mm[3]  # a duplicate in a later block: index 3 must win
    p[0] = mm[3]
    idx, d2 = closest_point_blocked(jnp.asarray(p), jnp.asarray(mm),
                                    scene_chunk=sc, model_chunk=mc)
    idx = np.asarray(idx)
    assert idx[0] == 3
    _check_against_oracle(p, mm, idx, np.asarray(d2))


def test_pallas_inside_icp_loop(cow_pair):
    """nn_method='pallas' end to end (interpret on CPU)."""
    from icp_tpu import ICPConfig, icp

    ref, tr1 = cow_pair
    ref, tr1 = ref[::20], tr1[::20]
    cfg = ICPConfig(max_iter=20, dtype=jnp.float32, nn_method="pallas", solver="qcp")
    res = icp(np.ascontiguousarray(ref), np.ascontiguousarray(tr1), cfg)
    assert float(res.err) < 1e-5
