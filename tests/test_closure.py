"""Automatic loop-closure detection (slam/closure.py).

No reference counterpart (single-pair registration only); the capability
under test is finding WHICH non-adjacent scans overlap — until this module
the caller had to know (test_bunny_chain hand-picks 4->0).
"""

import numpy as np
import pytest

from icp_tpu.config import ICPConfig
from icp_tpu.io.csv import load_matrix
from icp_tpu.slam.closure import (
    ClosureCandidate,
    _subsample_fixed,
    detect_loop_closures,
    overlap_fraction,
    refine_closures,
    verified_inlier_fraction,
)
from tests.conftest import data_path, random_rotation


@pytest.fixture(scope="module")
def cow_scans():
    """4 synthetic 'scans' cropped from cow_ref: 0/1/2 a sliding window
    along x (adjacent overlaps only), 3 = scan 0 under a random rigid pose
    (the planted loop closure for pair (0, 3))."""
    cow = load_matrix(data_path("cow_ref.txt")).astype(np.float32)
    x = cow[:, 0]
    lo, hi = x.min(), x.max()

    def crop(a, b):
        return cow[(x >= lo + a * (hi - lo)) & (x <= lo + b * (hi - lo))]

    rng = np.random.default_rng(7)
    R = random_rotation(rng).astype(np.float32)
    t = np.array([2.0, -1.0, 0.5], np.float32)
    scans = [crop(0.0, 0.45), crop(0.25, 0.70), crop(0.50, 0.95),
             (crop(0.0, 0.45) @ R.T + t)]
    return scans, R, t


def test_subsample_fixed_properties():
    # local generator: the session-scoped ``rng`` fixture's stream position
    # is consumed in file order, and this file sorts before test_slam.py —
    # drawing from it here would shift every downstream test's data
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((1000, 3)).astype(np.float32)
    out = _subsample_fixed(pts, 256, rng)
    assert out.shape == (256, 3)
    # rows are distinct original rows (no repeats — repeats would corrupt
    # kNN self-masking inside FPFH)
    assert len(np.unique(out, axis=0)) == 256
    small = _subsample_fixed(pts[:100], 256, rng)
    assert small.shape == (100, 3)


def test_chain_edges_from_pairs_flags_outlier():
    from icp_tpu.ops.transform import identity_similarity
    from icp_tpu.slam.closure import chain_edges_from_pairs
    from icp_tpu.slam.pairwise import PairwiseResult

    def pr(err):
        return PairwiseResult(transform=identity_similarity(), err=err,
                              iters=5)

    # one chain pair "converged" to an error 5 orders above its peers
    pairs = [pr(2e-7), pr(8e-8), pr(3e-2), pr(1e-7)]
    edges, suspects = chain_edges_from_pairs(pairs)
    assert suspects == [2]
    assert [e.weight for e in edges] == [1.0, 1.0, 1e-3, 1.0]
    assert [(e.i, e.j) for e in edges] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    # uniform-quality chains flag nothing (including all-zero errors)
    assert chain_edges_from_pairs([pr(1e-7)] * 3)[1] == []
    assert chain_edges_from_pairs([pr(0.0)] * 3)[1] == []


@pytest.mark.slow
def test_verified_inlier_fraction(cow_scans):
    import jax.numpy as jnp

    from icp_tpu.ops.transform import identity_similarity
    from icp_tpu.ops.alignment import Similarity

    scans, R, t = cow_scans
    # scan3 = scan0 under (R, t); the TRUE transform scan3 -> scan0 frame
    # is the inverse
    true_inv = Similarity(
        jnp.asarray(1.0, jnp.float32),
        jnp.asarray(R.T, jnp.float32),
        jnp.asarray(-R.T @ t, jnp.float32),
    )
    ident = identity_similarity(jnp.float32)
    # the correct pose on duplicated geometry verifies ~fully; a junk pose
    # verifies ~nowhere
    assert verified_inlier_fraction(scans[0], scans[3], true_inv) > 0.8
    assert verified_inlier_fraction(scans[0], scans[3], ident) < 0.05
    # same ordering holds for the geometric overlap diagnostic here
    assert overlap_fraction(scans[0], scans[3], true_inv) > 0.9
    assert overlap_fraction(scans[0], scans[3], ident) < 0.1
    # genuine partial-overlap pair: truth (identity — crops share a frame)
    # must outrank a junk pose, even though slab FPFH evidence is weak
    frac_true = verified_inlier_fraction(scans[0], scans[1], ident)
    frac_junk = verified_inlier_fraction(scans[0], scans[1], true_inv)
    assert frac_true > 2 * max(frac_junk, 1e-3), (frac_true, frac_junk)


@pytest.mark.slow
def test_chain_edges_weighted_by_verification(cow_scans):
    import jax.numpy as jnp

    from icp_tpu.ops.transform import identity_similarity
    from icp_tpu.slam.closure import chain_edges_from_pairs
    from icp_tpu.slam.pairwise import PairwiseResult

    scans, R, t = cow_scans
    ident = identity_similarity(jnp.float32)

    def pr(tr, err=1e-3):
        return PairwiseResult(transform=tr, err=err, iters=5)

    # chain truth: (0,1) and (1,2) identity; (2,3) has NO correct pose —
    # give it the identity too (a plausible-but-wrong alignment)
    pairs = [pr(ident), pr(ident), pr(ident)]
    edges, suspects = chain_edges_from_pairs(pairs, scans)
    w = [e.weight for e in edges]
    # the disjoint pair's weight collapses below both genuine edges
    assert w[2] < 0.5 * min(w[0], w[1]), w
    assert 2 in suspects, (suspects, w)


@pytest.mark.slow
def test_detect_closures_synthetic(cow_scans):
    scans, R, t = cow_scans
    cands = detect_loop_closures(scans, min_separation=2, max_points=512,
                                 inlier_min=0.0, seed=1)
    by_pair = {(c.i, c.j): c for c in cands}
    assert set(by_pair) == {(0, 2), (0, 3), (1, 3)}
    # the planted closure dominates; the disjoint pairs stay far below the
    # default accept threshold
    assert by_pair[(0, 3)].inlier_fraction > 0.3
    assert by_pair[(0, 2)].inlier_fraction < 0.2
    assert by_pair[(1, 3)].inlier_fraction < 0.2
    assert cands[0] == by_pair[(0, 3)]  # sorted best-first
    # and its coarse transform is actually the planted pose (scan3 -> scan0
    # frame = the inverse of (R, t))
    Rg = np.asarray(by_pair[(0, 3)].transform.R)
    rot_err = np.rad2deg(
        np.arccos(np.clip((np.trace(Rg @ R) - 1.0) / 2.0, -1.0, 1.0)))
    assert rot_err < 10.0


@pytest.mark.slow
def test_refine_closures_gates_false_positives(cow_scans):
    scans, R, t = cow_scans
    cands = detect_loop_closures(scans, min_separation=2, max_points=512,
                                 seed=1)  # default inlier_min: only (0, 3)
    assert [(c.i, c.j) for c in cands] == [(0, 3)]
    # plant a false candidate on a disjoint pair with a junk transform: the
    # refinement error gate must drop it and keep the true closure
    from icp_tpu.ops.transform import identity_similarity

    fake = ClosureCandidate(i=0, j=2, transform=identity_similarity(),
                            inlier_fraction=0.99, n_mutual=1)
    cfg = ICPConfig(max_iter=40, nn_method="bcast", solver="eigh",
                    with_scale=False, validate_inputs=False,
                    trim_fraction=0.3)
    edges, results = refine_closures(scans, list(cands) + [fake], cfg,
                                     multiscale=(4, 1), max_err=1e-4)
    assert [(e.i, e.j) for e in edges] == [(0, 3)]
    assert float(results[0].err) < 1e-4
    # the refined edge agrees with the planted pose
    rot_err = np.rad2deg(np.arccos(np.clip(
        (np.trace(np.asarray(edges[0].R) @ R) - 1.0) / 2.0, -1.0, 1.0)))
    assert rot_err < 1.0


@pytest.mark.slow
def test_detect_closures_bunny():
    # real scans: the 45-degree-apart ends of the chain (bun000, bun315)
    # are the only pair that must clear the default threshold
    views = ["bun000", "bun045", "bun180", "bun270", "bun315"]
    clouds = [load_matrix(data_path(v + ".txt")).astype(np.float32)[::4]
              for v in views]
    cands = detect_loop_closures(clouds, min_separation=2, inlier_min=0.0)
    by_pair = {(c.i, c.j): c.inlier_fraction for c in cands}
    assert len(by_pair) == 6
    best = max(by_pair, key=by_pair.get)
    assert best == (0, 4), by_pair
    assert by_pair[(0, 4)] >= 0.15, by_pair
    # the non-overlapping diagonals stay below threshold
    assert by_pair[(0, 2)] < 0.15
    assert by_pair[(1, 3)] < 0.15


@pytest.mark.slow
def test_slam_cli_detect_closures(tmp_path, cow_scans):
    import os
    import subprocess
    import sys

    scans, R, t = cow_scans
    for i, s in enumerate(scans):
        lines = ["Points_0,Points_1,Points_2"] + [
            ",".join(f"{x:.8g}" for x in row) for row in s]
        (tmp_path / f"scan{i}.txt").write_text("\n".join(lines) + "\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "icp_tpu.slam.cli",
         "scan0.txt", "scan1.txt", "scan2.txt", "scan3.txt",
         "--detect-closures", "--init", "fpfh", "--trim", "0.4",
         "--multiscale", "4", "1", "--nn", "bcast", "--solver", "eigh"],
        capture_output=True, text=True, cwd=tmp_path, env=env, timeout=1800,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "closure candidate 0<-3" in r.stderr, r.stderr[-3000:]
    assert "pose graph: 1 closure edge(s)" in r.stderr, r.stderr[-3000:]
    # scan3 is scan0 under a rigid pose: the optimized world pose of scan 3
    # must map it back onto scan 0 (drift cancelled by the closure)
    out3 = np.loadtxt(tmp_path / "registered_3.txt", delimiter=",",
                      skiprows=1)
    d = np.linalg.norm(out3 - scans[0], axis=1)
    assert np.median(d) < 0.05, np.median(d)
