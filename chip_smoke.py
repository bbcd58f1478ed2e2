#!/usr/bin/env python
"""Smoke run of the registration engine on an NVIDIA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded engines only

One card, in one process (a second process could not open the card while
this one holds it):

  1. kernels: each kept Pallas kernel compiled at real widths and compared
     once with its plain XLA reference, plus the compiled memory of the cow
     and horse ICP steps;
  2. the ``gpu``-marked tests (``tests/test_hw.py``) through ``pytest.main``;
  3. cow through the ``icp`` CLI: err < 1e-5 within 10 iterations and RMSE
     against ``cow_ref`` < 1e-4;
  4. horse through the ``icp`` CLI, 30 iterations: the same plateau as a
     float64 run of the plain XLA path (same iteration count, err within 1%);
  5. the five bunny scans through the ``icp-slam`` CLI — a point-to-point
     chain, a point-to-plane chain and the README's FPFH + closures line —
     each pair's error no worse than the plain XLA path's plus 1%;
  6. a million-point pair through ``icp`` (auto, 10 iterations): the kd-grid
     correspondences on 4,096 seeded rows agree with an exact blocked XLA NN;
  7. timings: each kernel against plain XLA, dense against grid, eigh
     against qcp, tile sweeps — findings, not claims.

``--four-cards`` runs only the multi-device engines on a million-point pair
for 5 iterations, each against its single-device engine.

Any phase that raises or misses its gate fails the run (non-zero exit).  The
last line of standard output is the result JSON; the line before it names
the card and its power limit.  Without a GPU the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "data")
OUT = os.path.join(ROOT, ".smoke_out")  # CLI outputs (git-ignored)
BUNNY = ["bun000", "bun045", "bun180", "bun270", "bun315"]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def check(cond: bool, what: str) -> None:
    """A gate: raises unless ``cond``; logs it either way."""
    if not cond:
        raise AssertionError(f"gate missed: {what}")
    log(f"[gate] ok: {what}")


def block(x):
    import jax

    return jax.block_until_ready(x)


def time_per_call(fn, reps: int) -> float:
    """Seconds per call of ``fn()`` after a warm-up call, ending in
    ``block_until_ready``."""
    block(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    block(out)
    return (time.perf_counter() - t0) / reps


def nn_agreement(p, model, idx, d2, ref_idx, ref_d2, what: str) -> None:
    """Correspondences agree with a reference: achieved squared distance to
    rtol 1e-4 / atol 1e-6, and at least 99% of the indices equal (f32
    near-ties may pick another point at the same distance)."""
    idx, d2 = np.asarray(idx), np.asarray(d2)
    ref_idx, ref_d2 = np.asarray(ref_idx), np.asarray(ref_d2)
    p, model = np.asarray(p, np.float64), np.asarray(model, np.float64)
    got = np.sum((p - model[idx]) ** 2, axis=1)
    want = np.sum((p - model[ref_idx]) ** 2, axis=1)
    close = np.allclose(got, want, rtol=1e-4, atol=1e-6)
    same = float(np.mean(idx == ref_idx))
    dist = np.allclose(d2, ref_d2, rtol=1e-4, atol=1e-6)
    log(f"[nn] {what}: rows={len(idx)} index_agreement={same:.6f} "
        f"achieved_d2_close={close} kernel_d2_close={dist} "
        f"(f32 on the CUDA cores, no TF32; rtol=1e-4 atol=1e-6)")
    check(close and dist and same >= 0.99, f"{what} matches the reference")


def load(name: str):
    from icp_tpu.io.csv import load_matrix

    return load_matrix(os.path.join(DATA, name + ".txt")).astype(np.float32)


# ---------------------------------------------------------------------------
# 1. kernels at real widths
# ---------------------------------------------------------------------------

def grid_correspondences(scene, model, *, scene_tile=256, model_tile=1024,
                         max_candidates=16):
    """kd-grid NN of every scene row (rows in the caller's order), built the
    way the grid engine builds its first iteration: ``(idx, d2)``."""
    import jax
    import jax.numpy as jnp

    from icp_tpu.config import kernel_interpret
    from icp_tpu.engine.grid import _prepare_scene
    from icp_tpu.kernels.nn_grid import (
        bound_from_indices,
        build_model_grid,
        closest_point_indices_grid,
        initial_bound_indices,
    )

    interp = kernel_interpret()

    @jax.jit
    def run(s, m):
        grid = build_model_grid(m, target_tile=model_tile)
        p, _, inv, tn, _ = _prepare_scene(s, scene_tile)
        stride = max(1, min(16, m.shape[0] // 4))
        u = bound_from_indices(p, grid, initial_bound_indices(
            p, grid.model_orig, stride=stride, interpret=interp))
        idx, _, _, d2 = closest_point_indices_grid(
            p, grid, u, scene_tile=tn, max_candidates=max_candidates,
            interpret=interp)
        return idx[inv], d2[inv]

    return run(jnp.asarray(scene), jnp.asarray(model))


def phase_kernels(cow_n=None, horse_n=None, million=1_000_000,
                  sample_rows=4096):
    import jax
    import jax.numpy as jnp

    from icp_tpu.bench.scaling import synthetic_pair
    from icp_tpu.config import kernel_interpret
    from icp_tpu.engine.icp import icp_fixed_iters
    from icp_tpu.kernels.nn_pallas import closest_point_pallas
    from icp_tpu.ops.distance import closest_point_blocked

    interp = kernel_interpret()
    pairs = {
        "cow": (load("cow_ref")[:cow_n], load("cow_tr1")[:cow_n]),
        "horse": (load("horse_ref")[:horse_n], load("horse_tr1")[:horse_n]),
    }
    blocked = jax.jit(closest_point_blocked)
    for name, (ref, tr1) in pairs.items():
        m, s = jnp.asarray(ref), jnp.asarray(tr1)
        dense = jax.jit(lambda a, b: closest_point_pallas(a, b,
                                                          interpret=interp))
        t0 = time.perf_counter()
        compiled = dense.lower(s, m).compile()
        log(f"[kernel] nn_dense {name} {s.shape[0]}x{m.shape[0]}: compiled "
            f"in {time.perf_counter() - t0:.2f} s")
        idx, d2 = compiled(s, m)
        r_idx, r_d2 = blocked(s, m)
        nn_agreement(tr1, ref, idx, d2, r_idx, r_d2,
                     f"nn_dense {name} vs blocked XLA")
        # float64 NumPy oracle on a sample of rows
        rows = np.random.default_rng(0).choice(len(tr1), min(256, len(tr1)),
                                               replace=False)
        dd = np.sum((tr1[rows, None, :].astype(np.float64)
                     - ref[None, :, :].astype(np.float64)) ** 2, axis=-1)
        o_idx = dd.argmin(1)
        nn_agreement(tr1[rows], ref, np.asarray(idx)[rows],
                     np.asarray(d2)[rows], o_idx, dd.min(1),
                     f"nn_dense {name} vs float64 oracle")
        g_idx, g_d2 = grid_correspondences(tr1, ref)
        nn_agreement(tr1, ref, g_idx, g_d2, r_idx, r_d2,
                     f"nn_grid {name} vs blocked XLA")
        step = jax.jit(lambda a, b: icp_fixed_iters(a, b, n_iters=1,
                                                    solver="qcp",
                                                    nn_method="pallas"))
        mem = step.lower(m, s).compile().memory_analysis()
        log(f"[memory] icp step {name} (dense kernel): {mem}")
    # the grid kernel at a million points, on seeded rows
    model, scene = synthetic_pair(million, million, seed=0)
    t0 = time.perf_counter()
    g_idx, g_d2 = block(grid_correspondences(scene, model))
    log(f"[kernel] nn_grid {million}x{million}: compiled and ran in "
        f"{time.perf_counter() - t0:.2f} s")
    rows = np.sort(np.random.default_rng(1).choice(
        million, min(sample_rows, million), replace=False))
    r_idx, r_d2 = blocked(jnp.asarray(scene[rows]), jnp.asarray(model))
    nn_agreement(scene[rows], model, np.asarray(g_idx)[rows],
                 np.asarray(g_d2)[rows], r_idx, r_d2,
                 f"nn_grid {million} vs blocked XLA on {len(rows)} rows")


# ---------------------------------------------------------------------------
# 2. the gpu-marked tests
# ---------------------------------------------------------------------------

def phase_gpu_tests() -> None:
    import pytest

    os.environ["ICP_TESTS_GPU"] = "1"
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                      "--rootdir", ROOT, os.path.join(ROOT, "tests",
                                                      "test_hw.py")])
    check(rc == 0, f"tests/test_hw.py passed on the card (pytest rc={rc})")


# ---------------------------------------------------------------------------
# 3-5. the CLIs
# ---------------------------------------------------------------------------

def run_cli(main, argv):
    """Run a CLI's ``main(argv)`` in this process; returns (rc, stderr)."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    text = err.getvalue()
    log(f"[cli] {' '.join(os.path.basename(a) for a in argv)}: rc={rc} "
        f"in {time.perf_counter() - t0:.1f} s")
    return rc, text


_ITER = re.compile(r"\[ICP\] iteration number (\d+) \| error value = (\S+)")


def icp_cli(ref_path, scene_path, iters, out_path, extra=()):
    """The ``icp`` CLI: returns (iterations, final err, output cloud)."""
    from icp_tpu.engine.cli import main
    from icp_tpu.io.csv import load_matrix

    rc, text = run_cli(main, [ref_path, scene_path, str(iters),
                              "--output", out_path, *extra])
    check(rc == 0, f"icp CLI exit code 0 on {os.path.basename(scene_path)}")
    its = [(int(a), float(b)) for a, b in _ITER.findall(text)]
    check(bool(its), "icp CLI reported its iterations")
    return len(its), its[-1][1], load_matrix(out_path)


def phase_cow(ref_path=None, scene_path=None):
    ref_path = ref_path or os.path.join(DATA, "cow_ref.txt")
    scene_path = scene_path or os.path.join(DATA, "cow_tr1.txt")
    from icp_tpu.io.csv import load_matrix

    n_it, err, out = icp_cli(ref_path, scene_path, 10,
                             os.path.join(OUT, "cow_output.txt"))
    ref = load_matrix(ref_path)
    rmse = float(np.sqrt(np.mean(np.sum((out - ref) ** 2, axis=1))))
    log(f"[cow] iterations={n_it} err={err:.6e} rmse_vs_ref={rmse:.6e}")
    check(err < 1e-5 and n_it <= 10, "cow err < 1e-5 within 10 iterations")
    check(rmse < 1e-4, "cow RMSE against cow_ref < 1e-4")


def phase_horse(ref_path=None, scene_path=None, iters=30):
    import jax
    import jax.numpy as jnp

    from icp_tpu.config import ICPConfig
    from icp_tpu.engine.icp import icp
    from icp_tpu.io.csv import load_matrix

    ref_path = ref_path or os.path.join(DATA, "horse_ref.txt")
    scene_path = scene_path or os.path.join(DATA, "horse_tr1.txt")
    n_it, err, _ = icp_cli(ref_path, scene_path, iters,
                           os.path.join(OUT, "horse_output.txt"))
    ref = load_matrix(ref_path).astype(np.float64)
    tr1 = load_matrix(scene_path).astype(np.float64)
    with jax.enable_x64(True):
        plain = icp(ref, tr1, ICPConfig(max_iter=iters, dtype=jnp.float64,
                                        nn_method="blocked", solver="eigh"))
        p_it, p_err = int(plain.iters), float(plain.err)
    log(f"[horse] kernels: iterations={n_it} err={err:.6e}; float64 plain "
        f"XLA: iterations={p_it} err={p_err:.6e}")
    check(n_it == p_it, "horse takes the float64 plain path's iteration count")
    check(abs(err - p_err) <= 0.01 * abs(p_err),
          "horse err within 1% of the float64 plain path")


_PAIR = re.compile(r"\[slam\] pair (\d+)->(\d+): iters=(\d+) err=(\S+)")


def slam_chain(paths, extra, tag):
    from icp_tpu.slam.cli import main

    rc, text = run_cli(main, [*paths, *extra,
                              "--output-prefix",
                              os.path.join(OUT, f"bunny_{tag}_"),
                              "--poses", os.path.join(OUT, f"poses_{tag}.npz")])
    check(rc == 0, f"icp-slam exit code 0 ({tag})")
    pairs = [(int(a), int(c), float(d)) for a, _, c, d in _PAIR.findall(text)]
    check(len(pairs) == len(paths) - 1, f"icp-slam reported every pair ({tag})")
    for line in text.splitlines():
        if "closure" in line or "pose graph" in line:
            log(f"  {line}")
    return pairs


BUNNY_CHAINS = {
    "p2p": [],
    "p2pl": ["--engine", "point_to_plane"],
    "readme": ["--init", "fpfh", "--detect-closures", "--trim", "0.4",
               "--multiscale", "8", "1", "--subsample", "4"],
}


def phase_bunny(paths=None, chains=None):
    paths = paths or [os.path.join(DATA, v + ".txt") for v in BUNNY]
    for tag, extra in (chains or BUNNY_CHAINS).items():
        kern = slam_chain(paths, extra, tag)
        plain = slam_chain(paths, [*extra, "--nn", "blocked"], tag + "_xla")
        for (k, it_k, e_k), (_, it_p, e_p) in zip(kern, plain):
            log(f"[bunny] {tag} pair {k}: kernels iters={it_k} err={e_k:.6e}"
                f" | plain XLA iters={it_p} err={e_p:.6e}")
            check(np.isfinite(e_k) and e_k <= e_p * 1.01 + 1e-12,
                  f"bunny {tag} pair {k}: err finite and <= plain XLA + 1%")


# ---------------------------------------------------------------------------
# 6. a million points
# ---------------------------------------------------------------------------

def phase_million(n=1_000_000, iters=10, nn_method="auto"):
    from icp_tpu.bench.scaling import synthetic_pair
    from icp_tpu.config import ICPConfig
    from icp_tpu.engine.icp import icp

    model, scene = synthetic_pair(n, n, seed=0)
    cfg = ICPConfig(max_iter=iters, nn_method=nn_method)
    log(f"[1M] nn_method {nn_method} resolves to "
        f"{cfg.resolved_nn_method(n_points=n)}")
    t0 = time.perf_counter()
    res = block(icp(model, scene, cfg))
    log(f"[1M] icp {n}x{n}: iterations={int(res.iters)} err={float(res.err):.6e}"
        f" in {time.perf_counter() - t0:.2f} s (compile included)")
    check(bool(np.isfinite(np.asarray(res.points)).all())
          and np.isfinite(float(res.err)), "1M registration is finite")
    # the same registration on the plain XLA path: an exact blocked NN in
    # every iteration, same solver
    t0 = time.perf_counter()
    plain = block(icp(model, scene, ICPConfig(max_iter=iters,
                                              nn_method="blocked")))
    log(f"[1M] plain XLA (blocked NN): iterations={int(plain.iters)} "
        f"err={float(plain.err):.6e} in {time.perf_counter() - t0:.2f} s")
    a, b = np.asarray(res.points), np.asarray(plain.points)
    diff = float(np.max(np.abs(a - b)))
    log(f"[1M] engine vs plain XLA: max |diff| of the registered points "
        f"{diff:.3e} (atol=1e-4 rtol=2e-4)")
    check(int(res.iters) == int(plain.iters),
          "1M takes the plain XLA path's iteration count")
    # 1e-10: a pair that converges lands at f32 rounding, 1e-5 of the
    # convergence threshold, where a relative bound means nothing
    check(abs(float(res.err) - float(plain.err))
          <= 0.01 * abs(float(plain.err)) + 1e-10,
          "1M err within 1% of the plain XLA path")
    check(bool(np.allclose(a, b, atol=1e-4, rtol=2e-4)),
          "1M registered points match the plain XLA path")


# ---------------------------------------------------------------------------
# 7. timings (findings for PERF.md, not claims)
# ---------------------------------------------------------------------------

def phase_timings(card: str, horse_n=None, million=1_000_000, reps=20,
                  knn_clouds=("bun000",),
                  sweep=(4096, 6144, 8192, 10240, 12288, 14336, 16384),
                  knn_sweep=(4096, 8192, 16384)):
    import jax
    import jax.numpy as jnp

    from icp_tpu.bench.harness import op_time
    from icp_tpu.bench.scaling import synthetic_pair
    from icp_tpu.config import kernel_interpret
    from icp_tpu.engine.grid import _icp_grid
    from icp_tpu.engine.icp import icp_fixed_iters
    from icp_tpu.kernels.nn_pallas import closest_point_pallas
    from icp_tpu.ops.distance import (
        closest_point_blocked,
        closest_point_indices_bcast,
    )
    from icp_tpu.ops.knn import knn

    interp = kernel_interpret()

    def report(what, seconds, unit="iter"):
        log(f"[time] {what}: {seconds * 1e6:.1f} us/{unit} [{card}]")

    cow = (jnp.asarray(load("cow_ref")), jnp.asarray(load("cow_tr1")))
    horse = (jnp.asarray(load("horse_ref")[:horse_n]),
             jnp.asarray(load("horse_tr1")[:horse_n]))
    thr = jnp.asarray(0.0, jnp.float32)

    def loop(m, s, nn, solver="qcp", k=50):
        """Seconds per ICP iteration: one call of ``k`` iterations."""
        if nn == "grid":
            f = jax.jit(lambda a, b: _icp_grid(
                a, b, thr, max_iter=10**6, solver=solver, with_scale=True,
                reference_compat=True, mode="fixed", n_iters=k))
        else:
            f = jax.jit(lambda a, b: icp_fixed_iters(
                a, b, n_iters=k, solver=solver, nn_method=nn))
        return time_per_call(lambda: f(m, s), 3) / k

    # correspondence op alone, ``reps`` calls chained inside one program:
    # the dense kernel against plain XLA
    ops = {
        "nn_dense kernel": lambda m, p, c: closest_point_pallas(
            p + c * 1e-20, m, interpret=interp)[0],
        "bcast XLA": lambda m, p, c: closest_point_indices_bcast(
            p + c * 1e-20, m),
        "blocked XLA": lambda m, p, c: closest_point_blocked(
            p + c * 1e-20, m)[0],
    }
    for name, (m, s) in (("cow", cow), ("horse", horse)):
        for what, fn in ops.items():
            report(f"{what} {name}", op_time(fn, (m, s), reps=reps), "call")
    # whole ICP iteration, each correspondence path, at cow and horse
    for name, (m, s) in (("cow", cow), ("horse", horse)):
        for nn in ("bcast", "pallas", "grid", "blocked"):
            report(f"icp iteration {name} nn={nn}", loop(m, s, nn))
    # alignment solver at cow
    for solver in ("eigh", "qcp"):
        report(f"icp iteration cow nn=bcast solver={solver}",
               loop(*cow, "bcast", solver))
    def sub(a, n):
        """``n`` rows of ``a`` spread evenly over it."""
        return a[::max(1, a.shape[0] // n)][:n]

    # bcast vs dense vs grid crossover on subsampled horse
    for n in sweep:
        m, s = sub(horse[0], n), sub(horse[1], n)
        for nn in ("bcast", "pallas", "grid"):
            report(f"icp iteration horse[{m.shape[0]}] nn={nn}",
                   loop(m, s, nn))
    # kNN dense vs grid from cow to horse size: k=17 (normals) and k=64
    # (the FPFH fetch)
    clouds = ([("cow", cow[0])]
              + [(f"horse[{n}]", sub(horse[0], n)) for n in knn_sweep]
              + [(c, jnp.asarray(load(c))) for c in knn_clouds]
              + [("horse", horse[0])])
    for name, pts in clouds:
        for k in (17, 64):
            for method in ("dense", "grid"):
                f = jax.jit(lambda p, k=k, method=method: knn(p, k,
                                                              method=method))
                report(f"knn k={k} {name}[{pts.shape[0]}] method={method}",
                       time_per_call(lambda: f(pts), 3), "cloud")
    # a million points: grid iteration, and the grid NN against the dense
    # kernel and the blocked XLA fold on 65,536 rows of the scene
    model, scene = synthetic_pair(million, million, seed=0)
    model, scene = jnp.asarray(model), jnp.asarray(scene)
    report(f"icp iteration {million} nn=grid", loop(model, scene, "grid",
                                                    k=5))
    rows = scene[:65536]
    for what, fn in (("nn_dense kernel", ops["nn_dense kernel"]),
                     ("blocked XLA", ops["blocked XLA"])):
        report(f"{what} {rows.shape[0]}x{million}",
               op_time(fn, (model, rows), reps=2), "call")


# ---------------------------------------------------------------------------
# four cards: the sharded engines
# ---------------------------------------------------------------------------

def _parity(sharded, single, what: str, atol=1e-4) -> None:
    it_s, it_1 = int(sharded.iters), int(single.iters)
    a, b = np.asarray(sharded.points), np.asarray(single.points)
    err = float(np.max(np.abs(a - b))) if a.shape == b.shape else float("inf")
    log(f"[4-card] {what}: iters {it_s} vs {it_1}, max |diff| {err:.3e}")
    check(it_s == it_1 and a.shape == b.shape
          and np.allclose(a, b, atol=atol, rtol=2e-4),
          f"{what} matches its single-device engine")


def phase_four_cards(n=1_000_000, iters=5, n_devices=4):
    import jax
    import jax.numpy as jnp

    from icp_tpu.bench.scaling import synthetic_pair
    from icp_tpu.config import ICPConfig
    from icp_tpu.engine.icp import icp
    from icp_tpu.ops.alignment import Similarity
    from icp_tpu.ops.transform import identity_similarity
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import icp_sharded, icp_sharded_2d, make_mesh_2d
    from icp_tpu.slam.pose_graph import bundle_adjust, bundle_adjust_sharded

    devices = jax.devices()[:n_devices]
    check(len(devices) == n_devices, f"{n_devices} devices present")
    mesh = make_mesh(devices)
    model, scene = synthetic_pair(n, n, seed=0)
    base = dict(max_iter=iters, threshold=0.0, validate_inputs=False)
    for nn in ("pallas", "grid"):
        cfg = ICPConfig(nn_method=nn, **base)
        t0 = time.perf_counter()
        single = block(icp(model, scene, cfg))
        log(f"[4-card] single-device nn={nn}: {time.perf_counter() - t0:.2f} s")
        rings = (True, False) if nn == "pallas" else (True,)
        for ring in rings:
            t0 = time.perf_counter()
            res = block(icp_sharded(model, scene, cfg, mesh=mesh, ring=ring))
            log(f"[4-card] icp_sharded nn={nn} ring={ring}: "
                f"{time.perf_counter() - t0:.2f} s")
            _parity(res, single, f"icp_sharded nn={nn} ring={ring}")
        if nn == "pallas":
            mesh2 = make_mesh_2d(2, n_devices // 2, devices)
            t0 = time.perf_counter()
            res = block(icp_sharded_2d(model, scene, cfg, mesh=mesh2))
            log(f"[4-card] icp_sharded_2d 2x{n_devices // 2}: "
                f"{time.perf_counter() - t0:.2f} s")
            _parity(res, single, "icp_sharded_2d")
    # distributed bundle adjustment over the pair's n correspondences
    R = np.asarray([[np.cos(0.1), -np.sin(0.1), 0.0],
                    [np.sin(0.1), np.cos(0.1), 0.0], [0, 0, 1]], np.float32)
    frame1 = model @ R.T + np.float32([0.05, 0.0, -0.1])
    init = [identity_similarity(jnp.float32),
            Similarity(s=jnp.asarray(1.0, jnp.float32),
                       R=jnp.eye(3, dtype=jnp.float32),
                       t=jnp.asarray([0.1, 0.0, 0.0], jnp.float32))]
    corr = [(0, 1, model, frame1)]
    _, cost_0 = bundle_adjust(init, corr, n_iters=0)
    opt_1, cost_1 = bundle_adjust(init, corr, n_iters=3)
    opt_s, cost_s = bundle_adjust_sharded(init, corr, mesh=mesh, n_iters=3)
    worst = max(float(np.max(np.abs(np.asarray(a.R) - np.asarray(b.R))))
                for a, b in zip(opt_s, opt_1))
    log(f"[4-card] bundle_adjust_sharded: cost {cost_s:.6e} vs "
        f"{cost_1:.6e} (initial {cost_0:.6e}), max |dR| {worst:.3e}")
    # both solves reach the same minimum: the final costs agree to 1e-9 of
    # the initial cost (they sit at f32 rounding, where a ratio between
    # them means nothing)
    check(abs(cost_s - cost_1) <= 1e-9 * cost_0
          and worst < 1e-4
          and all(np.allclose(np.asarray(a.t), np.asarray(b.t), atol=1e-4)
                  for a, b in zip(opt_s, opt_1)),
          "bundle_adjust_sharded matches bundle_adjust")


# ---------------------------------------------------------------------------

ONE_CARD_PHASES = ("kernels", "gpu_tests", "cow", "horse", "bunny", "million",
                   "timings")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device engines on four cards")
    ap.add_argument("--only", nargs="+", default=None, metavar="PHASE",
                    help="run only these one-card phases: "
                         + ", ".join(ONE_CARD_PHASES))
    args = ap.parse_args(argv)
    unknown = set(args.only or ()) - set(ONE_CARD_PHASES)
    if unknown:
        ap.error(f"unknown phase(s): {sorted(unknown)}")

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    from icp_tpu.utils.cache import enable_compile_cache

    card = card_line()
    log(f"card: {card}")
    log(f"devices: {devices}")
    log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f"; compile cache: {enable_compile_cache()}")
    os.makedirs(OUT, exist_ok=True)
    if args.four_cards:
        phases = [("four_cards", phase_four_cards)]
    else:
        phases = [
            ("kernels", phase_kernels),
            ("gpu_tests", phase_gpu_tests),
            ("cow", phase_cow),
            ("horse", phase_horse),
            ("bunny", phase_bunny),
            ("million", phase_million),
            ("timings", lambda: phase_timings(card)),
        ]
        phases = [(n, f) for n, f in phases if n in (args.only or [n])]
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        fn()
        log(f"== phase {name} done in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
