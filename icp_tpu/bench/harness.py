"""Benchmark harness — the reference's 14-benchmark matrix.

Reference counterpart: ``src/bench.cc:391-447`` (Google Benchmark over
{CPU, GPU-naive, GPU-opti} x {full loop, closest, find_alignment, centroid,
err_compute, err_compute_alignment} on the cow pair, ``frame_rate`` counters).
Here each op is benchmarked as a jitted program on the current backend:
``op_time`` runs the op ``reps`` times inside one on-device loop (each call
consuming the previous one's result, so XLA cannot hoist it) and times it
from dispatch to ``block_until_ready`` after a warm-up; ``wall_time`` is
the best-of-N wall time of a call that blocks on its result.

Outputs one JSON object per benchmark on stdout (stderr carries progress),
mirroring the reference's stdout-metrics/stderr-logs split (``README.md:84``).
Every row names the device it ran on.  Roofline shares are "not measured"
until the benchmark derives per-layer operation and byte counts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _progress(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_pair(workload: str = "cow"):
    from icp_tpu.io.csv import load_matrix

    d = os.path.join(repo_root(), "data")
    ref = load_matrix(os.path.join(d, f"{workload}_ref.txt"))
    tr1 = load_matrix(os.path.join(d, f"{workload}_tr1.txt"))
    return ref, tr1


def load_cow():
    return load_pair("cow")


def op_time(fn, args, reps: int = 200, inner: int = 1):
    """Per-call time of ``fn(*args, carry)``.

    ``fn`` must fold its carry argument into its inputs (e.g. ``p + c*1e-20``)
    so XLA cannot hoist the body out of the loop.  ``inner``: carry-chained
    copies of ``fn`` per loop step (lifts sub-microsecond ops above the
    timer's resolution without changing per-call semantics).
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(*a):
        def body(_, c):
            for _k in range(inner):
                out = fn(*a, c)
                leaf = jax.tree.leaves(out)[0]
                c = c + jnp.sum(leaf).astype(jnp.float32) * 1e-12
            return c

        return jax.lax.fori_loop(0, reps, body, jnp.float32(0))

    jax.block_until_ready(loop(*args))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(loop(*args))
    return (time.perf_counter() - t0) / (reps * inner)


def wall_time(fn, reps: int = 5):
    """Best-of-reps wall time of ``fn()`` (must block on its result)."""
    fn()  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


_EPS = 1e-20


def _numpy_icp(ref: np.ndarray, scene: np.ndarray, n_iters: int):
    """``n_iters`` sequential host-NumPy ICP iterations (brute-force chunked
    NN + Horn quaternion solve + apply/error — the same per-iteration op
    sequence as the device engines, f64 like the reference).  Returns
    ``(wall_seconds, final_points)`` — the dual-engine baseline row."""
    m = np.asarray(ref, np.float64)
    p = np.asarray(scene, np.float64).copy()
    mn = np.sum(m * m, axis=1)
    chunk = max(1, int(2e7 // max(len(m), 1)))  # cap the distance block

    def nn(p):
        out = np.empty(len(p), np.int64)
        for i in range(0, len(p), chunk):
            blk = p[i:i + chunk]
            d = mn[None, :] - 2.0 * (blk @ m.T)
            out[i:i + chunk] = np.argmin(d, axis=1)
        return out

    def horn(p, y):
        mu_p, mu_y = p.mean(0), y.mean(0)
        pc, yc = p - mu_p, y - mu_y
        S = pc.T @ yc
        tr = np.trace(S)
        delta = np.array([S[1, 2] - S[2, 1], S[2, 0] - S[0, 2],
                          S[0, 1] - S[1, 0]])
        N = np.empty((4, 4))
        N[0, 0] = tr
        N[0, 1:] = N[1:, 0] = delta
        N[1:, 1:] = S + S.T - tr * np.eye(3)
        w, V = np.linalg.eigh(N)
        q = V[:, np.argmax(w)]
        a, b, c, d = q
        R = np.array([
            [a*a + b*b - c*c - d*d, 2*(b*c - a*d), 2*(b*d + a*c)],
            [2*(b*c + a*d), a*a - b*b + c*c - d*d, 2*(c*d - a*b)],
            [2*(b*d - a*c), 2*(c*d + a*b), a*a - b*b - c*c + d*d],
        ])
        s = np.sqrt(np.sum(yc * yc) / max(np.sum(pc * pc), 1e-30))
        t = mu_y - s * (R @ mu_p)
        return s, R, t

    t0 = time.perf_counter()
    for _ in range(n_iters):
        y = m[nn(p)]
        s, R, t = horn(p, y)
        p = s * (p @ R.T) + t
        _ = float(np.sum((y - p) ** 2))  # the error pass
    return time.perf_counter() - t0, p


def device_info() -> dict:
    """The device every row was measured on."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def benchmark_matrix(n_iters: int = 20, include=None, workload: str = "cow"):
    """Run the op-level matrix; returns a list of result dicts."""
    import jax
    import jax.numpy as jnp

    from icp_tpu.config import resolve_backend, resolve_nn_method, resolve_solver
    from icp_tpu.engine.icp import icp_fixed_iters
    from icp_tpu.ops.alignment import (
        alignment_from_stats,
        compute_alignment_stats,
    )
    from icp_tpu.ops.distance import (
        closest_point_blocked,
        closest_point_indices_bcast,
        closest_point_indices_matmul,
    )
    from icp_tpu.ops.transform import apply_and_error, identity_similarity

    ref_np, tr1_np = load_pair(workload)
    ref = jnp.asarray(ref_np, jnp.float32)
    tr1 = jnp.asarray(tr1_np, jnp.float32)
    on_gpu = resolve_backend() == "gpu"
    n, m = ref.shape[0], tr1.shape[0]
    n_pairs = n * m  # correspondence problem size
    nn_method = resolve_nn_method("auto", n_points=max(n, m))
    solver = resolve_solver("auto")

    def nn_bcast(m_, p, c):
        return closest_point_indices_bcast(p + c * _EPS, m_)

    def nn_matmul(m_, p, c):
        return closest_point_indices_matmul(p + c * _EPS, m_)

    def nn_blocked(m_, p, c):
        return closest_point_blocked(p + c * _EPS, m_)[0]

    def find_alignment(m_, p, c):
        pp = p + c * _EPS
        sim = alignment_from_stats(compute_alignment_stats(pp, m_),
                                   solver=solver)
        # R first: the timing loop folds the FIRST leaf into the carry, and
        # returning s first would let XLA dead-code-eliminate the whole
        # eigenvector chain (s only needs the norm sums).
        return sim.R, sim.s, sim.t

    def centroid(m_, p, c):
        return jnp.mean(p + c * _EPS, axis=0)

    def err_compute(m_, p, c):
        sim = identity_similarity(jnp.float32)
        return apply_and_error(p + c * _EPS, m_, sim)[1]

    def err_compute_alignment(m_, p, c):
        # the reference's NON-mutating residual variant (src/cpu.cc:93-103,
        # registered as its own benchmark at src/bench.cc:427-431): same
        # residual math, transformed cloud discarded.
        sim = identity_similarity(jnp.float32)
        return apply_and_error(p + c * _EPS, m_, sim)[1], m_

    ops = {
        "closest_bcast": nn_bcast,
        "closest_matmul": nn_matmul,
        "closest_blocked": nn_blocked,
        "find_alignment": find_alignment,
        "compute_centroid": centroid,
        "err_compute": err_compute,
        "err_compute_alignment": err_compute_alignment,
    }
    # The matmul row materializes the N x M f32 matrix; cap it.
    if n_pairs > 4e8:
        ops.pop("closest_matmul")
        _progress(f"op closest_matmul: skipped (materializes "
                  f"{n_pairs * 4 / 1e9:.1f} GB)")
    if on_gpu:
        from icp_tpu.engine.grid import _prepare_scene
        from icp_tpu.kernels.nn_grid import (
            bound_from_indices,
            build_model_grid,
            closest_point_indices_grid,
        )
        from icp_tpu.kernels.nn_pallas import closest_point_pallas

        def nn_pallas(m_, p, c):
            return closest_point_pallas(p + c * _EPS, m_)[0]

        ops["closest_pallas"] = nn_pallas
        # steady-state grid NN: kd-sorted (padded) scene, previous-iteration
        # bounds (what every post-first ICP iteration sees)
        grid = build_model_grid(ref)
        p_kd, _, _, tn, _ = _prepare_scene(ref, 256)  # converged: scene == ref
        prev = closest_point_pallas(p_kd, ref)[0]
        u_prev = bound_from_indices(p_kd, grid, prev)

        def nn_grid(m_, p, c):
            return closest_point_indices_grid(
                p_kd + c * _EPS, grid, u_prev + c * _EPS, scene_tile=tn
            )[0]

        ops["closest_grid"] = nn_grid

    dev = device_info()
    op_timing = {
        "compute_centroid": dict(inner=16),
        "err_compute": dict(inner=16),
        "err_compute_alignment": dict(inner=16),
    }
    results = []
    for name, fn in ops.items():
        if include and name not in include:
            continue
        _progress(f"op {name} ...")
        per = op_time(fn, (ref, tr1), **op_timing.get(name, {}))
        row = dict(benchmark=name, time_us=per * 1e6, rate_per_s=1.0 / per,
                   roofline_share="not measured", device=dev)
        if name.startswith("closest"):
            row["point_pairs_per_s"] = n_pairs / per
        results.append(row)
        _progress(f"op {name}: {per*1e6:.2f} us")

    def per_iter_of(run_k, k):
        """Wall time of one ``k``-iteration call, over ``k``."""
        return wall_time(lambda: jax.block_until_ready(run_k(k))) / k

    if not include or "full_loop" in include:
        _progress("full loop ...")
        k = 20 * n_iters
        per_iter = per_iter_of(
            lambda k: icp_fixed_iters(ref, tr1, n_iters=k, solver=solver,
                                      nn_method=nn_method), k)
        results.append(dict(
            benchmark="full_loop_per_iter",
            time_us=per_iter * 1e6,
            rate_per_s=1.0 / per_iter,
            point_pairs_per_s=n_pairs / per_iter,
            nn_method=nn_method, solver=solver, iters_per_call=k,
            roofline_share="not measured", device=dev,
        ))
        _progress(f"full loop: {per_iter*1e6:.1f} us/iter ({nn_method})")

    if (not include or "full_loop_grid" in include) and on_gpu:
        from icp_tpu.engine.grid import _icp_grid

        thr = jnp.asarray(0.0, jnp.float32)
        _progress("full loop (grid NN) ...")
        k = 20 * n_iters
        per_iter = per_iter_of(
            lambda k: _icp_grid(ref, tr1, thr, max_iter=10**6, solver=solver,
                                with_scale=True, reference_compat=True,
                                mode="fixed", n_iters=k), k)
        results.append(dict(
            benchmark="full_loop_grid_per_iter",
            time_us=per_iter * 1e6,
            rate_per_s=1.0 / per_iter,
            point_pairs_per_s=n_pairs / per_iter,
            device=dev,
        ))
        _progress(f"full loop (grid): {per_iter*1e6:.1f} us/iter")

    if not include or "full_loop_numpy" in include:
        # Side-by-side dual-engine row (reference: bench links the CPU and
        # GPU engines into ONE binary and reports both, src/bench.cc:391-447)
        # — a sequential NumPy host engine doing the same per-iteration work
        # (brute-force NN, Horn 4x4 solve, apply+error) timed in the same
        # artifact.
        _progress("full loop (numpy host engine) ...")
        t_np, _ = _numpy_icp(ref_np, tr1_np, n_iters)
        per_iter = t_np / n_iters
        results.append(dict(
            benchmark="full_loop_numpy_per_iter",
            time_us=per_iter * 1e6,
            rate_per_s=1.0 / per_iter,
            point_pairs_per_s=n_pairs / per_iter,
            # host-BLAS wall on shared cores: a context row, not a gated one
            gate=False,
        ))
        _progress(f"full loop (numpy): {per_iter*1e6:.0f} us/iter")

    if not include or "global_register" in include:
        # Global registration pipeline (FPFH + spectral filter + batched
        # RANSAC, engine/global_reg.py) on a 150-degree pose offset of the
        # workload cloud: the initialization a user pays once per pair.
        from icp_tpu.engine.global_reg import global_register

        ang = 2.618  # 150 degrees
        R_g = np.array(
            [[np.cos(ang), -np.sin(ang), 0.0],
             [np.sin(ang), np.cos(ang), 0.0],
             [0.0, 0.0, 1.0]], np.float32)
        scene_rot = np.asarray(ref_np, np.float32) @ R_g.T + np.array(
            [1.0, -2.0, 0.5], np.float32)

        def run_greg():
            res = global_register(ref_np, scene_rot, seed=0)
            float(res.inlier_fraction)

        _progress("global_register ...")
        t_g = wall_time(run_greg, reps=5)
        results.append(dict(benchmark="global_register_wall",
                            time_us=t_g * 1e6, rate_per_s=1.0 / t_g,
                            device=dev))
        _progress(f"global_register: {t_g*1e3:.1f} ms wall")

    if not include or "batched_bucketed" in include:
        # Bucketed 4-pair batch: four UNEQUAL-size pairs padded into one
        # bucket, registered concurrently by one vmapped program — the
        # serving-shape analog of the reference's frame_rate counter
        # (src/bench.cc:78).
        from icp_tpu.engine.batched import batch_pairs, icp_batched

        sizes = [(len(ref_np), len(tr1_np)),
                 (len(ref_np) * 9 // 10, len(tr1_np) * 8 // 10),
                 (len(ref_np) * 7 // 8, len(tr1_np)),
                 (len(ref_np), len(tr1_np) * 9 // 10)]
        b_pairs = [(ref_np[:nm], tr1_np[:ns]) for nm, ns in sizes]
        models_b, scenes_b, m_ns, s_ns = batch_pairs(b_pairs, quantum=512)
        models_b = jnp.asarray(models_b)
        scenes_b = jnp.asarray(scenes_b)
        B = models_b.shape[0]
        _progress(f"bucketed batch ({B} unequal pairs) ...")
        t_call = wall_time(lambda: jax.block_until_ready(icp_batched(
            models_b, scenes_b, n_iters=n_iters, solver=solver,
            nn_method="bcast", scene_ns=s_ns, model_ns=m_ns)))
        results.append(dict(
            benchmark="batched_bucketed_registrations",
            batch=B,
            pair_sizes=[[int(a), int(b)] for a, b in sizes],
            bucket=[int(models_b.shape[1]), int(scenes_b.shape[1])],
            time_us=t_call * 1e6,
            registrations_per_s=B / t_call,
            rate_per_s=1.0 / t_call,
            device=dev,
        ))
        _progress(f"bucketed batch: {B / t_call:.0f} registrations/s "
                  f"at {n_iters} iters each")

    if not include or "full_loop_sharded" in include:
        # Sharded engine on whatever mesh this host has: measures the
        # shard_map + collectives overhead vs the plain loop.
        from icp_tpu.config import ICPConfig
        from icp_tpu.parallel.mesh import make_mesh
        from icp_tpu.parallel.sharded import icp_sharded

        mesh = make_mesh()
        n_dev = mesh.devices.size
        cfg_sh = ICPConfig(
            max_iter=1, threshold=0.0, solver=solver,
            nn_method=resolve_nn_method("auto"), reference_compat=True,
        )
        _progress(f"full loop (sharded, {n_dev} dev) ...")
        k = 20 * n_iters
        per_iter = per_iter_of(
            lambda k: icp_sharded(ref_np, tr1_np, cfg_sh, mesh=mesh,
                                  n_iters=k), k)
        results.append(dict(
            benchmark="full_loop_sharded_per_iter",
            time_us=per_iter * 1e6,
            rate_per_s=1.0 / per_iter,
            point_pairs_per_s=n_pairs / per_iter,
            n_devices=n_dev,
            device=dev,
        ))
        _progress(f"full loop (sharded): {per_iter*1e6:.1f} us/iter")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="icp-bench")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--workload", default="cow", choices=["cow", "horse"])
    args = ap.parse_args(argv)
    from icp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    for r in benchmark_matrix(
        n_iters=args.iters, include=args.only, workload=args.workload
    ):
        r["workload"] = args.workload
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
