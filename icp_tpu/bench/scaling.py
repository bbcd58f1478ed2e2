"""Weak/strong-scaling benchmark on synthetic million-point clouds.

BASELINE.json config 4: "Synthetic 1M+ point clouds, scene points sharded
across chips with all-gather NN search" — target >=80% weak-scaling
efficiency.  On a CPU host this runs against the virtual 8-device mesh (the
testing story for multi-device, SURVEY.md §4d); on a multi-GPU host it runs
over the real cards.  Emits one JSON line per (devices, points) cell.

Weak scaling: points per device held constant; perfect scaling = constant
wall time as devices grow.  Efficiency = t(1 device) / t(n devices).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _progress(msg):
    print(f"[scaling] {msg}", file=sys.stderr, flush=True)


def synthetic_pair(n_model: int, n_scene: int, seed: int = 0):
    """Model cloud + rigidly transformed scene (known ground truth).

    Scene size is independent of model size: weak scaling holds per-device
    work (scene_shard x model) constant by growing ONLY the scene with the
    device count — growing both would double per-device work per doubling
    (brute-force NN is O(N*M)).
    """
    rng = np.random.default_rng(seed)
    model = rng.standard_normal((n_model, 3)).astype(np.float32) * 2.0
    reps = -(-n_scene // n_model)
    base = np.tile(model, (reps, 1))[:n_scene]
    theta = 0.1
    R = np.array(
        [
            [np.cos(theta), -np.sin(theta), 0],
            [np.sin(theta), np.cos(theta), 0],
            [0, 0, 1],
        ],
        np.float32,
    )
    scene = base @ R.T + np.array([0.05, -0.03, 0.08], np.float32)
    return model, scene


def run_cell(
    n_devices: int, points_per_device: int, n_iters: int, ring: bool,
    model_points: int = 65536, reps: int = 3,
):
    import jax
    import jax.numpy as jnp

    from icp_tpu.config import ICPConfig
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import icp_sharded

    devices = jax.devices()[:n_devices]
    mesh = make_mesh(devices)
    n = points_per_device * n_devices
    model, scene = synthetic_pair(model_points, n)
    cfg = ICPConfig(
        max_iter=n_iters,
        threshold=0.0,  # run all iterations (throughput measurement)
        dtype=jnp.float32,
        solver="auto",
        validate_inputs=False,
    )
    # warm + compile
    res = jax.block_until_ready(icp_sharded(model, scene, cfg, mesh=mesh,
                                            ring=ring))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(icp_sharded(model, scene, cfg, mesh=mesh,
                                                ring=ring))
        best = min(best, time.perf_counter() - t0)
    return dict(
        devices=n_devices,
        points=n,
        points_per_device=points_per_device,
        iters=n_iters,
        wall_s=best,
        iter_per_s=n_iters / best,
        point_iter_per_s=n * n_iters / best,
        ring=ring,
        err=float(res.err),
    )


def main(argv=None) -> int:
    import jax

    ap = argparse.ArgumentParser(prog="icp-scaling")
    ap.add_argument("--points-per-device", type=int, default=65536)
    ap.add_argument("--model-points", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ring", action="store_true", default=True)
    ap.add_argument("--all-gather", dest="ring", action="store_false")
    ap.add_argument(
        "--devices", type=int, nargs="*", default=None,
        help="device counts to sweep (default: 1, 2, 4, ..., all)",
    )
    args = ap.parse_args(argv)
    from icp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    n_avail = len(jax.devices())
    counts = args.devices
    if not counts:
        counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_avail]
    base = None
    for d in counts:
        _progress(f"devices={d} points={args.points_per_device * d} ...")
        cell = run_cell(d, args.points_per_device, args.iters, args.ring)
        if base is None:
            base = cell["wall_s"]
        cell["weak_scaling_efficiency"] = round(base / cell["wall_s"], 3)
        print(json.dumps(cell))
    return 0


if __name__ == "__main__":
    sys.exit(main())
