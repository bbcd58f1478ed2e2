#!/usr/bin/env python
"""Capture a device profile of the cow loop (the callgrind analog).

The reference commits its profiler capture (``benchmark/callgrind.out.76685``
— 372.8G instructions for a 10-iteration cow run) and derives its report's
bottleneck tables from it.  This script is our equivalent: a
``jax.profiler`` trace of (a) the cow workload on the resolved
correspondence and solver paths and (b) the one-jit global-registration
pipeline.

Run it alone on the card (one process per card):

    python scripts/capture_trace.py [OUT_DIR]   # default chiprun_out/trace
"""

import os
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = argv[0] if argv else os.path.join(root, "chiprun_out", "trace")

    import jax
    import jax.numpy as jnp

    from icp_tpu.engine.global_reg import global_register
    from icp_tpu.engine.icp import icp_fixed_iters
    from icp_tpu.io.csv import load_matrix

    ref = jnp.asarray(load_matrix(os.path.join(root, "data", "cow_ref.txt")),
                      jnp.float32)
    tr1 = jnp.asarray(load_matrix(os.path.join(root, "data", "cow_tr1.txt")),
                      jnp.float32)
    from icp_tpu.config import resolve_nn_method, resolve_solver
    from icp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    nn = resolve_nn_method("auto", n_points=ref.shape[0])
    solver = resolve_solver("auto")

    def loop(n):
        r = icp_fixed_iters(ref, tr1, n_iters=n, solver=solver, nn_method=nn)
        return jax.block_until_ready(r)

    # warm/compile OUTSIDE the trace so the capture shows steady state
    loop(20)
    g = global_register(ref, tr1, n_hypotheses=256)
    float(g.inlier_fraction)

    with jax.profiler.trace(out):
        with jax.profiler.TraceAnnotation("icp_fixed_iters_520"):
            loop(520)
        with jax.profiler.TraceAnnotation("global_register"):
            g = global_register(ref, tr1, n_hypotheses=256)
            float(g.inlier_fraction)
    print(f"[trace] wrote {out}", file=sys.stderr)
    for dirpath, _, files in os.walk(out):
        for f in files:
            p = os.path.join(dirpath, f)
            print(f"  {os.path.relpath(p, root)}  {os.path.getsize(p)} B",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
