"""Command-line interface mirroring the reference binaries.

Reference surface (``src/main.cc:6-25``, ``src/GPU/main.cc:3-21``):
  ``./icp [path_to_ref_cloud] [path_to_transform_cloud] [nb_iter]``
  * missing args  -> usage on stdout, exit status of ``return -1`` (255)
  * unopenable file -> ``[load] ...`` on stderr, exit 2
  * per-iteration  ``[ICP] iteration number i | error value = e`` on stderr
  * result cloud -> ``output.txt`` (+ ``[output] ...`` notice on stderr)

Extras beyond the reference (flags, all optional): ``--threshold``,
``--solver``, ``--nn``, ``--dtype``, ``--no-scale``, ``--no-validate``,
``--output``, ``--mse`` (plain-MSE error metric), ``--engine``
(point_to_point / point_to_plane / gicp), ``--sharded`` (multi-chip),
``--checkpoint`` / ``--checkpoint-every`` / ``--resume`` (periodic state
saves + kill-safe resume), ``--metrics`` (structured JSON run record).

Documented CLI-surface divergence from the reference: ``nb_iter`` is parsed
with ``int()`` — a non-integer argument exits 2 with an argparse error,
whereas the reference's ``std::atoi`` silently treats garbage as 0 and runs
0 iterations (``src/main.cc:14``).  Strict atoi emulation would silently mask
user error, so the stricter behavior is kept deliberately.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="icp",
        usage="icp [path_to_ref_cloud] [path_to_transform_cloud] [nb_iter]",
        description="ICP point-cloud registration",
    )
    p.add_argument("ref", help="reference (model) cloud CSV")
    p.add_argument("scene", help="cloud to transform CSV")
    p.add_argument("nb_iter", type=int, help="max iterations")
    p.add_argument("--threshold", type=float, default=1e-5)
    p.add_argument("--solver", default="auto",
                   choices=["auto", "eigh", "qcp", "kabsch"])
    p.add_argument("--nn", default="auto",
                   choices=["auto", "bcast", "matmul", "blocked", "pallas",
                            "grid"])
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--no-scale", action="store_true", help="rigid (SE3) alignment")
    p.add_argument("--trim", type=float, default=0.0, metavar="FRAC",
                   help="trimmed ICP: reject this fraction of worst matches")
    p.add_argument("--no-validate", action="store_true",
                   help="lift the np==nm reference restriction")
    p.add_argument("--mse", action="store_true",
                   help="report plain MSE instead of the reference's 2x metric")
    p.add_argument("--output", default="output.txt")
    p.add_argument("--engine", default="point_to_point",
                   choices=["point_to_point", "point_to_plane", "gicp",
                            "symmetric"],
                   help="registration metric (single-device AND --sharded)")
    p.add_argument("--sharded", action="store_true",
                   help="shard points over all available devices")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="save transform state (s, R, t, iter, err) as npz")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K",
                   help="save the checkpoint every K iterations (runs the "
                        "loop in K-iteration chunks; requires --checkpoint)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the --checkpoint file if it exists "
                        "(bit-for-bit continuation of a killed run)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="write a structured JSON run record (per-iteration "
                        "error trace, iters, wall time, backend/op config)")
    p.add_argument("--metrics-ops", action="store_true",
                   help="with --metrics: also measure the per-iteration "
                        "correspondence/alignment time split "
                        "(adds benchmark time)")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        # Reference parity: usage on STDOUT, return -1 (src/main.cc:8-12).
        print("Usage: icp [path_to_ref_cloud] [path_to_transform_cloud] [nb_iter]")
        return -1
    args = build_parser().parse_args(argv)

    import jax

    if args.dtype == "float64":
        # Without x64, jnp.asarray(..., float64) silently downcasts to f32
        # and the oracle-parity guarantees of the f64 path evaporate.  Enable
        # it before any array touches the backend.
        jax.config.update("jax_enable_x64", True)
    from icp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from icp_tpu.config import ICPConfig
    from icp_tpu.engine.icp import icp
    from icp_tpu.io.csv import load_matrix, write_matrix

    model = load_matrix(args.ref)
    scene = load_matrix(args.scene)

    cfg = ICPConfig(
        max_iter=args.nb_iter,
        threshold=args.threshold,
        dtype=jnp.float64 if args.dtype == "float64" else jnp.float32,
        solver=args.solver,
        nn_method=args.nn,
        with_scale=not args.no_scale,
        validate_inputs=not args.no_validate,
        reference_compat=not args.mse,
        trim_fraction=args.trim,
    )

    if (args.checkpoint_every or args.resume) and not args.checkpoint:
        print("--checkpoint-every/--resume require --checkpoint PATH",
              file=sys.stderr)
        return -1
    # the run-mode flags select mutually exclusive drivers; a silent
    # precedence order would drop e.g. --metrics under --sharded
    modes = [m for m, on in (("--checkpoint-every/--resume",
                              args.checkpoint_every or args.resume),
                             ("--sharded", args.sharded),
                             ("--metrics", bool(args.metrics))) if on]
    if len(modes) > 1:
        print(f"{' and '.join(modes)} cannot be combined", file=sys.stderr)
        return -1
    if args.engine != "point_to_point" and (
        args.checkpoint_every or args.resume or args.metrics
    ):
        # the GN engines have no resumable/metrics drivers (yet)
        print(f"--engine {args.engine} supports only the plain and "
              "--sharded run modes", file=sys.stderr)
        return -1

    try:
        if args.checkpoint_every or args.resume:
            from icp_tpu.engine.icp import icp_resumable

            res = icp_resumable(
                model, scene, cfg,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every or 50,
                resume=args.resume,
            )
            errs, iters = None, int(res.iters)
        elif args.sharded:
            if args.engine == "point_to_plane":
                from icp_tpu.engine.point_to_plane import (
                    icp_point_to_plane_sharded as run_sharded,
                )
            elif args.engine == "gicp":
                from icp_tpu.engine.gicp import (
                    icp_generalized_sharded as run_sharded,
                )
            elif args.engine == "symmetric":
                from icp_tpu.engine.symmetric import (
                    icp_symmetric_sharded as run_sharded,
                )
            else:
                from icp_tpu.parallel.sharded import icp_sharded as run_sharded

            tr = run_sharded(model, scene, cfg, trace=True)
            res = tr.result
            iters = int(res.iters)
            errs = np.asarray(tr.errs)[:iters]
        elif args.metrics:
            from icp_tpu.utils.metrics import run_with_metrics

            tr, rec = run_with_metrics(model, scene, cfg,
                                       measure_ops=args.metrics_ops)
            res = tr.result
            iters = rec.iters
            errs = np.asarray(tr.errs)[:iters]
            with open(args.metrics, "w") as f:
                f.write(rec.to_json() + "\n")
            print(f"[metrics] written to {args.metrics}", file=sys.stderr)
        else:
            if args.engine == "point_to_plane":
                from icp_tpu.engine.point_to_plane import icp_point_to_plane

                tr = icp_point_to_plane(model, scene, cfg, trace=True)
            elif args.engine == "gicp":
                from icp_tpu.engine.gicp import icp_generalized

                tr = icp_generalized(model, scene, cfg, trace=True)
            elif args.engine == "symmetric":
                from icp_tpu.engine.symmetric import icp_symmetric

                tr = icp_symmetric(model, scene, cfg, trace=True)
            else:
                tr = icp(model, scene, cfg, trace=True)
            res = tr.result
            iters = int(res.iters)
            errs = np.asarray(tr.errs)[:iters]
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return -1

    if errs is not None:
        # Reference's per-iteration stderr log (src/cpu.cc:61,74).
        for i, e in enumerate(errs):
            print(f"[ICP] iteration number {i} | error value = {e:g}", file=sys.stderr)
    else:
        print(f"[ICP] converged after {iters} iterations | "
              f"error value = {float(res.err):g}", file=sys.stderr)

    write_matrix(np.asarray(res.points), args.output)

    if args.checkpoint:
        from icp_tpu.utils.checkpoint import save_checkpoint

        save_checkpoint(
            args.checkpoint,
            transform=res.transform,
            iteration=iters,
            err=float(res.err),
        )
        print(f"[checkpoint] saved to {args.checkpoint}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
