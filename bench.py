#!/usr/bin/env python
"""Headline benchmark: ICP iterations/s on the cow pair, on one device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Baseline = the reference's best engine (GPU-opti on GTX 1050): 20 ICP
iterations of the cow pair in 107 ms => ~187 iter/s (BASELINE.md).

Timing protocol: the full fixed-iteration ICP loop (correspondence + Horn
alignment + apply/error per iteration, all on device) as one call of many
iterations, timed from dispatch to ``block_until_ready`` after a warm-up,
best of several calls.  A convergence run is executed first to assert the
result is correct (err < 1e-5, the reference's threshold) before any number
is reported.  A failing path is an error, never a silent fallback.

The measurement runs in a child process (``bench.py --measure``) that
emits phase markers on stderr; the parent enforces a per-phase watchdog
and a total budget, kills the child's process group on expiry, retries
with backoff, and on final failure emits a diagnostic JSON line (phase
reached, elapsed, stderr tail per attempt) instead of hanging.

Env knobs (seconds unless noted):
  ICP_BENCH_INIT_TIMEOUT=600     backend-init phase watchdog
  ICP_BENCH_GATE_TIMEOUT=1200    convergence-gate phase (includes 1st compile)
  ICP_BENCH_MEASURE_TIMEOUT=1500 timing phase
  ICP_BENCH_ATTEMPTS=2           supervised attempts
  ICP_BENCH_BACKOFF=20           sleep between attempts
  ICP_BENCH_TOTAL_TIMEOUT=2700   hard budget across all attempts
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

METRIC = "icp_iter_per_s_cow"
BASELINE_ITER_PER_S = 187.0

PHASES = ("spawn", "init", "gate", "measure", "done")
PHASE_MARK = "[bench:phase]"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# --------------------------------------------------------------------------
# Child: the actual measurement (runs in its own process group)
# --------------------------------------------------------------------------

def _phase(name: str) -> None:
    print(f"{PHASE_MARK} {name}", file=sys.stderr, flush=True)
    if os.environ.get("ICP_BENCH_TEST_HANG") == name:
        time.sleep(3600)  # test hook: simulate a hang in this phase
    once = os.environ.get("ICP_BENCH_TEST_HANG_ONCE_FILE")
    if once and name == "init" and os.path.exists(once):
        os.remove(once)  # test hook: hang the FIRST attempt only
        time.sleep(3600)


def measure() -> int:
    _phase("init")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from icp_tpu.bench.harness import device_info, load_cow, wall_time
    from icp_tpu.config import ICPConfig, resolve_nn_method, resolve_solver
    from icp_tpu.engine.icp import icp, icp_fixed_iters
    from icp_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    # Initialize the backend NOW so a broken one fails inside this phase.
    jax.block_until_ready(jnp.zeros(()))

    ref_np, tr1_np = load_cow()
    ref = jnp.asarray(ref_np, jnp.float32)
    tr1 = jnp.asarray(tr1_np, jnp.float32)
    solver = resolve_solver("auto")
    nn_method = resolve_nn_method("auto", n_points=max(len(ref_np),
                                                       len(tr1_np)))

    _phase("gate")
    # Correctness gate: must converge within the reference threshold, and the
    # registered cloud must land on the reference cloud (cow_tr1 is an exact
    # transform of cow_ref) — the "alignment RMSE vs reference transform"
    # metric from BASELINE.json.
    res = icp(
        ref_np,
        tr1_np,
        ICPConfig(max_iter=30, solver=solver, nn_method=nn_method),
    )
    err = float(res.err)
    iters = int(res.iters)
    rmse = float(np.sqrt(np.mean(np.sum((np.asarray(res.points) - ref_np) ** 2, axis=1))))
    print(
        f"[bench] convergence gate: err={err:.3e} iters={iters} "
        f"alignment_rmse_vs_ref={rmse:.3e}",
        file=sys.stderr, flush=True,
    )
    if not (err < 1e-5):
        print(json.dumps({"metric": METRIC, "value": 0.0,
                          "unit": "iter/s", "vs_baseline": 0.0,
                          "error": f"did not converge: err={err}"}), flush=True)
        return 1

    _phase("measure")
    k = 500

    def run():
        jax.block_until_ready(icp_fixed_iters(
            ref, tr1, n_iters=k, solver=solver, nn_method=nn_method))

    runs = sorted(wall_time(run, reps=3) / k for _ in range(3))
    per_iter = runs[0]
    median = runs[len(runs) // 2]
    spread_pct = 100.0 * (runs[-1] - runs[0]) / runs[0]
    value = 1.0 / per_iter
    dev = device_info()
    print(
        f"[bench] per-iter best={per_iter*1e6:.1f} us, "
        f"median={median*1e6:.1f} us, spread={spread_pct:.1f}% "
        f"(device={dev['kind']}, nn={nn_method}, solver={solver})",
        file=sys.stderr, flush=True,
    )
    _phase("done")
    if os.environ.get("ICP_BENCH_TEST_DROP_VERDICT"):
        return 0  # test hook: rc=0 with no JSON verdict (lost stdout)
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": round(value, 1),
                "unit": "iter/s",
                "vs_baseline": round(value / BASELINE_ITER_PER_S, 2),
                "iter_per_s_median": round(1.0 / median, 1),
                "per_iter_us_runs": [round(r * 1e6, 2) for r in runs],
                "spread_pct": round(spread_pct, 1),
                "roofline_share": "not measured",
                "nn_method": nn_method,
                "solver": solver,
                "device": dev,
                "xla_flags": os.environ.get("XLA_FLAGS", ""),
            }
        ),
        flush=True,
    )
    return 0


# --------------------------------------------------------------------------
# Parent: watchdog supervisor
# --------------------------------------------------------------------------

class _Attempt:
    def __init__(self) -> None:
        self.phase = "spawn"
        self.phase_t0 = time.time()
        self.stderr_tail: list[str] = []
        self.rc: int | None = None
        self.json_line: str | None = None
        self.failure: str | None = None

    def summary(self) -> dict:
        return {
            "phase": self.phase,
            "phase_elapsed_s": round(time.time() - self.phase_t0, 1),
            "rc": self.rc,
            "failure": self.failure,
            "stderr_tail": self.stderr_tail[-6:],
        }


def _drain_stderr(pipe, attempt: _Attempt) -> None:
    for raw in iter(pipe.readline, b""):
        line = raw.decode("utf-8", "replace").rstrip()
        if line.startswith(PHASE_MARK):
            attempt.phase = line[len(PHASE_MARK):].strip()
            attempt.phase_t0 = time.time()
        else:
            attempt.stderr_tail.append(line)
            if len(attempt.stderr_tail) > 50:
                del attempt.stderr_tail[:25]
        print(line, file=sys.stderr, flush=True)
    pipe.close()


def _run_attempt(deadline: float, phase_timeouts: dict[str, float]) -> _Attempt:
    import threading

    attempt = _Attempt()
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--measure"],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        start_new_session=True,  # own process group: killable without patterns
    )
    reader = threading.Thread(target=_drain_stderr, args=(child.stderr, attempt),
                              daemon=True)
    reader.start()
    try:
        while True:
            rc = child.poll()
            if rc is not None:
                attempt.rc = rc
                break
            now = time.time()
            budget = phase_timeouts.get(attempt.phase, 600.0)
            if now - attempt.phase_t0 > budget:
                attempt.failure = (
                    f"watchdog: phase '{attempt.phase}' exceeded {budget:.0f}s"
                )
                break
            if now > deadline:
                attempt.failure = "total benchmark budget exhausted"
                break
            time.sleep(1.0)
    finally:
        if attempt.failure is not None:
            try:  # kill the exact child process group (never by pattern)
                os.killpg(os.getpgid(child.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            child.wait()
            attempt.rc = child.returncode
    out = child.stdout.read().decode("utf-8", "replace")
    child.stdout.close()
    reader.join(timeout=5.0)
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("{"):
            attempt.json_line = line
    if attempt.failure is None and attempt.json_line is None:
        # Covers rc!=0 AND the pathological rc==0-with-no-verdict (stdout
        # lost) — the diagnostic JSON must always carry a non-null error.
        attempt.failure = f"child exited rc={attempt.rc} without a JSON verdict"
    return attempt


def supervise() -> int:
    t0 = time.time()
    deadline = t0 + _env_float("ICP_BENCH_TOTAL_TIMEOUT", 2700.0)
    attempts_max = int(_env_float("ICP_BENCH_ATTEMPTS", 2))
    backoff = _env_float("ICP_BENCH_BACKOFF", 20.0)
    phase_timeouts = {
        "spawn": 120.0,
        "init": _env_float("ICP_BENCH_INIT_TIMEOUT", 600.0),
        "gate": _env_float("ICP_BENCH_GATE_TIMEOUT", 1200.0),
        "measure": _env_float("ICP_BENCH_MEASURE_TIMEOUT", 1500.0),
        "done": 120.0,
    }

    history: list[dict] = []
    for i in range(attempts_max):
        print(f"[bench] attempt {i + 1}/{attempts_max}", file=sys.stderr, flush=True)
        attempt = _run_attempt(deadline, phase_timeouts)
        history.append(attempt.summary())
        if attempt.json_line is not None:
            # Child produced its verdict (success OR a structured gate
            # failure) — pass it through verbatim and mirror its rc.
            print(attempt.json_line, flush=True)
            return attempt.rc or 0
        print(f"[bench] attempt {i + 1} failed: {attempt.failure}",
              file=sys.stderr, flush=True)
        if time.time() + backoff > deadline:
            break
        if i + 1 < attempts_max:
            time.sleep(backoff)

    print(json.dumps({
        "metric": METRIC,
        "value": 0.0,
        "unit": "iter/s",
        "vs_baseline": 0.0,
        "error": history[-1]["failure"] if history else "no attempt ran",
        "diagnostic": {
            "elapsed_s": round(time.time() - t0, 1),
            "attempts": history,
        },
    }), flush=True)
    return 1


def main() -> int:
    if "--measure" in sys.argv:
        return measure()
    return supervise()


if __name__ == "__main__":
    sys.exit(main())
