#!/usr/bin/env python
"""Weak-scaling sweep on a virtual CPU mesh (SURVEY §6 target).

Two columns per device count:

  * single-process: the fixed-model weak-scaling sweep
    (``icp_tpu/bench/scaling.py``) on a 1 -> 2 -> 4 -> 8 virtual-device CPU
    mesh.
  * 2-process (devices >= 2): the SAME cell split across two
    coordinator/worker processes (``parallel/mesh.py::init_distributed``,
    the ``tests/test_distributed.py`` machinery) — collectives cross a real
    process boundary the way DCN traffic would.

Cells run >=10 iterations with best-of-5 walls so the efficiency column
tracks the collective overhead, not host-load noise.

Usage:  python scripts/run_scaling.py [--points-per-device N]

The sweep measures an oversubscribed host (all virtual devices share the
same CPU socket), so the efficiency column says how the collectives scale,
not how a multi-GPU host would: the per-device compute does not shrink,
only collective overhead is added.  It prints one JSON line per cell.
"""

import json
import os
import socket
import subprocess
import sys

# Re-exec with the CPU-only environment before anything JAX-related loads:
# the virtual device count is read once, at backend start.
if os.environ.get("_ICP_SCALING_REEXEC") != "1":
    env = dict(os.environ)
    env["_ICP_SCALING_REEXEC"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    os.execve(sys.executable, [sys.executable] + sys.argv, env)

N_ITERS = 10
REPS = 5

_WORKER = r"""
import json, sys
pid, nproc, coord, d, ppd, n_iters, reps = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]))

from icp_tpu.parallel.mesh import init_distributed
init_distributed(coordinator_address=coord, num_processes=nproc,
                 process_id=pid)

import jax
assert len(jax.devices()) == d, jax.devices()

from icp_tpu.bench.scaling import run_cell
cell = run_cell(d, ppd, n_iters=n_iters, ring=True, model_points=16384,
                reps=reps)
if pid == 0:
    print("CELL " + json.dumps(cell), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cell_2proc(d: int, ppd: int, tmpdir: str) -> dict | None:
    """The d-device cell split across 2 coordinator/worker processes
    (d/2 virtual devices each).  Returns process 0's cell dict."""
    worker = os.path.join(tmpdir, "scaling_worker.py")
    with open(worker, "w") as f:
        f.write(_WORKER)
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={d // 2}",
    )
    env.pop("_ICP_SCALING_REEXEC", None)
    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", coord, str(d), str(ppd),
             str(N_ITERS), str(REPS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for i in range(2)
    ]
    outs = []
    failed = False
    for p in procs:
        try:
            out, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            print("[scaling] 2-process cell hung", file=sys.stderr)
            failed = True
            break
        if p.returncode != 0:
            print(f"[scaling] 2-process worker rc={p.returncode}: "
                  f"{err[-1500:]}", file=sys.stderr)
            failed = True
            break
        outs.append(out)
    if failed:
        # kill BOTH workers: a dead coordinator leaves its sibling blocked
        # in init_distributed, and an orphan would skew every later cell's
        # wall on this oversubscribed host
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
        return None
    for o in outs:
        for line in o.splitlines():
            if line.startswith("CELL "):
                cell = json.loads(line[5:])
                cell["processes"] = 2
                return cell
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ppd = 16384
    if "--points-per-device" in argv:
        i = argv.index("--points-per-device")
        ppd = int(argv[i + 1])

    from icp_tpu.bench.scaling import run_cell

    cells = []
    base = None
    tmpdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out", "scaling")
    os.makedirs(tmpdir, exist_ok=True)
    for d in (1, 2, 4, 8):
        cell = run_cell(d, ppd, n_iters=N_ITERS, ring=True,
                        model_points=16384, reps=REPS)
        cell["processes"] = 1
        if base is None:
            base = cell["wall_s"]
        cell["weak_scaling_efficiency"] = round(base / cell["wall_s"], 3)
        print(json.dumps(cell), flush=True)
        cells.append(cell)
        if d >= 2:
            c2 = run_cell_2proc(d, ppd, tmpdir)
            if c2 is not None:
                c2["weak_scaling_efficiency"] = round(base / c2["wall_s"], 3)
                c2["cross_process_overhead_pct"] = round(
                    100.0 * (c2["wall_s"] / cell["wall_s"] - 1.0), 1)
                print(json.dumps(c2), flush=True)
                cells.append(c2)

    return 0


if __name__ == "__main__":
    sys.exit(main())
