"""Multi-process ``jax.distributed`` bring-up test (VERDICT r2 weak #6).

``parallel/mesh.py::init_distributed`` is the multi-host entry and cannot be
exercised in-process: it spins up the coordinator service and global device
registry.  This test spawns 2 coordinator+worker subprocesses with 4 virtual
CPU devices each (the jax.distributed simulation SURVEY.md §4 prescribes for
multi-host logic), forms the 8-device global ``points`` mesh across the
process boundary, runs ``icp_sharded`` over it — collectives crossing
processes the way DCN traffic would — and pins the result against the
single-process 8-device run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import sys
import numpy as np

pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from icp_tpu.parallel.mesh import init_distributed

init_distributed(coordinator_address=coord, num_processes=nproc,
                 process_id=pid)

import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from icp_tpu import ICPConfig
from icp_tpu.io.csv import load_matrix
from icp_tpu.parallel.mesh import make_mesh
from icp_tpu.parallel.sharded import icp_sharded

assert len(jax.devices()) == nproc * 4, jax.devices()
assert len(jax.local_devices()) == 4

ref = load_matrix("/root/repo/data/cow_ref.txt")[::20]
tr1 = load_matrix("/root/repo/data/cow_tr1.txt")[::20]
cfg = ICPConfig(max_iter=20, dtype=jnp.float64, solver="eigh",
                nn_method="bcast")
res = icp_sharded(ref, tr1, cfg, mesh=make_mesh())
print(f"RESULT pid={pid} iters={int(res.iters)} err={float(res.err):.17e}",
      flush=True)
"""


_WORKER_ENGINES = r"""
import sys
import numpy as np

pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from icp_tpu.parallel.mesh import init_distributed

init_distributed(coordinator_address=coord, num_processes=nproc,
                 process_id=pid)

import jax
import jax.numpy as jnp

from icp_tpu import ICPConfig
from icp_tpu.engine.symmetric import icp_symmetric_sharded
from icp_tpu.io.csv import load_matrix
from icp_tpu.ops.normals import estimate_normals
from icp_tpu.parallel.mesh import make_mesh
from icp_tpu.parallel.sharded import icp_sharded

ref = np.asarray(load_matrix("/root/repo/data/cow_ref.txt"), np.float32)[::20]
tr1 = np.asarray(load_matrix("/root/repo/data/cow_tr1.txt"), np.float32)[::20]
mesh = make_mesh()

# kd-grid sharded engine across the process boundary (work-list kernels in
# interpret mode inside shard_map; grid arrays ride the ppermute ring)
cfg_g = ICPConfig(max_iter=20, dtype=jnp.float32, nn_method="grid",
                  grid_model_tile=64, grid_scene_tile=16)
g = icp_sharded(ref, tr1, cfg_g, mesh=mesh)
print(f"GRID pid={pid} iters={int(g.iters)} err={float(g.err):.9e}",
      flush=True)

# symmetric sharded engine: scene normals sharded WITH the scene rows,
# model normals riding the ring as payload, psum'd 6x6 GN
nm = estimate_normals(jnp.asarray(ref), k=8)
ns = estimate_normals(jnp.asarray(tr1), k=8)
cfg_s = ICPConfig(max_iter=20, dtype=jnp.float32, nn_method="bcast",
                  threshold=1e-9)
s = icp_symmetric_sharded(ref, tr1, cfg_s, normals=nm, scene_normals=ns,
                          mesh=mesh)
print(f"SYM pid={pid} iters={int(s.iters)} err={float(s.err):.9e}",
      flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_init_distributed_two_process_mesh(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", coord],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=tmp_path,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker hung")
        assert p.returncode == 0, err[-2000:]
        outs.append(out)

    results = [l for o in outs for l in o.splitlines() if l.startswith("RESULT")]
    assert len(results) == 2
    # both processes must report the identical replicated result
    assert results[0].split("iters=", 1)[1] == results[1].split("iters=", 1)[1]

    # and it must match the single-process 8-device run of the same program
    import jax
    import jax.numpy as jnp

    from icp_tpu import ICPConfig
    from icp_tpu.io.csv import load_matrix
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import icp_sharded

    ref = load_matrix("/root/repo/data/cow_ref.txt")[::20]
    tr1 = load_matrix("/root/repo/data/cow_tr1.txt")[::20]
    cfg = ICPConfig(max_iter=20, dtype=jnp.float64, solver="eigh",
                    nn_method="bcast")
    single = icp_sharded(ref, tr1, cfg, mesh=make_mesh(jax.devices()[:8]))
    iters = int(results[0].split("iters=")[1].split()[0])
    err = float(results[0].split("err=")[1])
    assert iters == int(single.iters)
    np.testing.assert_allclose(err, float(single.err), rtol=1e-9)


@pytest.mark.slow
def test_two_process_grid_and_symmetric_engines(tmp_path):
    """The round-4 engine family across a REAL process boundary: kd-grid
    sharded ICP and sharded symmetric GN over a 2-process 8-device mesh,
    pinned against the single-process runs of the same programs."""
    worker = tmp_path / "worker_engines.py"
    worker.write_text(_WORKER_ENGINES)
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
    )
    coord = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", coord],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=tmp_path,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed engine worker hung")
        assert p.returncode == 0, err[-2000:]
        outs.append(out)

    def grab(tag):
        lines = [l for o in outs for l in o.splitlines() if l.startswith(tag)]
        assert len(lines) == 2, outs
        # both processes report the identical replicated result
        a, b = (l.split("iters=", 1)[1] for l in lines)
        assert a == b
        return (int(lines[0].split("iters=")[1].split()[0]),
                float(lines[0].split("err=")[1]))

    import jax
    import jax.numpy as jnp

    from icp_tpu import ICPConfig
    from icp_tpu.engine.symmetric import icp_symmetric_sharded
    from icp_tpu.io.csv import load_matrix
    from icp_tpu.ops.normals import estimate_normals
    from icp_tpu.parallel.mesh import make_mesh
    from icp_tpu.parallel.sharded import icp_sharded

    ref = np.asarray(load_matrix("/root/repo/data/cow_ref.txt"),
                     np.float32)[::20]
    tr1 = np.asarray(load_matrix("/root/repo/data/cow_tr1.txt"),
                     np.float32)[::20]
    mesh = make_mesh(jax.devices()[:8])

    it_g, err_g = grab("GRID")
    cfg_g = ICPConfig(max_iter=20, dtype=jnp.float32, nn_method="grid",
                      grid_model_tile=64, grid_scene_tile=16)
    sg = icp_sharded(ref, tr1, cfg_g, mesh=mesh)
    assert it_g == int(sg.iters)
    # both runs sit at the f32 convergence floor (~6e-12); cross-process
    # psum order shifts the last bits, so compare at floor scale
    np.testing.assert_allclose(err_g, float(sg.err), rtol=0.2, atol=1e-10)

    it_s, err_s = grab("SYM")
    nm = estimate_normals(jnp.asarray(ref), k=8)
    ns = estimate_normals(jnp.asarray(tr1), k=8)
    cfg_s = ICPConfig(max_iter=20, dtype=jnp.float32, nn_method="bcast",
                      threshold=1e-9)
    ss = icp_symmetric_sharded(ref, tr1, cfg_s, normals=nm, scene_normals=ns,
                               mesh=mesh)
    assert it_s == int(ss.iters)
    np.testing.assert_allclose(err_s, float(ss.err), rtol=0.2, atol=1e-10)
