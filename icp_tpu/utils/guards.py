"""Instrumented failure detection (SURVEY.md §5 race/failure subsystems).

The reference has no sanitizers or failure detection: CUDA return codes go
unchecked and the few guarded errors ``exit()`` the process (SURVEY.md §5,
reference ``src/load.cc:13``, ``src/cpu.cc:46-51``).  JAX is functional so
data races cannot occur; the equivalents here are

  * ``icp(guard="device")`` — a status word carried through the jitted
    while_loop aborts on non-finite/diverging error (``engine/icp.py``);
  * ``checked_icp_step`` (here) — a ``jax.experimental.checkify`` run of one
    ICP step with float checks (NaN/Inf) and index OOB checks enabled, which
    *locates* the first failing primitive.  ~10x slower than the raw step;
    a debugging tool, not a production path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked_icp_step(
    scene,
    model,
    *,
    solver: str = "eigh",
    nn_method: str = "bcast",
    with_scale: bool = True,
):
    """Run ONE ICP iteration under ``checkify`` float+index checks.

    Returns ``(err_msg_or_None, (p_new, sim, err))``.  On a poisoned input
    the message names the first primitive that produced a NaN/Inf or an
    out-of-bounds index, with a traceback location — use it to localize
    failures that ``guard="device"`` only detects.
    """
    from icp_tpu.engine.icp import icp_step

    def step(p, m):
        return icp_step(
            p, m, solver=solver, nn_method=nn_method, with_scale=with_scale,
            reference_compat=True, scene_tile=16, model_tile=64,
        )

    checked = checkify.checkify(
        step, errors=checkify.float_checks | checkify.index_checks
    )
    err, out = jax.jit(checked)(
        jnp.asarray(scene), jnp.asarray(model)
    )
    msg = err.get()
    return (msg if msg else None), out
