#!/usr/bin/env python
"""Full Stanford-bunny 5-view registration chain on the current backend.

BASELINE.json config 3: sequential pairwise registration over
bun000/045/180/270/315 (unequal point counts; real noise).  Writes the
registered clouds + poses and prints a JSON summary line per pair.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from icp_tpu.config import ICPConfig
from icp_tpu.io.csv import load_matrix
from icp_tpu.slam.pairwise import chain_to_world_poses, register_chain

VIEWS = ["bun000", "bun045", "bun180", "bun270", "bun315"]


def main():
    data = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
    sub = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    clouds = [load_matrix(os.path.join(data, v + ".txt"))[::sub] for v in VIEWS]
    backend = jax.default_backend()
    cfg = ICPConfig(
        max_iter=60,
        dtype=jnp.float32,
        solver="auto",
        nn_method="auto",
        with_scale=False,  # real scans: rigid
        validate_inputs=False,
    )
    t0 = time.time()
    pairs = register_chain(clouds, cfg)
    for k, pr in enumerate(pairs):
        print(json.dumps(dict(pair=f"{VIEWS[k]}->{VIEWS[k+1]}", iters=pr.iters,
                              err=pr.err)))
    poses = chain_to_world_poses(pairs)
    print(json.dumps(dict(total_wall_s=round(time.time() - t0, 1),
                          n_views=len(VIEWS), backend=backend,
                          subsample=sub)))
    np.savez(
        "bunny_poses.npz",
        s=np.stack([np.asarray(p.s) for p in poses]),
        R=np.stack([np.asarray(p.R) for p in poses]),
        t=np.stack([np.asarray(p.t) for p in poses]),
    )


if __name__ == "__main__":
    main()
