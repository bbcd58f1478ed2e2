"""Pose-graph optimization and distributed bundle adjustment.

The back end of the multi-scan extension (BASELINE.json config 5): given
per-scan poses from the pairwise ICP chain (``slam.pairwise``) and relative
or point-level constraints, jointly optimize all poses.

Two solvers, both jitted end-to-end:

  * ``optimize_pose_graph`` — edge-based Gauss-Newton/Levenberg-Marquardt on
    SE(3) poses (quaternion + translation parametrization, gauge fixed at
    pose 0), optionally robust (Geman-McClure IRLS with graduated
    non-convexity, ``robust_phi=``).  Per-edge residuals/Jacobians are
    vmapped (an edge only touches its two poses — 14 local parameters) and
    the normal matrix is assembled by scatter-adding 7x7 blocks, so edge
    topology is DATA: one compiled program serves every graph with the
    same (n_poses, n_edges) shape, and compile time is O(1) in edge count.
    The dense (7P, 7P) solve runs replicated — fine to thousands of poses.
  * ``bundle_adjust`` / ``bundle_adjust_sharded`` — point-level joint
    refinement: residual per correspondence ``r_k = T_a x_k - T_b y_k``.
    The normal equations ``H = sum_k J_k^T J_k``, ``g = sum_k J_k^T r_k``
    are accumulated per point and, in the sharded variant, reduced with a
    single ``psum`` over the points mesh axis before a replicated dense
    solve — the Schur-complement-style collective reduction of
    SURVEY.md §5 (distributed comm backend).

No counterpart exists in the reference (single-pair registration only).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from icp_tpu.ops.alignment import Similarity, quat_to_rot


class PoseEdge(NamedTuple):
    """Relative-pose constraint: scan j expressed in scan i's frame."""

    i: int
    j: int
    R: jax.Array  # (3, 3) measured R_ij
    t: jax.Array  # (3,) measured t_ij
    weight: float = 1.0


def poses_to_params(poses: Sequence[Similarity]) -> jax.Array:
    """Pack [q(4), t(3)] per pose; rotation matrix -> quaternion."""
    rows = []
    for p in poses:
        R = np.asarray(p.R, np.float64)
        q = _rot_to_quat_np(R)
        rows.append(np.concatenate([q, np.asarray(p.t, np.float64)]))
    return jnp.asarray(np.stack(rows), jnp.float32)


def params_to_poses(theta: jax.Array) -> list[Similarity]:
    out = []
    for k in range(theta.shape[0]):
        q = theta[k, :4]
        q = q / jnp.linalg.norm(q)
        out.append(
            Similarity(
                s=jnp.asarray(1.0, theta.dtype),
                R=quat_to_rot(q),
                t=theta[k, 4:7],
            )
        )
    return out


def _rot_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Shepperd's method (numerically stable rotation -> quaternion)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _edge_r_and_J(theta_i, theta_j, R_meas, t_meas, weight):
    """Residual (12,) and Jacobian (12, 14) of ONE edge w.r.t. its two
    poses' stacked parameters [theta_i(7), theta_j(7)].

    An edge only touches poses i and j, so differentiating against the
    14 local parameters (instead of the full 7P flat vector, as jacfwd
    over a stacked residual list would) keeps the per-edge work O(1) in
    graph size; the (7P, 7P) normal matrix is then assembled by
    scatter-adding the four 7x7 blocks.
    """

    def r_fn(local):
        th_i, th_j = local[:7], local[7:]
        qi = th_i[:4] / jnp.linalg.norm(th_i[:4])
        qj = th_j[:4] / jnp.linalg.norm(th_j[:4])
        Ri, Rj = quat_to_rot(qi), quat_to_rot(qj)
        hi = jax.lax.Precision.HIGHEST
        r_rot = (jnp.matmul(Ri.T, Rj, precision=hi) - R_meas).reshape(-1)
        r_t = jnp.matmul(Ri.T, th_j[4:7] - th_i[4:7], precision=hi) - t_meas
        return weight * jnp.concatenate([r_rot, r_t])

    local = jnp.concatenate([theta_i, theta_j])
    return r_fn(local), jax.jacfwd(r_fn)(local)


@functools.partial(jax.jit, static_argnames=("n_iters", "robust"))
def _optimize_jit(
    theta0, edge_i, edge_j, edge_R, edge_t, edge_w, robust_phi, *,
    n_iters, robust
):
    n_poses = theta0.shape[0]
    dt = theta0.dtype
    n_params = 7 * n_poses

    def normal_terms(theta, phi):
        """H (7P, 7P), g (7P,), cost — assembled from per-edge blocks."""
        r, J = jax.vmap(_edge_r_and_J)(
            theta[edge_i], theta[edge_j], edge_R, edge_t, edge_w
        )  # (E, 12), (E, 12, 14)
        if robust and phi is not None:
            # Geman-McClure IRLS: each edge is reweighted by
            # w = (phi / (phi + chi2))^2, chi2 = |r|^2.  Inlier edges
            # (chi2 << phi) keep w = 1; an edge inconsistent with the rest
            # of the graph keeps a large chi2 as the inliers converge, so
            # its influence redescends as 1/chi2^2 — far below the bounded
            # floor of e.g. DCS scaling, which measurably leaves ~10x more
            # residual pose error here.  The weight is constant w.r.t. the
            # Jacobian (IRLS).  This is what lets redundant loop-closure
            # cycles overrule a garbage odometry edge instead of splitting
            # the error with it (tests/test_slam.py, tests/test_closure.py).
            chi2 = jnp.sum(r * r, axis=1)
            w_gm = (phi / (phi + chi2)) ** 2
            sw = jnp.sqrt(w_gm)
            r = sw[:, None] * r
            J = sw[:, None, None] * J
        He = jnp.einsum("eri,erj->eij", J, J, precision=jax.lax.Precision.HIGHEST)  # (E, 14, 14)
        ge = jnp.einsum("eri,er->ei", J, r, precision=jax.lax.Precision.HIGHEST)  # (E, 14)
        H4 = jnp.zeros((n_poses, 7, n_poses, 7), dt)
        H4 = H4.at[edge_i, :, edge_i, :].add(He[:, :7, :7])
        H4 = H4.at[edge_i, :, edge_j, :].add(He[:, :7, 7:])
        H4 = H4.at[edge_j, :, edge_i, :].add(He[:, 7:, :7])
        H4 = H4.at[edge_j, :, edge_j, :].add(He[:, 7:, 7:])
        g2 = jnp.zeros((n_poses, 7), dt)
        g2 = g2.at[edge_i].add(ge[:, :7]).at[edge_j].add(ge[:, 7:])
        cost = jnp.sum(r * r)
        # quaternion-norm soft constraints keep the parametrization healthy:
        # residual |q_p|^2 - 1 per pose, Jacobian 2q in the pose's own block
        q = theta[:, :4]
        qn = jnp.sum(q * q, axis=1) - 1.0  # (P,)
        Jq = jnp.pad(2.0 * q, ((0, 0), (0, 3)))  # (P, 7)
        H4 = H4.at[jnp.arange(n_poses), :, jnp.arange(n_poses), :].add(
            jnp.einsum("pi,pj->pij", Jq, Jq, precision=jax.lax.Precision.HIGHEST)
        )
        g2 = g2 + qn[:, None] * Jq
        cost = cost + jnp.sum(qn * qn)
        return H4.reshape(n_params, n_params), g2.reshape(-1), cost

    # Gauge fix: pose 0 is frozen via a large diagonal prior in the normal
    # equations.  (Masking the *step* after an unconstrained solve is wrong —
    # the remaining parameters would be solved as if pose 0 were free.)
    gauge = jnp.concatenate(
        [jnp.full((7,), 1e8, dt), jnp.full((n_params - 7,), 1e-6, dt)]
    )

    def gn_step(k, theta):
        # Graduated non-convexity: the kernel starts wide (phi_0 = 1e4 in
        # chi-square units makes DCS ~ plain least squares, whose global
        # pull escapes the odometry-consistent local minimum a bad init
        # sits in) and anneals geometrically to the target width over the
        # first ~2/3 of the iterations, by which point the inlier consensus
        # has separated from the outlier edges.  A FIXED phi from a bad
        # init rejects the (large-residual) loop closures instead of the
        # (zero-residual, init-defining) garbage edge — measured in
        # tests/test_slam.py::test_pose_graph_robust_rejects_outlier_edge.
        phi_0 = jnp.asarray(1e4, dt)
        n_anneal = jnp.maximum(1, (2 * n_iters) // 3)
        frac = jnp.minimum(1.0, k.astype(dt) / n_anneal.astype(dt))
        phi = phi_0 * (robust_phi / phi_0) ** frac if robust else None
        H, g, _ = normal_terms(theta, phi)
        delta = -jnp.linalg.solve(H + jnp.diag(gauge), g)
        return theta + delta.reshape(n_poses, 7)

    theta = jax.lax.fori_loop(0, n_iters, gn_step, theta0)
    _, _, cost = normal_terms(theta, robust_phi if robust else None)
    return theta, cost


def optimize_pose_graph(
    poses: Sequence[Similarity],
    edges: Sequence[PoseEdge],
    *,
    n_iters: int = 10,
    robust_phi: float | None = None,
) -> Tuple[list[Similarity], float]:
    """Gauss-Newton pose-graph solve; returns (optimized poses, final cost).

    ``robust_phi`` enables dynamic covariance scaling with that kernel width
    (chi-square units of the 12-d edge residual): edges whose residual stays
    inconsistent with the rest of the graph are automatically down-weighted.
    Use whenever the graph has redundancy (loop closures) and some edges may
    be wrong — e.g. an odometry pair that failed to register.  ``phi = 1.0``
    is a good default for unit-scale rotation residuals; ``None`` (default)
    is plain least squares.
    """
    theta0 = poses_to_params(poses)
    edge_i = jnp.asarray([e.i for e in edges], jnp.int32)
    edge_j = jnp.asarray([e.j for e in edges], jnp.int32)
    edge_R = jnp.stack([jnp.asarray(e.R, jnp.float32) for e in edges])
    edge_t = jnp.stack([jnp.asarray(e.t, jnp.float32) for e in edges])
    edge_w = jnp.asarray([e.weight for e in edges], jnp.float32)
    theta, cost = _optimize_jit(
        theta0,
        edge_i,
        edge_j,
        edge_R,
        edge_t,
        edge_w,
        jnp.asarray(1.0 if robust_phi is None else robust_phi, jnp.float32),
        n_iters=n_iters,
        robust=robust_phi is not None,
    )
    return params_to_poses(theta), float(cost)


# ---------------------------------------------------------------------------
# Point-level bundle adjustment (normal equations reduced over points)
# ---------------------------------------------------------------------------


def _point_residual(flat_theta, n_poses, a, b, x, y):
    """r = T_a x - T_b y for one correspondence (a, b may be traced)."""
    theta = flat_theta.reshape(n_poses, 7)
    qa = theta[a, :4]
    qa = qa / jnp.linalg.norm(qa)
    qb = theta[b, :4]
    qb = qb / jnp.linalg.norm(qb)
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(quat_to_rot(qa), x, precision=hi) + theta[a, 4:7]) - (
        jnp.matmul(quat_to_rot(qb), y, precision=hi) + theta[b, 4:7]
    )


def _ba_normal_terms(flat_theta, n_poses, a_ids, b_ids, xs, ys, w, axis):
    """Per-point Gauss-Newton terms, summed (locally, then psum'd if sharded):
    H = sum_k w_k J_k^T J_k,  g = sum_k w_k J_k^T r_k,  cost = sum w_k|r_k|^2.

    xs/ys: (N, 3) matched points in frames a_ids/b_ids (int32 per point);
    w: (N,) weights (0 masks out padding rows in the sharded variant).
    """
    res_fn = lambda th, a, b, x, y: _point_residual(th, n_poses, a, b, x, y)
    r = jax.vmap(res_fn, in_axes=(None, 0, 0, 0, 0))(
        flat_theta, a_ids, b_ids, xs, ys
    )  # (N, 3)
    J = jax.vmap(jax.jacfwd(res_fn, argnums=0), in_axes=(None, 0, 0, 0, 0))(
        flat_theta, a_ids, b_ids, xs, ys
    )  # (N, 3, P)
    H = jnp.einsum("n,nri,nrj->ij", w, J, J, precision=jax.lax.Precision.HIGHEST)
    g = jnp.einsum("n,nri,nr->i", w, J, r, precision=jax.lax.Precision.HIGHEST)
    cost = jnp.sum(w * jnp.sum(r * r, axis=1))
    if axis is not None:
        H = jax.lax.psum(H, axis)
        g = jax.lax.psum(g, axis)
        cost = jax.lax.psum(cost, axis)
    return H, g, cost


def _flatten_correspondences(correspondences, dtype):
    a_ids, b_ids, xs, ys = [], [], [], []
    for a, b, x, y in correspondences:
        assert x.shape == y.shape and x.shape[1] == 3
        n = x.shape[0]
        a_ids.append(np.full((n,), a, np.int32))
        b_ids.append(np.full((n,), b, np.int32))
        xs.append(np.asarray(x, dtype))
        ys.append(np.asarray(y, dtype))
    return (
        np.concatenate(a_ids),
        np.concatenate(b_ids),
        np.concatenate(xs),
        np.concatenate(ys),
    )


def _ba_solve(flat0, n_poses, ba_terms_fn, *, n_iters, damping):
    """Shared LM loop: ba_terms_fn(flat) -> (H, g, cost) summed over points."""
    n_params = flat0.shape[0]
    dt = flat0.dtype
    # Gauge: pose 0 frozen via a large diagonal prior (see _optimize_jit).
    gauge = jnp.concatenate(
        [jnp.full((7,), 1e8, dt), jnp.zeros((n_params - 7,), dt)]
    )

    def qreg(flat):
        """Quaternion-norm soft constraints (H', g' contributions)."""
        H = jnp.zeros((n_params, n_params), dt)
        g = jnp.zeros((n_params,), dt)
        theta = flat.reshape(n_poses, 7)
        for p in range(n_poses):
            fn = lambda f, p=p: jnp.sum(f.reshape(n_poses, 7)[p, :4] ** 2) - 1.0
            Jq = jax.grad(fn)(flat)
            H = H + jnp.outer(Jq, Jq)
            g = g + Jq * fn(flat)
        return H, g

    def step(_, flat):
        H, g, _ = ba_terms_fn(flat)
        Hq, gq = qreg(flat)
        H = H + Hq + damping * jnp.eye(n_params, dtype=dt) + jnp.diag(gauge)
        g = g + gq
        delta = -jnp.linalg.solve(H, g)
        return flat + delta

    flat = jax.lax.fori_loop(0, n_iters, step, flat0)
    _, _, cost = ba_terms_fn(flat)
    return flat, cost


def bundle_adjust(
    poses: Sequence[Similarity],
    correspondences: Sequence[Tuple[int, int, np.ndarray, np.ndarray]],
    *,
    n_iters: int = 8,
    damping: float = 1e-6,
) -> Tuple[list[Similarity], float]:
    """Joint point-level refinement (single device).

    ``correspondences``: (scan_a, scan_b, points_in_a, points_in_b) tuples;
    row k of points_in_a/points_in_b is one matched point expressed in the
    two scan frames.
    """
    n_poses = len(poses)
    flat0 = poses_to_params(poses).reshape(-1)
    dt = flat0.dtype
    a_ids, b_ids, xs, ys = _flatten_correspondences(correspondences, np.float32)
    a_d, b_d = jnp.asarray(a_ids), jnp.asarray(b_ids)
    xs_d, ys_d = jnp.asarray(xs, dt), jnp.asarray(ys, dt)
    w_d = jnp.ones((xs.shape[0],), dt)

    @functools.partial(jax.jit, static_argnames=("n_iters",))
    def run(flat0, a, b, x, y, w, *, n_iters):
        terms = lambda f: _ba_normal_terms(f, n_poses, a, b, x, y, w, None)
        return _ba_solve(flat0, n_poses, terms, n_iters=n_iters, damping=damping)

    flat, cost = run(flat0, a_d, b_d, xs_d, ys_d, w_d, n_iters=n_iters)
    return params_to_poses(flat.reshape(n_poses, 7)), float(cost)


def bundle_adjust_sharded(
    poses: Sequence[Similarity],
    correspondences: Sequence[Tuple[int, int, np.ndarray, np.ndarray]],
    *,
    mesh=None,
    n_iters: int = 8,
    damping: float = 1e-6,
) -> Tuple[list[Similarity], float]:
    """Distributed BA: correspondences sharded over the points mesh; normal
    equations psum-reduced each Gauss-Newton step, dense solve replicated."""
    from jax.sharding import NamedSharding, PartitionSpec

    from icp_tpu.parallel.mesh import make_mesh

    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]

    n_poses = len(poses)
    flat0 = poses_to_params(poses).reshape(-1)
    dt = flat0.dtype
    a_ids, b_ids, xs, ys = _flatten_correspondences(correspondences, np.float32)
    n = xs.shape[0]
    n_pad = -(-n // n_dev) * n_dev
    pad = n_pad - n
    a_ids = np.concatenate([a_ids, np.zeros((pad,), np.int32)])
    b_ids = np.concatenate([b_ids, np.zeros((pad,), np.int32)])
    xs = np.concatenate([xs, np.zeros((pad, 3), np.float32)])
    ys = np.concatenate([ys, np.zeros((pad, 3), np.float32)])
    w = np.concatenate([np.ones((n,), np.float32), np.zeros((pad,), np.float32)])

    row = NamedSharding(mesh, PartitionSpec(axis))
    row2 = NamedSharding(mesh, PartitionSpec(axis, None))
    rep = NamedSharding(mesh, PartitionSpec())
    args = (
        jax.device_put(flat0, rep),
        jax.device_put(a_ids, row),
        jax.device_put(b_ids, row),
        jax.device_put(xs.astype(np.float32), row2),
        jax.device_put(ys.astype(np.float32), row2),
        jax.device_put(w, row),
    )

    @functools.partial(jax.jit, static_argnames=("n_iters",))
    def run(flat0, a, b, x, y, w, *, n_iters):
        def local(flat0, a, b, x, y, w):
            terms = lambda f: _ba_normal_terms(f, n_poses, a, b, x, y, w, axis)
            return _ba_solve(
                flat0, n_poses, terms, n_iters=n_iters, damping=damping
            )

        return jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                PartitionSpec(),
                PartitionSpec(axis),
                PartitionSpec(axis),
                PartitionSpec(axis, None),
                PartitionSpec(axis, None),
                PartitionSpec(axis),
            ),
            out_specs=(PartitionSpec(), PartitionSpec()),
            check_vma=False,
        )(flat0, a, b, x, y, w)

    flat, cost = run(*args, n_iters=n_iters)
    return params_to_poses(np.asarray(flat).reshape(n_poses, 7)), float(cost)
