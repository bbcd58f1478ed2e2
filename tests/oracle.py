"""NumPy float64 oracle implementing the reference's exact numerics.

This is a *behavioral specification* of reference ``src/cpu.cc`` (brute-force
NN with sqrt distances and lowest-index ties; Horn similarity solve including
the q_bar/q_caps quaternion-to-rotation construction; QUIRK-1 double-counted
error) used to validate the JAX implementation.  Deliberately naive and
readable; layout is (N, 3) rows = points (the reference is 3xN columns).
"""

from __future__ import annotations

import numpy as np


def closest_matrix(p: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Reference CPU::closest_matrix (src/cpu.cc:5-27): per scene point, the
    model point at minimal euclidean distance; ties -> lowest model index."""
    out = np.zeros_like(p)
    for j in range(p.shape[0]):
        d = np.sqrt(np.sum((m - p[j]) ** 2, axis=1))
        out[j] = m[np.argmin(d)]  # np.argmin returns the first (lowest) index
    return out


def closest_indices(p: np.ndarray, m: np.ndarray) -> np.ndarray:
    d2 = np.sum((p[:, None, :] - m[None, :, :]) ** 2, axis=-1)
    return np.argmin(d2, axis=1)


def quat_to_rot_reference(q: np.ndarray) -> np.ndarray:
    """The reference's rotation construction (src/cpu.cc:138-152):
    R = (q_bar^H q_caps)[1:4, 1:4]."""
    q0, q1, q2, q3 = q
    q_bar = np.array(
        [
            [q0, -q1, -q2, -q3],
            [q1, q0, q3, -q2],
            [q2, -q3, q0, q1],
            [q3, q2, -q1, q0],
        ]
    )
    q_caps = np.array(
        [
            [q0, -q1, -q2, -q3],
            [q1, q0, -q3, q2],
            [q2, q3, q0, -q1],
            [q3, -q2, q1, q0],
        ]
    )
    temp = q_bar.conj().T @ q_caps
    return temp[1:4, 1:4]


def find_alignment(p: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Reference CPU::ICP::find_alignment (src/cpu.cc:105-175) with correct
    eigenvector selection (BUG-1 fixed: true argmax eigenvalue).

    Returns (s, R, t, err) with err = sum ||y - (s R p + t)||^2."""
    mu_p = p.mean(axis=0)
    mu_y = y.mean(axis=0)
    pc = p - mu_p
    yc = y - mu_y
    S = pc.T @ yc  # (3,3) = sum p'_i y'_i^T

    N = np.array(
        [
            [
                S[0, 0] + S[1, 1] + S[2, 2],
                S[1, 2] - S[2, 1],
                -S[0, 2] + S[2, 0],
                S[0, 1] - S[1, 0],
            ],
            [
                -S[2, 1] + S[1, 2],
                S[0, 0] - S[2, 2] - S[1, 1],
                S[0, 1] + S[1, 0],
                S[0, 2] + S[2, 0],
            ],
            [
                S[2, 0] - S[0, 2],
                S[1, 0] + S[0, 1],
                S[1, 1] - S[2, 2] - S[0, 0],
                S[1, 2] + S[2, 1],
            ],
            [
                -S[1, 0] + S[0, 1],
                S[2, 0] + S[0, 2],
                S[2, 1] + S[1, 2],
                S[2, 2] - S[1, 1] - S[0, 0],
            ],
        ]
    )
    w, v = np.linalg.eigh(N)
    q = v[:, -1]
    R = quat_to_rot_reference(q)

    d_caps = np.sum(yc * yc)
    sp = np.sum(pc * pc)
    s = np.sqrt(d_caps / sp) if with_scale else 1.0
    t = mu_y - s * R @ mu_p
    err = np.sum((y - (p @ (s * R).T + t)) ** 2)
    return s, R, t, err


def icp(model: np.ndarray, scene: np.ndarray, max_iter: int, threshold: float = 1e-5):
    """Reference CPU::ICP::find_corresponding (src/cpu.cc:55-79), including
    QUIRK-1's double-counted error.  Returns (new_p, errs list)."""
    new_p = scene.copy()
    errs = []
    for _ in range(max_iter):
        y = closest_matrix(new_p, model)
        s, R, t, err_align = find_alignment(new_p, y)
        new_p = new_p @ (s * R).T + t
        err_apply = np.sum((y - new_p) ** 2)
        err = (err_align + err_apply) / new_p.shape[0]
        errs.append(err)
        if err < threshold:
            break
    return new_p, errs
