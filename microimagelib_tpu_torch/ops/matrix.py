"""Affine-matrix algebra for 3D registration and resampling (host-side
NumPy: these are 3x4 matrices, never worth a device trip). A copy of the
JAX package's ``ops/matrix.py``; the two must stay equal (a test checks).

Matrix convention (the reference's, kept for .tmx compatibility): a
12-vector / 3x4 row-major matrix whose rows produce source-coordinate
(x, y, z) from output-voxel coordinate (x, y, z):

    tx = m[0]*x + m[1]*y + m[2]*z  + m[3]
    ty = m[4]*x + m[5]*y + m[6]*z  + m[7]
    tz = m[8]*x + m[9]*y + m[10]*z + m[11]

(reference:include/cukernel.cuh:510-512).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["identity_tmx", "scale_tmx", "compose_affine", "params_to_matrix",
           "matrix_to_params", "dof_to_matrix", "rot_to_matrix"]


def identity_tmx():
    m = np.zeros(12, dtype=np.float32)
    m[0] = m[5] = m[10] = 1.0
    return m


def scale_tmx(sx_ratio, sy_ratio, sz_ratio):
    """Pure-scaling matrix, as built by ``imresize3d``
    (reference:src/apifunc.cpp:429-446): diag(out_size/in_size)."""
    m = np.zeros(12, dtype=np.float32)
    m[0], m[5], m[10] = sx_ratio, sy_ratio, sz_ratio
    return m


def compose_affine(m1, m2):
    """3x4 homogeneous composition m = m1 @ m2 (``matrixmultiply``,
    reference:src/api_subfunc.cu:584-623)."""
    a = np.asarray(m1, dtype=np.float64).reshape(3, 4)
    b = np.asarray(m2, dtype=np.float64).reshape(3, 4)
    out = np.empty((3, 4), dtype=np.float64)
    out[:, :3] = a[:, :3] @ b[:, :3]
    out[:, 3] = a[:, :3] @ b[:, 3] + a[:, 3]
    return out.reshape(12).astype(np.float32)


def params_to_matrix(p):
    """12 Powell parameters -> matrix (``p2matrix``,
    reference:src/api_subfunc.cu:557-568). Layout: p = [tx, ty, tz,
    a00, a01, a02, a10, a11, a12, a20, a21, a22]."""
    p = np.asarray(p, dtype=np.float64)
    m = np.empty(12, dtype=np.float64)
    m[0], m[1], m[2], m[3] = p[3], p[4], p[5], p[0]
    m[4], m[5], m[6], m[7] = p[6], p[7], p[8], p[1]
    m[8], m[9], m[10], m[11] = p[9], p[10], p[11], p[2]
    return m.astype(np.float32)


def matrix_to_params(m):
    """matrix -> 12 Powell parameters (``matrix2p``,
    reference:src/api_subfunc.cu:569-581)."""
    m = np.asarray(m, dtype=np.float64).reshape(12)
    p = np.empty(12, dtype=np.float64)
    p[0], p[1], p[2] = m[3], m[7], m[11]
    p[3], p[4], p[5] = m[0], m[1], m[2]
    p[6], p[7], p[8] = m[4], m[5], m[6]
    p[9], p[10], p[11] = m[8], m[9], m[10]
    return p.astype(np.float32)


def _rz(alpha):
    return np.array(
        [[math.cos(alpha), math.sin(alpha), 0, 0],
         [-math.sin(alpha), math.cos(alpha), 0, 0],
         [0, 0, 1, 0]], dtype=np.float64)


def _rx(beta):
    return np.array(
        [[1, 0, 0, 0],
         [0, math.cos(beta), math.sin(beta), 0],
         [0, -math.sin(beta), math.cos(beta), 0]], dtype=np.float64)


def _ry(theta):
    return np.array(
        [[math.cos(theta), 0, -math.sin(theta), 0],
         [0, 1, 0, 0],
         [math.sin(theta), 0, math.cos(theta), 0]], dtype=np.float64)


def dof_to_matrix(dof, dof_num):
    """DOF parameters -> matrix (``dof9tomatrix``,
    reference:src/api_subfunc.cu:715-824).

    ``dof`` is a 9-vector [x, y, z, alpha, beta, theta, a, b, c]. Angles
    are in degrees and divided by 57.3 exactly as the reference does.
    Composition order: (T*S) @ Rz(alpha) @ Rx(beta) @ Ry(theta), where T*S
    is a single matrix with diag scales and translation column."""
    dof = np.asarray(dof, dtype=np.float64)
    x, y, z = dof[0], dof[1], dof[2]
    if dof_num == 3:
        alpha = beta = theta = 0.0
        a = b = c = 1.0
    elif dof_num == 6:
        alpha, beta, theta = dof[3] / 57.3, dof[4] / 57.3, dof[5] / 57.3
        a = b = c = 1.0
    elif dof_num == 7:
        alpha, beta, theta = dof[3] / 57.3, dof[4] / 57.3, dof[5] / 57.3
        a = b = c = dof[6]
    elif dof_num == 9:
        alpha, beta, theta = dof[3] / 57.3, dof[4] / 57.3, dof[5] / 57.3
        a, b, c = dof[6], dof[7], dof[8]
    else:
        raise ValueError(f"Unsupported dofNum {dof_num}")
    ts = np.array(
        [[a, 0, 0, x],
         [0, b, 0, y],
         [0, 0, c, z]], dtype=np.float64)
    m = compose_affine(ts.reshape(12), _rz(alpha).reshape(12))
    m = compose_affine(m, _rx(beta).reshape(12))
    m = compose_affine(m, _ry(theta).reshape(12))
    return np.asarray(m, dtype=np.float32)


def rot_to_matrix(theta, sx, sy, sz, rot_axis):
    """Rotation about a coordinate axis with re-centering into the rotated
    bounding grid (``rot2matrix``, reference:src/api_subfunc.cu:626-713).

    Maps output-grid coordinates (size: rotated grid) to source coordinates
    (sx, sy, sz). Integer half-sizes use C integer division exactly as the
    reference does."""
    sx, sy, sz = int(sx), int(sy), int(sz)
    if rot_axis == 1:  # about X
        s_new = int(round(math.sqrt(sy * sy + sz * sz)))
        t1 = np.array([[1, 0, 0, 0], [0, 1, 0, sy // 2], [0, 0, 1, sz // 2]], dtype=np.float64)
        r = _rx(theta)
        t3 = np.array([[1, 0, 0, 0], [0, 1, 0, -(s_new // 2)], [0, 0, 1, -(s_new // 2)]], dtype=np.float64)
    elif rot_axis == 2:  # about Y
        s_new = int(round(math.sqrt(sx * sx + sz * sz)))
        t1 = np.array([[1, 0, 0, sx // 2], [0, 1, 0, 0], [0, 0, 1, sz // 2]], dtype=np.float64)
        r = _ry(theta)
        t3 = np.array([[1, 0, 0, -(s_new // 2)], [0, 1, 0, 0], [0, 0, 1, -(s_new // 2)]], dtype=np.float64)
    elif rot_axis == 3:  # about Z
        s_new = int(round(math.sqrt(sx * sx + sy * sy)))
        t1 = np.array([[1, 0, 0, sx // 2], [0, 1, 0, sy // 2], [0, 0, 1, 0]], dtype=np.float64)
        r = _rz(theta)
        t3 = np.array([[1, 0, 0, -(s_new // 2)], [0, 1, 0, -(s_new // 2)], [0, 0, 1, 0]], dtype=np.float64)
    else:
        raise ValueError(f"Invalid rotation axis {rot_axis}")
    m = compose_affine(t1.reshape(12), r.reshape(12))
    return compose_affine(m, t3.reshape(12))
