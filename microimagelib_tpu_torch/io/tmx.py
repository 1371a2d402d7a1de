"""Transformation-matrix (.tmx) file format.

The reference's checkpoint format for registration: a whitespace-separated
text file of the 4x4 row-major affine matrix. Readers consume the first 12
floats (the 3x4 active part, reference:src/reg3D.cpp:286-299); writers emit
all 16 with a constant last row ``0 0 0 1``
(reference:src/reg3D.cpp:316-326).
"""

from __future__ import annotations

import os

import numpy as np


def read_tmx(path):
    """Read the leading 12 floats of a .tmx file as a (12,) float32 vector
    (rows of the 3x4 matrix acting on (x, y, z) coordinates)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"Input transformation matrix file does not exist: {path}")
    with open(path, "r") as f:
        vals = f.read().split()
    if len(vals) < 12:
        raise ValueError(f"Matrix file has fewer than 12 values: {path}")
    return np.array([float(v) for v in vals[:12]], dtype=np.float32)


def write_tmx(path, tmx):
    """Write a 12-vector (or 3x4/4x4 matrix) as the reference's 4x4 text
    format: tab-separated, 4 values per line, last row 0 0 0 1."""
    m = np.asarray(tmx, dtype=np.float64).reshape(-1)[:12]
    with open(path, "w") as f:
        for r in range(3):
            f.write("\t".join(f"{m[r * 4 + c]:f}" for c in range(4)) + "\t\n")
        f.write(f"{0.0:f}\t{0.0:f}\t{0.0:f}\t{1.0:f}\n")
