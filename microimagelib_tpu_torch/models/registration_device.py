"""The affMethod DOF-escalation ladder over Powell (the JAX package's
``models/registration_device.py``). On a CUDA pair on the kernel route the
whole ladder runs in K9 (``kernels/reg_ladder.py``: one launch per stage,
one sync), its evaluations on K5's body, or, with ``batch_ls``
(``MIL_REG_BATCH_LS=1``), its line searches 8 probes a pass on K6's. Its
plain version, :func:`reg_ladder_device_host`, drives
:func:`~microimagelib_tpu_torch.ops.powell_device.powell_device` from the
host over the device cost, one fused resample + NCC call (K5) and one sync
per evaluation, or one K6 call per 8 probes.

The ``hybrid`` engine keeps Powell's outer loop on the host
(``ops/powell.py``) and hands each whole line minimization to
:func:`linmin_reg_device`, the float32 mnbrak + brent of
``ops/powell_device.py`` over the same device cost: one K9 launch and one
sync a line on the kernel route, else the host loop.

The matrix builders are torch twins of ``ops/matrix.py`` on CPU float32
tensors: the Powell ladder evaluates them without a gradient, and the
gradient ladder (``registration_grad.py``) differentiates through them
with ``torch.autograd``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import reg_ladder as RL
from microimagelib_tpu_torch.ops.corr import (
    corr3d_auto,
    corr3d_partials_nprobe,
    resolve_ncc_impl,
)
from microimagelib_tpu_torch.ops.powell_device import _linmin, powell_device

_F32 = torch.float32
# ladders run as a host loop (reg_ladder_device_host), and line
# minimizations (linmin_reg_device)
HOST_LADDERS = 0
HOST_LINES = 0


# ---------------------------------------------------------------------------
# matrix builders (torch twins of ops/matrix.py, differentiable)
# ---------------------------------------------------------------------------

def _compose(m1, m2):
    a = m1.reshape(3, 4)
    b = m2.reshape(3, 4)
    rot = a[:, :3] @ b[:, :3]
    tr = a[:, :3] @ b[:, 3] + a[:, 3]
    return torch.cat([rot, tr[:, None]], dim=1).reshape(12)


def _mat(entries):
    """12-vector from a list of 0-d tensors and Python numbers."""
    return torch.stack([e if isinstance(e, torch.Tensor)
                        else torch.tensor(float(e), dtype=_F32)
                        for e in entries])


def _rz(alpha):
    c, s = torch.cos(alpha), torch.sin(alpha)
    return _mat([c, s, 0, 0, -s, c, 0, 0, 0, 0, 1, 0])


def _rx(beta):
    c, s = torch.cos(beta), torch.sin(beta)
    return _mat([1, 0, 0, 0, 0, c, s, 0, 0, -s, c, 0])


def _ry(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return _mat([c, 0, -s, 0, 0, 1, 0, 0, s, 0, c, 0])


def dof_to_matrix_t(dof9, dof_num: int):
    """Torch twin of ops.matrix.dof_to_matrix: (T*S) @ Rz @ Rx @ Ry with
    degrees/57.3 angles, on a float32 9-vector tensor."""
    x, y, z = dof9[0], dof9[1], dof9[2]
    zero = torch.zeros((), dtype=_F32)
    one = torch.ones((), dtype=_F32)
    if dof_num == 3:
        alpha = beta = theta = zero
        a = b = c = one
    elif dof_num == 6:
        alpha, beta, theta = dof9[3] / 57.3, dof9[4] / 57.3, dof9[5] / 57.3
        a = b = c = one
    elif dof_num == 7:
        alpha, beta, theta = dof9[3] / 57.3, dof9[4] / 57.3, dof9[5] / 57.3
        a = b = c = dof9[6]
    elif dof_num == 9:
        alpha, beta, theta = dof9[3] / 57.3, dof9[4] / 57.3, dof9[5] / 57.3
        a, b, c = dof9[6], dof9[7], dof9[8]
    else:
        raise ValueError(f"Unsupported dofNum {dof_num}")
    ts = _mat([a, 0, 0, x, 0, b, 0, y, 0, 0, c, z])
    m = _compose(ts, _rz(alpha))
    m = _compose(m, _rx(beta))
    return _compose(m, _ry(theta))


_P2M = [3, 4, 5, 0, 6, 7, 8, 1, 9, 10, 11, 2]
_M2P = [3, 7, 11, 0, 1, 2, 4, 5, 6, 8, 9, 10]


def params_to_matrix_t(p):
    return p[_P2M]


def matrix_to_params_t(m):
    return m[_M2P]


def _full_dof(sub, dof_num: int):
    """The 9-vector with ``sub`` in its first ``dof_num`` entries; the rest
    keep the identity's (0 for angles, 1 for scales)."""
    rest = torch.tensor([0.0] * 6 + [1.0] * 3, dtype=_F32)[dof_num:]
    return torch.cat([sub, rest])


def _to_t(v):
    return torch.as_tensor(np.asarray(v, np.float32))


# ---------------------------------------------------------------------------
# costs and the Powell ladder
# ---------------------------------------------------------------------------

def _ncc_cost(ss, st, sd_t):
    """-(st / sqrt(ss)) / sd_t as float32; 2.0 on zero energy."""
    ssf = math.sqrt(float(ss))
    if ssf == 0:
        return np.float32(2.0)
    return np.float32(-(float(st) / ssf) / float(sd_t))


def _make_cost(src_ms, tgt_ms, sd_t, ncc_impl=None):
    """NCC cost of a 12-vector matrix (numpy or tensor) against the
    preprocessed volumes, through the route ``ncc_impl`` (default: from
    ``src_ms``'s device, ``ops.corr.resolve_ncc_impl``)."""
    def cost_m(m12):
        ss, st = corr3d_auto(src_ms, tgt_ms, m12, impl=ncc_impl)
        return _ncc_cost(ss, st, sd_t)

    return cost_m


def _make_cost_batch(src_ms, tgt_ms, sd_t, ncc_impl=None):
    """(P, 12) matrices -> (P,) float32 costs through one
    ``corr3d_partials_nprobe`` call and one device sync: K6 on the kernel
    route, its plain version (one single cost per matrix) on ``gather``."""
    def fn(m12s):
        ss, st = corr3d_partials_nprobe(src_ms, tgt_ms, m12s, impl=ncc_impl)
        return np.array([_ncc_cost(a, b, sd_t) for a, b in zip(ss, st)],
                        np.float32)
    return fn


def _dof_cost(cost_m, dof_num):
    def fn(sub):
        with torch.no_grad():
            m = dof_to_matrix_t(_full_dof(_to_t(sub), dof_num), dof_num)
        return cost_m(m)
    return fn


def _p12_cost(cost_m):
    def fn(p):
        return cost_m(params_to_matrix_t(_to_t(p)))
    return fn


def _dof_cost_batch(cost_batch_m, dof_num):
    """(P, dof_num) sub-vectors -> (P,) costs through one batched call;
    None without a batched cost."""
    if cost_batch_m is None:
        return None

    def fn(subs):
        with torch.no_grad():
            mats = torch.stack([dof_to_matrix_t(_full_dof(_to_t(s), dof_num),
                                                dof_num) for s in subs])
        return cost_batch_m(mats)
    return fn


def _p12_cost_batch(cost_batch_m):
    if cost_batch_m is None:
        return None
    return lambda ps: cost_batch_m(_to_t(ps)[:, _P2M])


def _dof_to_p12(sub, dof_num):
    with torch.no_grad():
        m = dof_to_matrix_t(_full_dof(_to_t(sub), dof_num), dof_num)
        return matrix_to_params_t(m).numpy()


def _dof_matrix(sub, dof_num):
    with torch.no_grad():
        return dof_to_matrix_t(_full_dof(_to_t(sub), dof_num), dof_num).numpy()


def _p12_matrix(p):
    return params_to_matrix_t(_to_t(p)).numpy()


def on_kernel_route(src_ms, ncc_impl=None):
    """True where the ladder runs in K9: a CUDA pair whose cost takes the
    kernels (``ncc_impl``, else ``ops.corr.resolve_ncc_impl``)."""
    impl = ncc_impl if ncc_impl is not None else resolve_ncc_impl(src_ms)
    return impl == "pallas" and src_ms.is_cuda


def reg_ladder_device(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol,
                      it_limit, ncc_impl=None, batch_ls=False):
    """Run the affMethod 1-7 search. Inputs: the mean-subtracted source
    and target volumes (tensors on one device), the target SD, and the
    initial 12-param vector (identity unless affMethod 5 with an input
    matrix).

    Returns (aff_coef float32 12-vector, fret, stage costs (4,), total
    evaluations), as the JAX version does. A CUDA pair on the kernel route
    runs the whole ladder in K9 (``kernels/reg_ladder.py``: one launch per
    stage, one sync), with ``batch_ls`` its line searches on K6's body;
    everything else runs :func:`reg_ladder_device_host`."""
    if on_kernel_route(src_ms, ncc_impl):
        return RL.reg_ladder(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol, it_limit,
                             "device", batch_ls=batch_ls)
    return reg_ladder_device_host(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol,
                                  it_limit, ncc_impl, batch_ls)


def reg_ladder_device_host(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol,
                           it_limit, ncc_impl=None, batch_ls=False):
    """The Powell ladder as a host loop, one K5 call (or, with
    ``batch_ls``, one K6 call of 8 probes) and one sync per evaluation
    (K9's plain version). Counted in :data:`HOST_LADDERS`."""
    global HOST_LADDERS
    HOST_LADDERS += 1
    cost_m = _make_cost(src_ms, tgt_ms, sd_t, ncc_impl)
    cost_batch_m = (_make_cost_batch(src_ms, tgt_ms, sd_t, ncc_impl)
                    if batch_ls else None)
    cost12 = _p12_cost(cost_m)
    c12b = _p12_cost_batch(cost_batch_m)
    stage_costs = np.full(4, np.nan, np.float32)
    f32 = np.float32

    def dof_stage(dof_num, sub0, this_ftol, nev0=0):
        return powell_device(_dof_cost(cost_m, dof_num), sub0, this_ftol,
                             it_limit, nev0=nev0,
                             cost_batch=_dof_cost_batch(cost_batch_m, dof_num))

    if aff_method in (1, 2, 3, 4):
        dof_num = {1: 3, 2: 6, 3: 7, 4: 9}[aff_method]
        sub0 = np.zeros(dof_num, f32)
        if dof_num >= 7:
            sub0[6:dof_num] = 1.0
        sub, fret, nev = dof_stage(dof_num, sub0, ftol)
        aff = _dof_matrix(sub, dof_num)
        stage_costs[0] = fret
    elif aff_method == 5:
        p, fret, nev = powell_device(cost12, np.asarray(p_init12, f32), ftol,
                                     it_limit, cost_batch=c12b)
        aff = _p12_matrix(p)
        stage_costs[0] = fret
    elif aff_method == 6:
        sub, fret, nev = dof_stage(6, np.zeros(6, f32), 0.01)
        stage_costs[0] = fret
        p, fret, nev = powell_device(cost12, _dof_to_p12(sub, 6), ftol,
                                     it_limit, nev0=nev, cost_batch=c12b)
        aff = _p12_matrix(p)
        stage_costs[1] = fret
    elif aff_method == 7:
        sub3, fret, nev = dof_stage(3, np.zeros(3, f32), 0.01)
        stage_costs[0] = fret
        sub6, fret, nev = dof_stage(6, np.concatenate([sub3, np.zeros(3, f32)]),
                                    0.01, nev)
        stage_costs[1] = fret
        sub9, fret, nev = dof_stage(9, np.concatenate([sub6, np.ones(3, f32)]),
                                    0.005, nev)
        stage_costs[2] = fret
        p, fret, nev = powell_device(cost12, _dof_to_p12(sub9, 9), ftol,
                                     it_limit, nev0=nev, cost_batch=c12b)
        aff = _p12_matrix(p)
        stage_costs[3] = fret
    else:
        raise ValueError("Wrong affine registration method")
    return aff, fret, stage_costs, nev


# ---------------------------------------------------------------------------
# hybrid engine: the host Powell with the float32 line minimization
# ---------------------------------------------------------------------------

def _cost_for_mode(src_ms, tgt_ms, sd_t, mode, ncc_impl=None):
    """The cost of a 'p12' parameter vector or of the first N entries of a
    9-DOF vector ('dof3', 'dof6', 'dof7', 'dof9')."""
    cost_m = _make_cost(src_ms, tgt_ms, sd_t, ncc_impl)
    if mode == "p12":
        return _p12_cost(cost_m)
    return _dof_cost(cost_m, int(mode[3:]))


def linmin_reg_device(src_ms, tgt_ms, sd_t, p, xi, mode, ncc_impl=None):
    """One whole line minimization of the registration cost along ``xi``
    from ``p``, in float32 (the JAX package's one-program
    ``linmin_reg_device``): on a CUDA pair on the kernel route one K9
    launch and one sync (``kernels/reg_ladder.py::reg_line``), else the
    host loop, one K5 call per evaluation (counted in :data:`HOST_LINES`).
    Returns (p_new, xi_scaled, f_min, n_evals)."""
    global HOST_LINES
    if on_kernel_route(src_ms, ncc_impl):
        return RL.reg_line(src_ms, tgt_ms, sd_t, p, xi, mode)
    HOST_LINES += 1
    cost = _cost_for_mode(src_ms, tgt_ms, sd_t, mode, ncc_impl)
    return _linmin(cost, np.asarray(p, np.float32), np.asarray(xi, np.float32))


def cost_eval_reg_device(src_ms, tgt_ms, sd_t, p, mode, ncc_impl=None):
    """One cost evaluation (Powell's start point and extrapolation probe)
    as a float32 scalar."""
    return _cost_for_mode(src_ms, tgt_ms, sd_t, mode, ncc_impl)(
        np.asarray(p, np.float32))
