"""Gradient registration engine: the affMethod DOF ladder driven by L-BFGS
over the analytic NCC gradient (the JAX package's
``models/registration_grad.py``).

The reference is locked into derivative-free Powell because its cost is
sampled through texture units (reference:src/api_powell.c:119-360,
reference:include/cukernel.cuh:526-556). The fused resample + NCC is
differentiable here: K4 (``ops/corr.py``) computes the sums and their
gradient in the matrix in one pass, so the same local optimum is reached
in far fewer evaluations. Ladder staging (3 -> 6 -> 9 -> 12 DOF with the
reference's per-stage ftols), the shared ``it_limit`` cap and the
cost >= 1.001 abort are kept.
"""

from __future__ import annotations

import numpy as np
import torch

from microimagelib_tpu_torch.kernels import reg_ladder as RL
from microimagelib_tpu_torch.models.registration_device import (
    _dof_cost,
    _dof_cost_batch,
    _dof_matrix,
    _dof_to_p12,
    _full_dof,
    _make_cost,
    _make_cost_batch,
    _p12_cost,
    _p12_cost_batch,
    _p12_matrix,
    _to_t,
    dof_to_matrix_t,
    on_kernel_route,
    params_to_matrix_t,
    reg_ladder_device_host,
)
from microimagelib_tpu_torch.ops.corr import NCCPartials
from microimagelib_tpu_torch.ops.lbfgs import lbfgs_minimize
from microimagelib_tpu_torch.ops.powell_device import powell_device


# ladders run as a host loop (reg_ladder_grad_host)
HOST_LADDERS = 0

def _make_cost_grad_m(src_ms, tgt_ms, sd_t, ncc_impl):
    """m12 (CPU float32 tensor) -> (cost, dcost/dm12) with
    cost = -(st / sqrt(ss)) / sd_t, differentiated by autograd through
    :class:`~microimagelib_tpu_torch.ops.corr.NCCPartials` (one K4 launch);
    cost 2 and a zero gradient on zero energy."""
    def cost_grad(m12):
        m = m12.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            ss, st = NCCPartials.apply(m, src_ms, tgt_ms, ncc_impl)
            if float(ss.detach()) == 0.0:
                return np.float32(2.0), torch.zeros(12, dtype=torch.float32)
            cost = -(st / torch.sqrt(ss)) / float(sd_t)
            grad, = torch.autograd.grad(cost, m)
        return np.float32(cost.item()), grad

    return cost_grad


def _stage_vg(cost_grad_m, to_matrix, scale):
    """Value and gradient of a stage's parameters through the
    (differentiable) param -> matrix map, searched in the preconditioned
    space q = p / scale: a unit move in any q component displaces voxels by
    about one voxel (linear matrix entries act through ~extent/2, so raw
    parameters are ~E/2 times stiffer than translations)."""
    scale_t = _to_t(scale)

    def vg(q):
        p = (_to_t(q) * scale_t).requires_grad_(True)
        with torch.enable_grad():
            m = to_matrix(p)
        c, gm = cost_grad_m(m.detach())
        # the pullback of gm as the gradient of the scalar m . gm (a tensor
        # grad_outputs makes torch.autograd.grad import sympy, seconds cold)
        with torch.enable_grad():
            gp, = torch.autograd.grad((m * gm).sum(), p)
        return c, (gp * scale_t).numpy()

    return vg


def reg_ladder_grad(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol,
                    it_limit, ncc_impl=None, finish=True, batch_ls=False,
                    finish_sweeps=None, ls_max_iters=None, ls_patience=None):
    """Gradient twin of ``registration_device.reg_ladder_device``: same
    stages, same return contract (aff 12-vector, fret, stage costs (4,),
    total evaluations).

    A CUDA pair on the kernel route (``ops.corr.resolve_ncc_impl``) runs
    the whole ladder in K9 (``kernels/reg_ladder.py``: one launch per
    stage, one sync), with ``batch_ls`` the finisher's line searches on
    K6's body; everything else runs :func:`reg_ladder_grad_host`.
    Arguments as there."""
    if on_kernel_route(src_ms, ncc_impl):
        return RL.reg_ladder(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol, it_limit,
                             "grad", finish, finish_sweeps, ls_max_iters, ls_patience,
                             batch_ls)
    return reg_ladder_grad_host(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol, it_limit,
                                ncc_impl, finish, batch_ls, finish_sweeps, ls_max_iters,
                                ls_patience)


def reg_ladder_host(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol, it_limit,
                    engine="grad", finish=True, finish_sweeps=None, ls_max_iters=None,
                    ls_patience=None, ncc_impl=None, batch_ls=False):
    """K9's plain version in K9's argument order
    (``kernels/reg_ladder.py::reg_ladder``): the host loop of ``engine``,
    :func:`reg_ladder_grad_host` ('grad') or
    ``registration_device.reg_ladder_device_host`` ('device'), whatever
    the pair's device."""
    if engine == "grad":
        return reg_ladder_grad_host(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol,
                                    it_limit, ncc_impl, finish, batch_ls, finish_sweeps,
                                    ls_max_iters, ls_patience)
    if engine == "device":
        return reg_ladder_device_host(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol,
                                      it_limit, ncc_impl, batch_ls)
    raise ValueError(f"unknown ladder engine {engine!r}")


def reg_ladder_grad_host(src_ms, tgt_ms, sd_t, p_init12, aff_method, ftol,
                         it_limit, ncc_impl=None, finish=True, batch_ls=False,
                         finish_sweeps=None, ls_max_iters=None, ls_patience=None):
    """The gradient ladder as a host loop, one K4/K5 call and one sync per
    evaluation (K9's plain version).

    ``finish``: end with a Powell direction-set pass from the L-BFGS point
    (full reference semantics); ``finish_sweeps`` caps it at N sweeps (None
    = run to Powell's ftol). ``ls_max_iters``/``ls_patience``: the
    per-stage L-BFGS step cap and ftol-stall patience (None: the MIL_LBFGS_*
    env knobs). ``batch_ls``: the finisher's line minimizations probe 8
    points per batched cost call (one K6 launch and one sync on the kernel
    route) instead of serial mnbrak/brent. Counted in :data:`HOST_LADDERS`."""
    global HOST_LADDERS
    HOST_LADDERS += 1
    cost_grad_m = _make_cost_grad_m(src_ms, tgt_ms, sd_t, ncc_impl)
    cost_m = _make_cost(src_ms, tgt_ms, sd_t, ncc_impl)
    cost_batch_m = (_make_cost_batch(src_ms, tgt_ms, sd_t, ncc_impl)
                    if (finish and batch_ls) else None)
    cost12 = _p12_cost(cost_m)
    c12b = _p12_cost_batch(cost_batch_m)
    f32 = np.float32

    def lbfgs(vg, q0, this_ftol, nev0=0):
        return lbfgs_minimize(vg, q0, this_ftol, it_limit, nev0=nev0,
                              max_iters=ls_max_iters, patience=ls_patience)

    def finisher(cost, p, nev, cost_batch):
        return powell_device(cost, p, ftol, it_limit, nev0=nev,
                             cost_batch=cost_batch, max_sweeps=finish_sweeps)

    # preconditioning scales: translations/degrees ~1 voxel per unit; scale
    # factors and raw linear entries act through ~extent/2
    ext = float(sum(src_ms.shape)) / 3.0
    s_lin = f32(2.0 / ext)

    def dof_scale(dof_num):
        s = np.ones(dof_num, f32)
        if dof_num >= 7:
            s[6:dof_num] = s_lin
        return s

    p12_scale = np.concatenate([np.ones(3, f32), np.full(9, s_lin, f32)])

    def dof_vg(dof_num):
        return _stage_vg(cost_grad_m,
                         lambda sub: dof_to_matrix_t(_full_dof(sub, dof_num),
                                                     dof_num),
                         dof_scale(dof_num))

    p12_vg = _stage_vg(cost_grad_m, params_to_matrix_t, p12_scale)
    stage_costs = np.full(4, np.nan, f32)

    if aff_method in (1, 2, 3, 4):
        dof_num = {1: 3, 2: 6, 3: 7, 4: 9}[aff_method]
        sub0 = np.zeros(dof_num, f32)
        if dof_num >= 7:
            sub0[6:dof_num] = 1.0
        sc = dof_scale(dof_num)
        q, fret, nev = lbfgs(dof_vg(dof_num), sub0 / sc, ftol)
        sub = q * sc
        if finish:
            sub, fret, nev = finisher(_dof_cost(cost_m, dof_num), sub, nev,
                                      _dof_cost_batch(cost_batch_m, dof_num))
        aff = _dof_matrix(sub, dof_num)
        stage_costs[0] = fret
    elif aff_method == 5:
        q, fret, nev = lbfgs(p12_vg, np.asarray(p_init12, f32) / p12_scale,
                             ftol)
        p = q * p12_scale
        if finish:
            p, fret, nev = finisher(cost12, p, nev, c12b)
        aff = _p12_matrix(p)
        stage_costs[0] = fret
    elif aff_method == 6:
        q, fret, nev = lbfgs(dof_vg(6), np.zeros(6, f32), 0.01)
        stage_costs[0] = fret
        p0 = _dof_to_p12(q * dof_scale(6), 6)
        q, fret, nev = lbfgs(p12_vg, p0 / p12_scale, ftol, nev)
        p = q * p12_scale
        if finish:
            p, fret, nev = finisher(cost12, p, nev, c12b)
        aff = _p12_matrix(p)
        stage_costs[1] = fret
    elif aff_method == 7:
        q3, fret, nev = lbfgs(dof_vg(3), np.zeros(3, f32), 0.01)
        stage_costs[0] = fret
        sub3 = q3 * dof_scale(3)
        sub6_0 = np.concatenate([sub3, np.zeros(3, f32)])
        q6, fret, nev = lbfgs(dof_vg(6), sub6_0 / dof_scale(6), 0.01, nev)
        stage_costs[1] = fret
        sub6 = q6 * dof_scale(6)
        sub9_0 = np.concatenate([sub6, np.ones(3, f32)])
        q9, fret, nev = lbfgs(dof_vg(9), sub9_0 / dof_scale(9), 0.005, nev)
        stage_costs[2] = fret
        sub9 = q9 * dof_scale(9)
        p0 = _dof_to_p12(sub9, 9)
        q, fret, nev = lbfgs(p12_vg, p0 / p12_scale, ftol, nev)
        p = q * p12_scale
        if finish:
            p, fret, nev = finisher(cost12, p, nev, c12b)
        aff = _p12_matrix(p)
        stage_costs[3] = fret
    else:
        raise ValueError("Wrong affine registration method")
    return aff, fret, stage_costs, nev
