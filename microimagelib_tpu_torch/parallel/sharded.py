"""Mesh-sharded execution paths — the port of the JAX package's
``parallel/sharded.py``: volumes sharded along z over a mesh's 'sp' axis,
and data-parallel timepoint batches over its 'dp' axis.

The RL loops are the math of ``models/deconvolution.py`` over the
pencil-decomposed FFT (``ops/fft_sharded.py``): volumes sharded along z,
spectra along y, one all-to-all an FFT direction. One process drives
every place of the mesh, as ``shard_map`` does: a local body works on the
list of one dp row's shards, its collectives (``parallel/collectives.py``)
move data between the places' devices, and the rows of the 'dp' axis run
one after another. A volume spec that names no 'dp' axis is replicated
over the rows in the JAX package; here it runs on row 0 alone (the rows
would compute the same bits).

Every entry takes numpy arrays or tensors on any device and lays them out
on the mesh itself; results come back gathered on the mesh's first
device. The sharded path launches no hand-written kernel: each shard's
FFTs are ``torch.fft`` and the windowed resample and NCC sums are the
plain torch of ``ops/affine.py``, as the JAX package runs ``jnp.fft`` and
XLA gathers there.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from microimagelib_tpu_torch.models.deconvolution import _AXES, SMALLVALUE, _as_tensor
from microimagelib_tpu_torch.ops.affine import (
    affine_transform_3d_window,
    corr3d_partials_window,
    zslab_footprint_hops,
)
from microimagelib_tpu_torch.ops import fft_sharded as FS
from microimagelib_tpu_torch.ops.matrix import dof_to_matrix, matrix_to_params, params_to_matrix
from microimagelib_tpu_torch.ops.powell import EvalCounter, powell
from microimagelib_tpu_torch.parallel.collectives import all_gather, ppermute, psum
from microimagelib_tpu_torch.parallel.mesh import gather, split


def _vol_shards(x, devices):
    """float32 z-shards of the (.., z, y, x) volume ``x`` on ``devices``."""
    return split(_as_tensor(x), -3, devices)


def _spec_shards(otf, devices):
    """y-shards of a whole (z, y, xh) spectrum on ``devices``: the
    spectrum's (None, 'sp', None) layout."""
    return split(_as_tensor(otf, dtype=torch.complex64), -2, devices)


def _rl_single_local(img, otf, otf_bp, n_iters, const_initial, nx):
    """Single-view RL over the z-shards ``img`` of one row."""
    img = [s.clamp_min(SMALLVALUE) for s in img]
    if const_initial:
        total = psum([s.sum(dim=_AXES, keepdim=True) for s in img])
        est = [torch.empty_like(s).copy_(t.expand_as(s)) for s, t in zip(img, total)]
    else:
        est = img
    for _ in range(n_iters):
        fwd = FS.conv_spec_pencil(est, otf, nx)
        ratio = [i / f for i, f in zip(img, fwd)]
        upd = FS.conv_spec_pencil(ratio, otf_bp, nx)
        est = [torch.clamp_min(e * u, SMALLVALUE) for e, u in zip(est, upd)]
    return est


def _rl_dual_local(img_a, img_b, otf_a, otf_b, otf_bp_a, otf_bp_b, n_iters,
                   const_initial, nx):
    """Joint dual-view RL over the z-shards of one row: view A then view B
    per iteration."""
    img_a = [s.clamp_min(SMALLVALUE) for s in img_a]
    img_b = [s.clamp_min(SMALLVALUE) for s in img_b]
    if const_initial:
        sa = psum([s.sum(dim=_AXES, keepdim=True) for s in img_a])
        sb = psum([s.sum(dim=_AXES, keepdim=True) for s in img_b])
        est = [torch.empty_like(s).copy_(((a + b) / 2).expand_as(s))
               for s, a, b in zip(img_a, sa, sb)]
    else:
        est = [(a + b) * 0.5 for a, b in zip(img_a, img_b)]

    def half(est, img, otf, otf_bp):
        fwd = FS.conv_spec_pencil(est, otf, nx)
        ratio = [i / f for i, f in zip(img, fwd)]
        upd = FS.conv_spec_pencil(ratio, otf_bp, nx)
        return [torch.clamp_min(e * u, SMALLVALUE) for e, u in zip(est, upd)]

    for _ in range(n_iters):
        est = half(est, img_a, otf_a, otf_bp_a)
        est = half(est, img_b, otf_b, otf_bp_b)
    return est


def _check_divisible(shape, mesh):
    n = mesh.shape["sp"]
    sz, sy, _ = shape
    if sz % n or sy % n:
        raise ValueError(
            f"Sharded decon needs z ({sz}) and y ({sy}) divisible by the "
            f"'sp' mesh extent ({n}); pad the FFT grid accordingly")


def _check_batch(t, mesh):
    if t % mesh.shape["dp"]:
        raise ValueError(f"a batch of {t} timepoints does not split over the "
                         f"'dp' mesh extent ({mesh.shape['dp']})")


def rl_decon_single_sharded(img, otf, otf_bp, n_iters, mesh, const_initial=False):
    """Single-view RL with the volume z-sharded across 'sp'. img on the
    FFT grid; otf/otf_bp whole spectra (split along y onto the mesh).
    Returns the estimate gathered on the mesh's first device."""
    _check_divisible(tuple(img.shape), mesh)
    row = mesh.row(0)
    est = _rl_single_local(_vol_shards(img, row), _spec_shards(otf, row),
                           _spec_shards(otf_bp, row), n_iters, const_initial,
                           img.shape[2])
    return gather(est, 0)


def rl_decon_dual_sharded(img_a, img_b, otf_a, otf_b, otf_bp_a, otf_bp_b,
                          n_iters, mesh, const_initial=False):
    """Joint dual-view RL on a z-sharded volume (beyond-HBM mode)."""
    _check_divisible(tuple(img_a.shape), mesh)
    row = mesh.row(0)
    est = _rl_dual_local(_vol_shards(img_a, row), _vol_shards(img_b, row),
                         *(_spec_shards(o, row) for o in (otf_a, otf_b, otf_bp_a, otf_bp_b)),
                         n_iters, const_initial, img_a.shape[2])
    return gather(est, 0)


def _batch_rows(imgs, mesh):
    """The (t, z, y, x) batch cut along t into one block per dp row."""
    imgs = _as_tensor(imgs)
    return torch.chunk(imgs, mesh.shape["dp"], dim=0)


def rl_decon_dual_batch_dp(imgs_a, imgs_b, otf_a, otf_b, otf_bp_a, otf_bp_b,
                           n_iters, mesh, const_initial=False):
    """Timepoint-batched joint RL: batch axis on 'dp', z extent on 'sp'.
    imgs_*: (t, z, y, x) on the FFT grid, t a multiple of the dp extent.
    Each row's shards hold its timepoints as a leading axis."""
    _check_divisible(tuple(imgs_a.shape[1:]), mesh)
    _check_batch(imgs_a.shape[0], mesh)
    nx = imgs_a.shape[3]
    out = []
    for i, (a, b) in enumerate(zip(_batch_rows(imgs_a, mesh), _batch_rows(imgs_b, mesh))):
        row = mesh.row(i)
        otfs = [_spec_shards(o, row) for o in (otf_a, otf_b, otf_bp_a, otf_bp_b)]
        est = _rl_dual_local(_vol_shards(a, row), _vol_shards(b, row), *otfs,
                             n_iters, const_initial, nx)
        out.append(gather(est, 1, mesh.devices[0, 0]))
    return torch.cat(out, dim=0)


def _gather_zwindow(shards, hops):
    """Bounded slab exchange: extend each z-shard with ``hops`` neighbour
    shards on each side by ppermute rings (neighbour traffic, not an
    all_gather). Returns (windows, win_starts): win_starts[i] is the
    global z of window i's first row, negative on the first ``hops``
    places. Edge places receive wrapped shards in the out-of-range part of
    their window, which no valid sample reads (the host-side footprint
    bound, ``zslab_footprint_hops``, guarantees coverage; the sampler
    clamps its z rows into the window)."""
    n = len(shards)
    dz = shards[0].shape[0]
    parts = []
    for k in range(hops, 0, -1):  # the shard of place idx-k
        parts.append(ppermute(shards, [(j, (j + k) % n) for j in range(n)]))
    parts.append(shards)
    for k in range(1, hops + 1):  # the shard of place idx+k
        parts.append(ppermute(shards, [(j, (j - k) % n) for j in range(n)]))
    wins = [torch.cat([p[idx] for p in parts], dim=0) for idx in range(n)]
    return wins, [(idx - hops) * dz for idx in range(n)]


def _windows(src_shards, hops, full):
    """(windows, win_starts) of each place: the whole source
    (``all_gather``) when ``full``, else the ``hops`` window."""
    if full:
        return all_gather(src_shards, axis=0), [0] * len(src_shards)
    return _gather_zwindow(src_shards, hops)


def _partials(wins, starts, tgt_shards, m, sz):
    """psum-reduced (ss, st) float64 0-d tensors of the target shards
    against their windows."""
    dz = tgt_shards[0].shape[0]
    parts = [corr3d_partials_window(w, t, m, j * dz, s, sz)
             for j, (w, s, t) in enumerate(zip(wins, starts, tgt_shards))]
    return psum([p[0] for p in parts])[0], psum([p[1] for p in parts])[0]


def fusion_step_multichip(mesh, imgs_a, imgs_b, otf_a, otf_b, otf_bp_a, otf_bp_b,
                          tmx_batch, n_iters=1, hops=None):
    """One multi-device fusion step over a timepoint batch: per timepoint
    the registration's NCC partials (the Powell cost) plus the joint RL
    decon iterations, over a ('dp', 'sp') mesh.

    Each place keeps its own target z-shard and receives only the bounded
    source window its rows can sample (``hops`` neighbour shards each side,
    bounded on the host from the affine footprint); the whole source is
    gathered only when the matrix reaches across the volume (hops >= n_sp
    - 1).

    imgs_*: (t, z, y, x) on the FFT grid; tmx_batch: (t, 12). Returns
    (decon_batch, ss, st): the estimates gathered on the mesh's first
    device and float64 (t,) tensors there."""
    _check_divisible(tuple(imgs_a.shape[1:]), mesh)
    _check_batch(imgs_a.shape[0], mesh)
    nx = imgs_a.shape[3]
    n_sp = mesh.shape["sp"]
    sz = imgs_a.shape[1]
    mats = np.asarray(tmx_batch, np.float32).reshape(-1, 12)
    if hops is None:
        hops = max(zslab_footprint_hops(m, tuple(imgs_a.shape[1:]), n_sp) for m in mats)
    hops = int(hops)
    full = hops >= n_sp - 1
    n_loc = imgs_a.shape[0] // mesh.shape["dp"]
    dev0 = mesh.devices[0, 0]
    ests, ss, st = [], [], []
    for i, (a, b) in enumerate(zip(_batch_rows(imgs_a, mesh), _batch_rows(imgs_b, mesh))):
        row = mesh.row(i)
        otfs = [_spec_shards(o, row) for o in (otf_a, otf_b, otf_bp_a, otf_bp_b)]
        for k in range(n_loc):
            a_sh, b_sh = _vol_shards(a[k], row), _vol_shards(b[k], row)
            wins, starts = _windows(b_sh, hops, full)
            s2, st_ = _partials(wins, starts, a_sh, mats[i * n_loc + k], sz)
            del wins
            ss.append(s2.to(dev0))
            st.append(st_.to(dev0))
            est = _rl_dual_local(a_sh, b_sh, *otfs, n_iters, False, nx)
            ests.append(gather(est, 0, dev0))
    return torch.stack(ests), torch.stack(ss), torch.stack(st)


# --------------------------------------------------------------------------
# The sharded registration search: the DOF ladder over mesh-sharded volumes
# --------------------------------------------------------------------------

def _mean_subtracted(img):
    """``img`` minus its mean, as the JAX entry computes it on the host:
    the float64 sum, the difference in float64 rounded to float32."""
    t = _as_tensor(img)
    mean = float(torch.sum(t, dtype=torch.float64)) / t.numel()
    return (t.double() - mean).float()


def reg3d_affine_sharded(mesh, img1, img2, aff_method=1, ftol=1e-4,
                         it_limit=3000, verbose=False, stats=None):
    """Affine registration where both volumes stay z-sharded across the
    mesh's 'sp' axis through the whole Powell DOF-ladder search
    (reference:src/api_subfunc.cu:2732-2994 search semantics).

    The host NR Powell (``ops/powell.py``) drives one sharded cost
    evaluation per probe: each place computes its target z-shard's NCC
    partials against a bounded source window (``_gather_zwindow``, sized
    from the matrix footprint; the whole source when the matrix reaches
    across the volume), then a psum adds the two sums. The hop count is
    derived per probe; each (hops, full_gather) window is exchanged once
    and kept for the probes that need it.

    Returns (registered (numpy, gathered), tmx12, records) with the
    reg3d_affine records contract. ``stats``, if a dict, receives
    ``cost_fn_keys``: the set of (hops, full_gather) windows the search
    used."""
    t_start = time.time()
    records = np.zeros(11, dtype=np.float64)
    shape = tuple(img1.shape)
    _check_divisible(shape, mesh)
    sz = shape[0]
    n_sp = mesh.shape["sp"]
    dz = sz // n_sp
    row = mesh.row(0)

    tgt_ms = _mean_subtracted(img1)
    src_ms = _mean_subtracted(img2)
    sd_t = math.sqrt(float(torch.sum(tgt_ms.double() ** 2)))
    if sd_t == 0:
        raise ValueError("SD of image 1 is zero, empty image input")
    tgt_sh = split(tgt_ms, 0, row)
    src_sh = split(src_ms, 0, row)
    del tgt_ms, src_ms

    windows = {}
    n_evals = 0

    def cost_from_matrix(m12):
        nonlocal n_evals
        n_evals += 1
        m12 = np.asarray(m12, np.float32)
        hops = int(zslab_footprint_hops(m12, shape, n_sp))
        full = hops >= n_sp - 1
        key = (0 if full else hops, full)
        if key not in windows:
            windows[key] = _windows(src_sh, key[0], full)
        ss, st = _partials(*windows[key], tgt_sh, m12, sz)
        ssf = math.sqrt(float(ss))
        if ssf == 0:
            return 2.0
        return -(float(st) / ssf) / sd_t

    t1 = time.time()
    initial = cost_from_matrix(np.asarray([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float32))
    records[1] = -initial
    records[4] = (time.time() - t1) * 1000.0

    t_iter0 = time.time()
    counter = EvalCounter(None)
    dof9 = np.zeros(9, dtype=np.float64)
    dof9[6:9] = 1.0

    def run_powell(p0, fn, this_ftol):
        counter.func = fn
        p_min, f_min, _, _ = powell(p0, fn, this_ftol, it_limit, counter=counter)
        return p_min, f_min

    def run_dof_stage(dof_num, this_ftol):
        def fn(sub):
            full = dof9.copy()
            full[:dof_num] = sub
            return cost_from_matrix(dof_to_matrix(full, dof_num))

        sub_min, f_min = run_powell(dof9[:dof_num].copy(), fn, this_ftol)
        dof9[:dof_num] = sub_min
        return f_min

    def cost12(p):
        return cost_from_matrix(params_to_matrix(p))

    if aff_method in (1, 2, 3, 4):
        dof_num = {1: 3, 2: 6, 3: 7, 4: 9}[aff_method]
        fret = run_dof_stage(dof_num, ftol)
        aff_coef = dof_to_matrix(dof9, dof_num)
    elif aff_method == 5:
        p, fret = run_powell(matrix_to_params(np.asarray(
            [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], np.float64)), cost12, ftol)
        aff_coef = params_to_matrix(p)
    elif aff_method == 6:
        fret = run_dof_stage(6, 0.01)
        records[2] = -fret
        p = matrix_to_params(dof_to_matrix(dof9, 6)).astype(np.float64)
        p, fret = run_powell(p, cost12, ftol)
        aff_coef = params_to_matrix(p)
    elif aff_method == 7:
        run_dof_stage(3, 0.01)
        run_dof_stage(6, 0.01)
        fret = run_dof_stage(9, 0.005)
        records[2] = -fret
        p = matrix_to_params(dof_to_matrix(dof9, 9)).astype(np.float64)
        p, fret = run_powell(p, cost12, ftol)
        aff_coef = params_to_matrix(p)
    else:
        raise ValueError("Wrong affine registration method")

    records[3] = -fret
    records[5] = n_evals
    records[6] = time.time() - t_iter0
    if stats is not None:
        stats["cost_fn_keys"] = set(windows.keys())
    windows.clear()
    del tgt_sh

    # the final transform, still sharded: each place resamples its output
    # z-block from a bounded window of the (not mean-subtracted) source
    m_f = np.asarray(aff_coef, np.float32)
    hops = int(zslab_footprint_hops(m_f, shape, n_sp))
    full = hops >= n_sp - 1
    src2_sh = split(_as_tensor(img2), 0, row)
    wins, starts = _windows(src2_sh, 0 if full else hops, full)
    blocks = [affine_transform_3d_window(w, m_f, (dz, shape[1], shape[2]), j * dz, s, sz)
              for j, (w, s) in enumerate(zip(wins, starts))]
    reg = gather(blocks, 0).cpu().numpy()
    records[7] = time.time() - t_start
    if verbose:
        print(f"\t... sharded registration NCC {-fret:f}, "
              f"{n_evals} evals, {records[7]:.2f} s")
    return reg, m_f, records
