"""Time-lapse batch fusion driver — the ``spimFusionBatch`` pipeline
(reference:src/spim_fusion_batch.cpp:117-997; the JAX package's
``models/batch.py``):

  * TIFF reads for the NEXT timepoint are prefetched on a background
    thread while the card processes the current one, and TIFF writes
    (decon volume, registered views, MPs and MIPs) are retired on a writer
    pool. The writer threads receive numpy arrays only: every result is
    fetched with ``.cpu()`` on the main thread.
  * OTFs are computed once per grid and reused across timepoints.
  * Registration semantics as the reference's: regMode 0-3, the
    checkmatrix + costValueBar=0.1 retry cascade (swap regChoice 2<->4,
    then fall back to the input/previous matrix), and regMode 2's weighted
    matrix propagation 0.8*prev + 0.2*new
    (reference:src/spim_fusion_batch.cpp:714-843).

Per timepoint one chain runs on the card, in the order of the JAX
package's fused timepoint program: isotropize both views; register
(matrix only); center-align view B to the target grid and apply the
matrix; pad, joint RL deconvolution and crop; 2-D MPs and rotating MIPs.
The deconvolution takes the route ``rl_decon_dual`` picks for the batch's
PSFs and grid (K1 or the FFT route, K3 or ``torch.fft``); registration
runs on K4/K5. ``MIL_BATCH_GROUP`` > 1 buffers registered timepoints and
deconvolves each group in one batched RL loop
(``decon_dualview_prepared_batch``, ``torch.fft``). With a device mesh
(``mesh=``, ``parallel/mesh.py``) the groups are ``mesh.shape["dp"]``
timepoints, deconvolved by ``rl_decon_dual_batch_dp``: timepoints across
'dp', each volume z-sharded across 'sp' (registration and I/O stay per
timepoint on the batch's device). ``MIL_MULTIHOST=1`` splits the
timepoints round-robin over the processes of a gloo group
(``parallel/distributed.py``); a process of rank r > 0 logs to
``ProcessingLog.p{r}.txt``.

Output tree (reference:src/spim_fusion_batch.cpp:244-319):
  out/Decon/Decon_<t>.tif, out/TMX/Matrix_<t>.tmx, out/RegA, out/RegB,
  out/Decon/{MP_ZProj,MP_XProj,MP_YProj,MP_3D_Xaxis,MP_3D_Yaxis},
  out/ProcessingLog.txt — line for line the JAX package's log.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from microimagelib_tpu_torch.io.tiff import gettifinfo, readtifstack, writetifstack
from microimagelib_tpu_torch.io.tmx import read_tmx, write_tmx
from microimagelib_tpu_torch.models.deconvolution import (
    _fft_grid,
    decon_dualview_prepared_batch,
    gen_otf,
    rl_decon_dual,
)
from microimagelib_tpu_torch.models.fusion import fusion_sizes, preprocess_views
from microimagelib_tpu_torch.models.projections import _mp2d_flat, _split_mp2d, mip3d_frames
from microimagelib_tpu_torch.models.registration import checkmatrix, reg3d
from microimagelib_tpu_torch.ops.affine import affine_transform_3d
from microimagelib_tpu_torch.ops.basics import align_size_3d, crop_center, pad_stack_edge
from microimagelib_tpu_torch.ops.matrix import identity_tmx
from microimagelib_tpu_torch.parallel.distributed import (
    init_distributed,
    process_index,
    shard_timepoints,
)
from microimagelib_tpu_torch.parallel.sharded import rl_decon_dual_batch_dp
from microimagelib_tpu_torch.utils.device import require_cuda
from microimagelib_tpu_torch.utils.envflags import env_on

__all__ = ["BatchConfig", "spim_fusion_batch", "spim_fusion_batch_multicolor",
           "find_color_folders", "COST_VALUE_BAR"]

COST_VALUE_BAR = 0.1  # reference:src/spim_fusion_batch.cpp:563


def _warm_method(aff_method):
    """Registration method for regMode-2 WARM timepoints (idx > 0):
    MIL_BATCH_WARM_METHOD '0'/'off'/'auto' (default) keeps the configured
    method (the warm-started full ladder), 'collapse' runs one 12-DOF
    stage from the propagated matrix, a number names a method."""
    wm_env = os.environ.get("MIL_BATCH_WARM_METHOD", "auto")
    if wm_env in ("0", "off", "auto"):
        return aff_method
    if wm_env == "collapse":
        return 5 if aff_method in (6, 7) else aff_method
    return int(wm_env)


def _warm_finish():
    """Powell finisher on regMode-2 WARM timepoints: off by default (the
    L-BFGS-only warm ladder; regMode 2 is the reference's speed mode, its
    0.8/0.2 propagation already trades exactness for throughput,
    reference:src/spim_fusion_batch.cpp:804-806). MIL_BATCH_WARM_FINISH=1
    restores it (deferring to MIL_REG_GRAD_FINISH)."""
    return None if env_on("MIL_BATCH_WARM_FINISH") else False


@dataclass
class BatchConfig:
    """The 34/36 positional arguments of the ImageJ diSPIMFusion protocol
    (reference:src/spim_fusion_batch.cpp:67-113)."""

    out_dir: str
    in_dir1: str
    in_dir2: str
    name1: str
    name2: str
    img_start: int
    img_end: int
    img_interval: int
    img_test: int
    pixel1: tuple  # (x, y, z) um
    pixel2: tuple
    reg_mode: int  # 0 none; 1 one-for-all; 2 dependent; 3 independent
    im_rotation: int  # 0 / 1 / -1
    flag_initial_tmx: int  # 0 identity; 1 file; 2 phasor; 3 2D MIP
    tmx_file: str
    ftol: float
    it_limit: int
    save_reg_a: bool
    save_reg_b: bool
    psf1_file: str
    psf2_file: str
    it_num_decon: int
    save_mp_z: bool
    save_mp_y: bool
    save_mp_x: bool
    save_3d_x: bool
    save_3d_y: bool
    bit_per_sample: int
    query_device: bool
    device_num: int
    psf1_bp_file: str = ""
    psf2_bp_file: str = ""
    # extensions of the JAX package (not in the reference protocol)
    overlap_io: bool = True
    verbose: bool = True
    # camera background subtraction (counts), clipped at zero; the
    # reference parses -bg1/-bg2 in spimFusion but never applies them
    # (reference:src/spim_fusion.cpp:194-202)
    bg1: float = 0.0
    bg2: float = 0.0


def _log(log_path, msg):
    with open(log_path, "a") as f:
        f.write(msg)


def _make_output_tree(out_dir, cfg):
    paths = {
        "decon": os.path.join(out_dir, "Decon"),
        "tmx": os.path.join(out_dir, "TMX"),
        "reg_a": os.path.join(out_dir, "RegA"),
        "reg_b": os.path.join(out_dir, "RegB"),
    }
    paths["mp_xy"] = os.path.join(paths["decon"], "MP_ZProj")
    paths["mp_yz"] = os.path.join(paths["decon"], "MP_XProj")
    paths["mp_zx"] = os.path.join(paths["decon"], "MP_YProj")
    paths["mp3d_x"] = os.path.join(paths["decon"], "MP_3D_Xaxis")
    paths["mp3d_y"] = os.path.join(paths["decon"], "MP_3D_Yaxis")
    os.makedirs(paths["decon"], exist_ok=True)
    os.makedirs(paths["tmx"], exist_ok=True)  # tmx always saved
    for flag, key in ((cfg.save_reg_a, "reg_a"), (cfg.save_reg_b, "reg_b"),
                      (cfg.save_mp_z, "mp_xy"), (cfg.save_mp_x, "mp_yz"),
                      (cfg.save_mp_y, "mp_zx"), (cfg.save_3d_x, "mp3d_x"),
                      (cfg.save_3d_y, "mp3d_y")):
        if flag:
            os.makedirs(paths[key], exist_ok=True)
    return paths


def _timepoint_list(cfg):
    return list(range(cfg.img_start, cfg.img_end + 1, cfg.img_interval))


def _failed(log_path, cost, then):
    _log(log_path, f"\n\t... Attempt failed: matrix problematic or cost {cost:f} < "
                   f"{COST_VALUE_BAR:.2f}\n\n\t... {then}!!!\n")


def _register_with_cascade(a_iso, b_iso, reg_choice, aff_method, flag_tmx, tmx_in,
                           cfg, log_path, fallback_tmx, dev, mem_mode):
    """One registration attempt (matrix only) + the reference's retry
    cascade (reference:src/spim_fusion_batch.cpp:722-747). Returns
    (tmx12, records)."""
    sz, sy, sx = a_iso.shape

    def attempt(choice, method, flag, tmx):
        _, out_tmx, rec = reg3d(a_iso, b_iso, choice, method, flag, tmx, cfg.ftol,
                                cfg.it_limit, device=dev, mem_mode=mem_mode,
                                verbose=cfg.verbose, want_reg=False)
        ok = checkmatrix(out_tmx, sx, sy, sz) and rec[3] >= COST_VALUE_BAR
        return out_tmx, rec, ok

    out_tmx, rec, ok = attempt(reg_choice, aff_method, flag_tmx, tmx_in)
    if not ok and reg_choice in (2, 4):
        _failed(log_path, rec[3], "Change scheme and redo the registration")
        out_tmx, rec, ok = attempt(2 if reg_choice == 4 else 4, aff_method, False, None)
        if not ok and fallback_tmx is not None:
            _failed(log_path, rec[3], "Use input transformation matrix")
            out_tmx, rec, _ = attempt(0, aff_method, True, fallback_tmx)
    return out_tmx, rec


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def spim_fusion_batch(cfg: BatchConfig, mesh=None, *, device=None, timings=None):
    """Run the batch pipeline on ``cuda:{cfg.device_num}`` (``device="cpu"``
    runs it on the CPU, on the kernels' plain versions). Returns the list
    of processed timepoints.

    ``mesh``: an optional ('dp', 'sp') mesh (``parallel.mesh.make_mesh``):
    timepoints are deconvolved in dp-sized groups with volumes z-sharded
    over 'sp'; a final partial group is padded with its last timepoint.
    ``MIL_MULTIHOST=1`` runs this process's round-robin share of the
    timepoints (regMode 2 chains timepoints and raises ValueError).
    ``timings``, when given a dict, receives per timepoint the seconds of
    each stage (the card is synchronized between stages): 'read' (the
    reader's file reads), 'wait' (the main thread's wait for them),
    'preprocess', 'registration', 'decon', 'mp' (2-D MPs and rotating
    MIPs), 'fetch' (copies to the host) and 'write' (the writer pool's
    TIFF writes), and for regMode 1 at the test timepoint 'test
    registration' (its read, preprocess and registration)."""
    multihost = env_on("MIL_MULTIHOST")
    if multihost and cfg.reg_mode == 2:
        raise ValueError(
            "MIL_MULTIHOST=1 cannot shard regMode 2 (dependent "
            "registration chains timepoints); use regMode 0, 1 or 3")
    dev = (torch.device("cpu") if device is not None and torch.device(device).type == "cpu"
           else require_cuda(device if device is not None
                             else torch.device("cuda", cfg.device_num)))
    mem_mode = 0 if dev.type == "cpu" else -1
    t_whole = time.time()
    paths = _make_output_tree(cfg.out_dir, cfg)

    # --- PSFs read once ---
    psf1, _ = readtifstack(cfg.psf1_file)
    psf2, _ = readtifstack(cfg.psf2_file)
    unmatch = bool(cfg.psf1_bp_file) and bool(cfg.psf2_bp_file)
    psf1_bp = readtifstack(cfg.psf1_bp_file)[0] if unmatch else psf1[::-1, ::-1, ::-1]
    psf2_bp = readtifstack(cfg.psf2_bp_file)[0] if unmatch else psf2[::-1, ::-1, ::-1]
    psf_kw = dict(psf_a=psf1, psf_b=psf2, psf_bp_a=psf1_bp, psf_bp_b=psf2_bp)

    # --- initial matrix / regChoice mapping (reference:..:562-589) ---
    reg_choice = 2
    flag_itmx = False
    tmx_initial = None
    if cfg.flag_initial_tmx == 1:
        flag_itmx = True
        tmx_initial = read_tmx(cfg.tmx_file)
    elif cfg.flag_initial_tmx == 2:
        reg_choice = 3
    elif cfg.flag_initial_tmx == 3:
        reg_choice = 4
    aff_method = 6  # reference default for batch (src/spim_fusion_batch.cpp:561)

    timepoints = _timepoint_list(cfg)
    # multi-host timepoint data parallelism: each process takes a round-robin
    # share; outputs are keyed by timepoint in the shared tree
    process_tag = ""
    if multihost:
        init_distributed()
        timepoints = shard_timepoints(timepoints)
        if process_index() > 0:
            process_tag = f".p{process_index()}"
    log_path = os.path.join(cfg.out_dir, f"ProcessingLog{process_tag}.txt")
    _write_header(log_path, cfg, timepoints, psf1, unmatch)
    if mesh is not None:
        _log(log_path, f"...Device mesh (dp {mesh.shape['dp']}, sp {mesh.shape['sp']}): "
                       f"{', '.join(str(d) for d in mesh.devices.ravel())}\n\n")

    def img_paths(t):
        return (os.path.join(cfg.in_dir1, f"{cfg.name1}{t}.tif"),
                os.path.join(cfg.in_dir2, f"{cfg.name2}{t}.tif"))

    def read_pair(t):
        p1, p2 = img_paths(t)
        return _sub_bg(readtifstack(p1)[0], cfg.bg1), _sub_bg(readtifstack(p2)[0], cfg.bg2)

    stats = {} if timings is None else timings
    stats_lock = threading.Lock()

    def stage(t, name, since, sync=True):
        """Seconds since ``since`` into stats[t][name] (after a sync of the
        card when timings are asked for and ``sync``); returns now."""
        if timings is not None and sync:
            _sync(dev)
        now = time.time()
        with stats_lock:
            d = stats.setdefault(t, {})
            d[name] = d.get(name, 0.0) + now - since
        return now

    # --- background reader: prefetch the next timepoint ---
    read_q: "queue.Queue" = queue.Queue(maxsize=2)

    def reader(tp_list):
        for t in tp_list:
            try:
                t_r = time.time()
                a, b = read_pair(t)
                stage(t, "read", t_r, sync=False)
                read_q.put((t, a, b))
            except Exception as e:  # surface read failures in order
                read_q.put((t, e, None))
        read_q.put(None)

    writer_pool = ThreadPoolExecutor(max_workers=2) if cfg.overlap_io else None
    pending = []

    def write_async(t, path, arr):
        """Write numpy ``arr`` (never a device tensor) as a TIFF."""
        def job():
            t_w = time.time()
            writetifstack(path, arr, cfg.bit_per_sample)
            with stats_lock:
                d = stats.setdefault(t, {})
                d["write"] = d.get("write", 0.0) + time.time() - t_w
        if writer_pool is not None:
            pending.append(writer_pool.submit(job))
        else:
            job()

    # --- OTFs computed once per grid, reused across every timepoint ---
    otf_state = {}

    def get_otfs(grid):
        if otf_state.get("grid") != grid:
            otf_state["grid"] = grid
            otf_state["otfs"] = [gen_otf(np.ascontiguousarray(p), grid, device=dev)
                                 for p in (psf1, psf2, psf1_bp, psf2_bp)]
        return otf_state["otfs"]

    def iso_views(a_in, b_in):
        return preprocess_views(a_in, b_in, cfg.pixel1, cfg.pixel2, cfg.im_rotation,
                                dev, verbose=cfg.verbose, as_device=True)

    def apply_and_pad(a_iso, b_iso, tmx12):
        """View B center-aligned to the target grid (the matrix's source
        frame: reg3d registers the aligned source,
        reference:src/api_reg.cpp:398-407), moved by the matrix; both
        padded to the FFT grid."""
        tgt = tuple(a_iso.shape)
        b = b_iso if tuple(b_iso.shape) == tgt else align_size_3d(b_iso, tgt)
        reg_b = affine_transform_3d(b, np.asarray(tmx12, np.float32), tgt)
        grid = _fft_grid(tgt)
        pads = [v if tuple(v.shape) == grid else pad_stack_edge(v, grid)
                for v in (a_iso, reg_b)]
        return reg_b, pads, grid

    def outputs(t, est, t_mark):
        """The 2-D MPs and rotating MIPs of the decon on the card; returns
        the device tensors to fetch."""
        outs = {"decon": est}
        if cfg.save_mp_z or cfg.save_mp_x or cfg.save_mp_y:
            outs["mp"] = _mp2d_flat(est, cfg.save_mp_z, cfg.save_mp_x, cfg.save_mp_y)
        if cfg.save_3d_x:
            outs["mip_x"] = mip3d_frames(est, 1, 36)
        if cfg.save_3d_y:
            outs["mip_y"] = mip3d_frames(est, 2, 36)
        stage(t, "mp", t_mark)
        return outs

    def collect(t, outs, t0_tp, log_time=True):
        """Fetch a timepoint's outputs on this thread and queue their
        writes."""
        t_f = time.time()
        host = {k: v.cpu().numpy() for k, v in outs.items()}
        stage(t, "fetch", t_f)
        dec = host["decon"]
        write_async(t, os.path.join(paths["decon"], f"Decon_{t}.tif"), dec)
        for key, name, path_key in (("reg_a", f"{cfg.name1}reg_{t}.tif", "reg_a"),
                                    ("reg_b", f"{cfg.name2}reg_{t}.tif", "reg_b"),
                                    ("mip_x", f"MP_3D_Xaxis_{t}.tif", "mp3d_x"),
                                    ("mip_y", f"MP_3D_Yaxis_{t}.tif", "mp3d_y")):
            if key in host:
                write_async(t, os.path.join(paths[path_key], name), host[key])
        if "mp" in host:
            mps = _split_mp2d(host["mp"], dec.shape, cfg.save_mp_z, cfg.save_mp_x,
                              cfg.save_mp_y)
            for key, name, path_key in (("xy", f"MP_XY_{t}.tif", "mp_xy"),
                                        ("yz", f"MP_YZ_{t}.tif", "mp_yz"),
                                        ("zx", f"MP_ZX_{t}.tif", "mp_zx")):
                if key in mps:
                    write_async(t, os.path.join(paths[path_key], name), mps[key])
        if log_time:
            dt = time.time() - t0_tp
            _log(log_path, f"...Time cost for current image is {dt:2.3f} s\n")
            if cfg.verbose:
                print(f"...Time cost for current image is {dt:2.3f} s")

    # --- regMode state ---
    reg_mode = cfg.reg_mode
    tmx_previous = None
    tmx_weighted = None
    tmx_apply = tmx_initial  # matrix applied in regMode 0 passes

    try:
        # regMode 1: register the test timepoint first, then apply to all
        if reg_mode == 1:
            t = cfg.img_test
            t_mark = time.time()
            a_iso, b_iso = iso_views(*read_pair(t))
            _log(log_path, f"\n*** Registration on test image number: {t} \n")
            tmx_apply, _ = _register_with_cascade(
                a_iso, b_iso, reg_choice, aff_method, flag_itmx, tmx_initial, cfg,
                log_path, tmx_initial if flag_itmx else None, dev, mem_mode)
            del a_iso, b_iso
            stage(t, "test registration", t_mark)
            reg_mode = 0
            flag_itmx = True

        reader_thread = None
        if cfg.overlap_io:
            reader_thread = threading.Thread(target=reader, args=(timepoints,), daemon=True)
            reader_thread.start()

        # timepoints per batched decon: the mesh's dp extent, else
        # MIL_BATCH_GROUP (1 = per timepoint)
        group_size = (mesh.shape["dp"] if mesh is not None
                      else max(1, int(os.environ.get("MIL_BATCH_GROUP", "1"))))
        grouped = mesh is not None or group_size > 1
        # the JAX package logs a registering or matrix-applying timepoint of the
        # per-timepoint chain as its one fused program, and the time-cost line
        # of timepoint t after the registration of t+1 (its outputs are
        # collected one timepoint late); an identity-matrix regMode 0 and
        # grouped decon keep the stage-by-stage lines
        chained = not grouped and (reg_mode in (2, 3) or tmx_apply is not None)
        processed = []
        group = []
        in_flight = None

        def flush_group():
            t_dec = time.time()
            ts = [g[0] for g in group]
            out_shape = group[0][3]
            otfs = get_otfs(group[0][4])
            if mesh is None:
                est = decon_dualview_prepared_batch(
                    torch.stack([g[1] for g in group]), torch.stack([g[2] for g in group]),
                    *otfs, cfg.it_num_decon, False, out_shape)
            else:
                # a final partial group is padded with its last timepoint
                entries = group + [group[-1]] * (-len(group) % group_size)
                est = rl_decon_dual_batch_dp(
                    torch.stack([g[1] for g in entries]),
                    torch.stack([g[2] for g in entries]), *otfs, cfg.it_num_decon,
                    mesh).to(dev)
                if tuple(est.shape[1:]) != tuple(out_shape):
                    est = crop_center(est, out_shape)
            stage(ts[0], "decon", t_dec)
            for i, t_out in enumerate(ts):
                collect(t_out, outputs(t_out, est[i], time.time()), 0.0, log_time=False)
            _log(log_path, f"\t... Deconvolution (group of {len(ts)}) time cost: "
                           f"{time.time() - t_dec:2.3f} s\n")
            group.clear()

        for idx, t in enumerate(timepoints):
            t0 = time.time()
            if cfg.overlap_io:
                item = read_q.get()
                if item is None:
                    break
                t_got, a_in, b_in = item
                if isinstance(a_in, Exception):
                    raise a_in
                assert t_got == t
            else:
                t_r = time.time()
                a_in, b_in = read_pair(t)
                stage(t, "read", t_r)
            t_mark = stage(t, "wait", t0)
            if cfg.verbose:
                print(f"\n*** Image time point number: {t} ")
            _log(log_path, f"\n*** Image time point number: {t} \n... Registration...\n")

            a_iso, b_iso = iso_views(a_in, b_in)
            del a_in, b_in
            t_mark = stage(t, "preprocess", t_mark)
            sz, sy, sx = a_iso.shape

            # --- registration per regMode (matrix only) ---
            rec = np.zeros(11)
            if reg_mode == 0:
                out_tmx = (np.asarray(tmx_apply, np.float32).copy() if tmx_apply is not None
                           else identity_tmx())
            elif reg_mode == 2 and idx > 0:
                _, out_tmx, rec = reg3d(
                    a_iso, b_iso, 2, _warm_method(aff_method), True, tmx_weighted,
                    cfg.ftol, cfg.it_limit, device=dev, mem_mode=mem_mode,
                    verbose=cfg.verbose, want_reg=False,
                    pyramid="auto" if env_on("MIL_BATCH_WARM_PYRAMID") else False,
                    grad_finish=_warm_finish())
                if not (checkmatrix(out_tmx, sx, sy, sz) and rec[3] >= COST_VALUE_BAR):
                    _failed(log_path, rec[3], "Use previous transformation matrix")
                    _, out_tmx, rec = reg3d(a_iso, b_iso, 0, aff_method, True, tmx_previous,
                                            cfg.ftol, cfg.it_limit, device=dev,
                                            mem_mode=mem_mode, verbose=cfg.verbose,
                                            want_reg=False)
                tmx_weighted = 0.8 * tmx_weighted + 0.2 * out_tmx  # reference:..:804-806
            else:  # regMode 3 (independent), regMode 2's first timepoint, any other
                out_tmx, rec = _register_with_cascade(
                    a_iso, b_iso, reg_choice, aff_method, flag_itmx, tmx_initial, cfg,
                    log_path, tmx_initial if flag_itmx else None, dev, mem_mode)
                if reg_mode == 2:
                    tmx_weighted = out_tmx.copy()
            if reg_mode == 2:
                tmx_previous = out_tmx.copy()
            if reg_mode == 0:
                rec[7] = time.time() - t_mark
            t_mark = stage(t, "registration", t_mark)
            if not (chained and reg_mode == 0):
                _log(log_path, f"\t... initial cost function value: {rec[1]:f}\n"
                               f"\t... final cost function value: {rec[3]:f}\n"
                               f"\t... registration time cost: {rec[7]:2.3f} s\n")
            write_tmx(os.path.join(paths["tmx"], f"Matrix_{t}.tmx"),
                      np.asarray(out_tmx, np.float32).copy())

            reg_b, (pad_a, pad_b), grid = apply_and_pad(a_iso, b_iso, out_tmx)
            del b_iso
            extra = {}
            if cfg.save_reg_a:
                extra["reg_a"] = a_iso
            if cfg.save_reg_b:
                extra["reg_b"] = reg_b

            if grouped:
                # grouped decon: the registered views are written now, the
                # group's decon and outputs when it is full
                _log(log_path, "... Deconvolution...\n")
                for key, v in extra.items():
                    name = cfg.name1 if key == "reg_a" else cfg.name2
                    write_async(t, os.path.join(paths[key], f"{name}reg_{t}.tif"),
                                v.cpu().numpy())
                group.append((t, pad_a, pad_b, (sz, sy, sx), grid))
                if len(group) == group_size:
                    flush_group()
                processed.append(t)
                _log(log_path, f"...Time cost for current image is {time.time() - t0:2.3f} s\n")
                if cfg.verbose:
                    print(f"...Time cost for current image is {time.time() - t0:2.3f} s")
                continue

            # --- joint deconvolution (OTFs reused; K1 or the FFT route) ---
            if not chained:
                _log(log_path, "... Deconvolution...\n")
            t_dec = t_mark
            est = rl_decon_dual(pad_a, pad_b, *get_otfs(grid), cfg.it_num_decon, False,
                                **psf_kw)
            del pad_a, pad_b
            if tuple(est.shape) != (sz, sy, sx):
                est = crop_center(est, (sz, sy, sx))
            t_mark = stage(t, "decon", t_mark)
            outs = outputs(t, est, t_mark)
            outs.update(extra)
            del a_iso, reg_b, est, extra
            processed.append(t)
            if chained:
                _log(log_path, "\t... fused apply+decon+MIP program\n")
                if in_flight is not None:
                    collect(*in_flight)
                in_flight = (t, outs, t0)
            else:
                _log(log_path, f"\t... Deconvolution time cost: {time.time() - t_dec:2.3f} s\n")
                collect(t, outs, t0)

        if in_flight is not None:
            collect(*in_flight)
            in_flight = None
        if group:
            flush_group()

        # drain the writers: a failed write raises here
        for fut in pending:
            fut.result()
    finally:
        if writer_pool is not None:
            writer_pool.shutdown()
    if reader_thread is not None:
        reader_thread.join()
    _log(log_path, f"Total time cost for whole processing is {time.time() - t_whole:2.3f} s\n")
    return processed


def _sub_bg(arr, bg):
    """Camera background subtraction, clipped at zero (cfg.bg1/bg2)."""
    if not bg:
        return arr
    return np.maximum(np.asarray(arr, np.float32) - np.float32(bg), 0.0)


def _write_header(log_path, cfg, timepoints, psf1, unmatch):
    """The full settings dump the reference writes before processing
    (reference:src/spim_fusion_batch.cpp:455-524)."""
    first_t = timepoints[0] if timepoints else cfg.img_start
    size1_in = gettifinfo(os.path.join(cfg.in_dir1, f"{cfg.name1}{first_t}.tif"))[0]
    size2_in = gettifinfo(os.path.join(cfg.in_dir2, f"{cfg.name2}{first_t}.tif"))[0]
    psf_size = (psf1.shape[2], psf1.shape[1], psf1.shape[0])
    out_size, _, _ = fusion_sizes(size1_in, size2_in, cfg.pixel1, cfg.pixel2,
                                  cfg.im_rotation)
    px1, py1, pz1 = cfg.pixel1
    px2, py2, pz2 = cfg.pixel2
    reg_mode_text = {
        0: "...No registration\n",
        1: f"...One registration for all images, test image number: {cfg.img_test}\n",
        2: "...Perform registration for all images dependently\n",
        3: "...Perform registration for all images independently\n",
    }.get(cfg.reg_mode, "...regMode incorrect !!!\n")
    rot_text = {
        0: "...No rotation on image B\n",
        1: "...Rotate image B by 90 degree along Y axis\n",
        -1: "...Rotate image B by -90 degree along Y axis\n",
    }.get(cfg.im_rotation, "")
    itmx_text = {
        1: "...Initial transformation matrix: based on input matrix\n",
        2: "...Initial transformation matrix: by 3D phase translation\n",
        3: "...Initial transformation matrix: by 2D registration\n",
    }.get(cfg.flag_initial_tmx, "...Initial transformation matrix: Default\n")
    with open(log_path, "w") as f:
        f.write(f"microimagelib_tpu_torch spimFusionBatch: {time.ctime()}\n")
        f.write("Single color data:\n")
        f.write(f"...SPIMA input directory: {cfg.in_dir1}\n")
        f.write(f"...SPIMB input directory: {cfg.in_dir2}\n")
        f.write(f"...Output directory: {cfg.out_dir}\n")
        f.write("\nImage information:\n")
        f.write(f"\tInput image 1 size {size1_in[0]} x {size1_in[1]} x {size1_in[2]}\n")
        f.write(f"\t\t pixel size {px1:.4f} um x {py1:.4f} um x {pz1:.4f} um\n")
        f.write(f"\tInput image 2 size {size2_in[0]} x {size2_in[1]} x {size2_in[2]}\n")
        f.write(f"\t\t pixel size {px2:.4f} um x {py2:.4f} um x {pz2:.4f} um\n")
        f.write(f"\tPSF image size {psf_size[0]} x {psf_size[1]} x {psf_size[2]}\n")
        f.write(f"\t\t pixel size {px1:.4f} um x {px1:.4f} um x {px1:.4f} um\n")
        f.write(f"\tOutput image size {out_size[0]} x {out_size[1]} x {out_size[2]}\n")
        f.write(f"\t\t pixel size {px1:.4f} um x {px1:.4f} um x {px1:.4f} um\n")
        f.write(f"\tImage number from {cfg.img_start} to {cfg.img_end} with step "
                f"{cfg.img_interval}\n")
        f.write(reg_mode_text)
        f.write(rot_text)
        f.write(itmx_text)
        f.write(f"...Registration convergence threshold:{cfg.ftol:f}\n")
        f.write(f"...Registration maximum sub-iteration number:{cfg.it_limit}\n")
        f.write(f"\n...Unmatched back projectors for joint deconvolution: "
                f"{'yes' if unmatch else 'no'}\n")
        f.write(f"...Iteration number for joint deconvolution:{cfg.it_num_decon}\n")
        f.write(f"\n...Device {cfg.device_num} is used...\n\n")


def find_color_folders(main_folder):
    """Multicolor layout scan: subfolders containing SPIMA/ and SPIMB/
    (the reference supports this on Windows only,
    reference:src/spim_fusion_batch.cpp:25-55)."""
    colors = []
    for name in sorted(os.listdir(main_folder)):
        sub = os.path.join(main_folder, name)
        if os.path.isdir(os.path.join(sub, "SPIMA")) and os.path.isdir(os.path.join(sub, "SPIMB")):
            colors.append(name)
    return colors


def spim_fusion_batch_multicolor(main_folder, out_main_folder, cfg_template: BatchConfig,
                                 *, device=None):
    """Run the batch per color subfolder (<main>/<color>/SPIMA|SPIMB)."""
    colors = find_color_folders(main_folder)
    if not colors:
        raise FileNotFoundError(f"No color subfolders with SPIMA/SPIMB under {main_folder}")
    results = {}
    for color in colors:
        cfg = dataclasses.replace(
            cfg_template,
            out_dir=os.path.join(out_main_folder, color),
            in_dir1=os.path.join(main_folder, color, "SPIMA"),
            in_dir2=os.path.join(main_folder, color, "SPIMB"),
        )
        results[color] = spim_fusion_batch(cfg, device=device)
    return results
