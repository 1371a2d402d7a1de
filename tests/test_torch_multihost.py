"""The port's multi-host timepoint split against the JAX package's: two
CPU processes join a gloo group on a free local port and take the
timepoints that the JAX package's ``shard_timepoints`` gives their rank;
the one output tree they fill is the JAX package's one-process regMode 3
tree, with Decon and MP_XY at the batch bound (rtol 2e-4, atol 2e-4 x max)
of both the JAX run and the port's one-process run, the matrices equal to
the port's one-process ones and within the port's registration bound
(0.35 voxel over the central half-box) of JAX's. regMode 2 is refused
before any set-up, as the JAX package refuses it. The children import the
port only."""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from microimagelib_tpu_torch.io.tiff import readtifstack, writetifstack
from microimagelib_tpu_torch.io.tmx import read_tmx
from microimagelib_tpu_torch.models import batch as PB
from microimagelib_tpu_torch.parallel import distributed as DI

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_T = 4

CHILD = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from microimagelib_tpu_torch.models.batch import spim_fusion_batch
from test_torch_multihost import config
done = spim_fusion_batch(config({root!r}, "out"), device="cpu")
with open(os.path.join({root!r}, f"done_{{os.environ['JAX_PROCESS_ID']}}.json"), "w") as f:
    json.dump([int(t) for t in done], f)
"""


def config(root, out, **kw):
    base = dict(
        out_dir=os.path.join(root, out), in_dir1=os.path.join(root, "SPIMA"),
        in_dir2=os.path.join(root, "SPIMB"), name1="SPIMA_", name2="SPIMB_",
        img_start=0, img_end=N_T - 1, img_interval=1, img_test=0,
        pixel1=(1.0, 1.0, 1.0), pixel2=(1.0, 1.0, 1.0), reg_mode=3, im_rotation=0,
        flag_initial_tmx=0, tmx_file="", ftol=1e-3, it_limit=100, save_reg_a=False,
        save_reg_b=False, psf1_file=os.path.join(root, "psf.tif"),
        psf2_file=os.path.join(root, "psf.tif"), it_num_decon=2, save_mp_z=True,
        save_mp_y=False, save_mp_x=False, save_3d_x=False, save_3d_y=False,
        bit_per_sample=32, query_device=False, device_num=0, verbose=False)
    base.update(kw)
    return PB.BatchConfig(**base)


def _jax_side():
    """The JAX package's batch and distributed modules, imported here and not
    at the top: the children import this module, and only the port."""
    from microimagelib_tpu.models import batch
    from microimagelib_tpu.parallel import distributed

    return batch, distributed


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_inputs(root):
    os.makedirs(os.path.join(root, "SPIMA"))
    os.makedirs(os.path.join(root, "SPIMB"))
    base = np.random.default_rng(0).random((12, 24, 20)).astype(np.float32) * 50 + 2
    for t in range(N_T):
        writetifstack(os.path.join(root, "SPIMA", f"SPIMA_{t}.tif"), base * (1 + 0.1 * t), 32)
        writetifstack(os.path.join(root, "SPIMB", f"SPIMB_{t}.tif"),
                      np.roll(base, 1, axis=2) * (1 + 0.1 * t) + 1.0, 32)
    psf = np.exp(-np.sum(np.square(np.mgrid[-2:3, -2:3, -2:3]), 0) / 2.0)
    writetifstack(os.path.join(root, "psf.tif"), (psf / psf.sum()).astype(np.float32), 32)


def test_two_process_batch_disjoint_merged_and_equal(tmp_path):
    from test_torch_fusion import _box_error

    JB, JDI = _jax_side()
    root = str(tmp_path)
    _write_inputs(root)
    port = _free_port()
    procs = []
    env_base = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    env_base["PYTHONPATH"] = os.pathsep.join([REPO, os.path.join(REPO, "tests")])
    logs = [tmp_path / f"process{pid}.log" for pid in range(2)]
    try:
        for pid in range(2):
            env = dict(env_base, MIL_MULTIHOST="1", JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid))
            # output to files: a full pipe would stall a child
            with open(logs[pid], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", CHILD.format(repo=REPO, root=root)], env=env,
                    cwd=root, stdout=f, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-2000:]
    shards = []
    for pid in range(2):
        with open(os.path.join(root, f"done_{pid}.json")) as f:
            shards.append(set(json.load(f)))
    assert shards == [set(JDI.shard_timepoints(list(range(N_T)), pid, 2)) for pid in range(2)]
    out, one, jax_out = tmp_path / "out", tmp_path / "one", tmp_path / "jax"
    assert (out / "ProcessingLog.txt").exists() and (out / "ProcessingLog.p1.txt").exists()
    assert PB.spim_fusion_batch(config(root, "one"), device="cpu") == list(range(N_T))
    assert JB.spim_fusion_batch(JB.BatchConfig(**dataclasses.asdict(config(root, "jax")))) \
        == list(range(N_T))
    assert _tree(out) - {"ProcessingLog.p1.txt"} == _tree(jax_out) == _tree(one)
    for t in range(N_T):
        for rel in (f"Decon/Decon_{t}.tif", f"Decon/MP_ZProj/MP_XY_{t}.tif"):
            got, _ = readtifstack(str(out / rel))
            for ref_out in (one, jax_out):
                ref, _ = readtifstack(str(ref_out / rel))
                np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max(),
                                           err_msg=f"{rel} vs {ref_out.name}")
        m = read_tmx(str(out / "TMX" / f"Matrix_{t}.tmx"))
        np.testing.assert_array_equal(m, read_tmx(str(one / "TMX" / f"Matrix_{t}.tmx")))
        jm = read_tmx(str(jax_out / "TMX" / f"Matrix_{t}.tmx"))
        assert _box_error(m, jm, got.shape) <= 0.35, t


def _tree(out):
    return {os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs}


def test_multihost_refuses_regmode2_and_needs_ids(tmp_path, monkeypatch):
    JB, JDI = _jax_side()
    root = str(tmp_path)
    _write_inputs(root)
    monkeypatch.setenv("MIL_MULTIHOST", "1")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="regMode 2"):
        PB.spim_fusion_batch(config(root, "o", reg_mode=2), device="cpu")
    assert not (tmp_path / "o").exists()
    with pytest.raises(ValueError, match="regMode 2"):
        JB.spim_fusion_batch(JB.BatchConfig(**dataclasses.asdict(config(root, "j",
                                                                          reg_mode=2))))
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    with pytest.raises(ValueError, match="JAX_NUM_PROCESSES"):
        DI.init_distributed()
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    assert DI.init_distributed() is False
    assert DI.shard_timepoints([5, 6, 7, 8, 9]) == [5, 6, 7, 8, 9]
    for pid, n in ((0, 1), (1, 2), (0, 3), (2, 3)):
        assert DI.shard_timepoints([5, 6, 7, 8, 9], pid, n) \
            == JDI.shard_timepoints([5, 6, 7, 8, 9], pid, n)
