"""Run the JAX package's registration ladder on the CPU from the same start
as K9 and the port's host loop, on pyramid levels dumped by a card run, to
show which optimum the reference reaches where the two differ.

The levels come from ``chip_smoke.py``'s Phase 22 run with
``MIL_SMOKE_DUMP=<dir>`` on a CUDA machine (each level of Phase 10's
pyramid up to ``K9_DUMP_VOXELS``). Each input is an ``.npz`` holding one
level: ``src``, ``tgt`` (the
mean-subtracted pair), ``knobs`` (JSON: sd_t, p_init12, aff_method, ftol,
it_limit, engine, finish, finish_sweeps, ls_max_iters, ls_patience), and
the card's results ``k9_aff``/``k9_fret``/``k9_nev`` and
``host_aff``/``host_fret``/``host_nev``. The JAX ladder runs on the CPU
through the cost route it resolves there (``affine_fast.resolve_ncc_impl``).

    python tools/reg_ladder_witness.py <dir>/*.npz

Prints one line a level and, last, a JSON list of the levels' numbers:
NCC (= -fret) and evaluations of each, and the largest distance, in
voxels over the central half-box, between each pair of matrices.
"""

from __future__ import annotations

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from microimagelib_tpu.models.registration_device import reg_ladder_device  # noqa: E402
from microimagelib_tpu.models.registration_grad import reg_ladder_grad  # noqa: E402
from microimagelib_tpu.ops.affine_fast import resolve_ncc_impl  # noqa: E402


def box_voxels(a, b, shape):
    """Largest distance between two 12-vector matrices' images of the
    corners of the central half-box of a (z, y, x) grid."""
    sz, sy, sx = shape
    pts = np.array([[x, y, z, 1.0] for x in (sx / 4, 3 * sx / 4)
                    for y in (sy / 4, 3 * sy / 4) for z in (sz / 4, 3 * sz / 4)])
    ma = np.asarray(a, np.float64).reshape(3, 4)
    mb = np.asarray(b, np.float64).reshape(3, 4)
    return float(np.linalg.norm(pts @ ma.T - pts @ mb.T, axis=1).max())


def witness(path):
    d = np.load(path)
    k = json.loads(str(d["knobs"]))
    src, tgt = jnp.asarray(d["src"]), jnp.asarray(d["tgt"])
    p0 = jnp.asarray(np.asarray(k["p_init12"], np.float32))
    impl = resolve_ncc_impl(src)
    if k["engine"] == "grad":
        aff, fret, _stage, nev = reg_ladder_grad(
            src, tgt, k["sd_t"], p0, k["aff_method"], k["ftol"], k["it_limit"],
            ncc_impl=impl, finish=k["finish"], finish_sweeps=k["finish_sweeps"],
            ls_max_iters=k["ls_max_iters"], ls_patience=k["ls_patience"])
    else:
        aff, fret, _stage, nev = reg_ladder_device(
            src, tgt, k["sd_t"], p0, k["aff_method"], k["ftol"], k["it_limit"],
            ncc_impl=impl)
    aff = np.asarray(aff, np.float32)
    shape = tuple(d["src"].shape)
    out = {"level": str(d["label"]), "shape": shape, "engine": k["engine"],
           "method": k["aff_method"],
           "ncc": {"jax": -float(fret), "k9": -float(d["k9_fret"]),
                   "host_loop": -float(d["host_fret"])},
           "evaluations": {"jax": int(nev), "k9": int(d["k9_nev"]),
                           "host_loop": int(d["host_nev"])},
           "voxels_apart": {"jax_k9": box_voxels(aff, d["k9_aff"], shape),
                            "jax_host_loop": box_voxels(aff, d["host_aff"], shape),
                            "k9_host_loop": box_voxels(d["k9_aff"], d["host_aff"], shape)}}
    print(f"{out['level']} {shape} {k['engine']} method {k['aff_method']}: NCC JAX "
          f"{out['ncc']['jax']:.7f}, K9 {out['ncc']['k9']:.7f}, host loop "
          f"{out['ncc']['host_loop']:.7f}; evaluations {out['evaluations']}; voxels apart "
          f"{ {n: round(v, 4) for n, v in out['voxels_apart'].items()} }", flush=True)
    return out


def main(argv=None):
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__)
        return 2
    print(json.dumps([witness(p) for p in paths]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
