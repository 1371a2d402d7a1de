"""Device mesh and sharding specs — the port of the JAX package's
``parallel/mesh.py``.

A ``Mesh`` is a (n_dp, n_sp) array of ``torch.device`` with the axis names
``("dp", "sp")``, driven from one process as ``shard_map`` drives a JAX
mesh: axis ``"sp"`` shards one volume's z extent (the pencil FFT of
``ops/fft_sharded.py`` exchanges it with one all-to-all a direction), axis
``"dp"`` spreads independent timepoints of a batch.

A mesh's devices may repeat: ``make_mesh(4, devices=[cuda:0] * 4)`` puts
four shards on one card, where every split, exchange and reduction runs
as device-to-device copies; on a node with several GPUs the same code
takes ``cuda:0..n-1``. With ``devices=None`` the mesh takes the visible
CUDA devices, round-robin when it has more places than devices, and
raises without CUDA: it never falls back to the CPU (``devices=["cpu"] *
n`` builds a CPU mesh on purpose). A mesh never spans processes or hosts;
the multi-host path splits timepoints only (``parallel/distributed.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from microimagelib_tpu_torch.utils.device import require_cuda

AXES = ("dp", "sp")


class Mesh:
    """A (n_dp, n_sp) grid of devices. ``devices`` is an object array of
    ``torch.device``; ``shape`` maps each axis name to its extent, as a
    JAX mesh's does."""

    axis_names = AXES

    def __init__(self, devices):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a 2-D (dp, sp) device array, got {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(AXES, devices.shape))

    def row(self, i=0):
        """The devices of dp row ``i``, along 'sp'."""
        return list(self.devices[i])


def _device(d):
    d = torch.device(d)
    return d if d.type == "cpu" else require_cuda(d)


def make_mesh(n_sp=None, n_dp=1, devices=None):
    """Build a ('dp', 'sp') mesh. Defaults: every device on 'sp'.

    ``devices``: a list of devices (repeats allowed), of which the first
    n_dp * n_sp fill the mesh in row-major order; None takes the visible
    CUDA devices, placed round-robin when n_dp * n_sp exceeds their count
    (then n_sp defaults to the device count over n_dp)."""
    if devices is None:
        require_cuda(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_sp is None:
            n_sp = max(1, len(devices) // n_dp)
        devices = [devices[k % len(devices)] for k in range(n_dp * n_sp)]
    else:
        devices = [_device(d) for d in devices]
        if n_sp is None:
            n_sp = len(devices) // n_dp
    if n_sp < 1 or n_dp < 1 or len(devices) < n_dp * n_sp:
        raise ValueError(f"a ({n_dp}, {n_sp}) mesh needs {n_dp * n_sp} devices, "
                         f"got {len(devices)}")
    grid = np.empty((n_dp, n_sp), dtype=object)
    for k, d in enumerate(devices[: n_dp * n_sp]):
        grid[k // n_sp, k % n_sp] = d
    return Mesh(grid)


# --------------------------------------------------------------------------
# sharding specs
# --------------------------------------------------------------------------

def _place(t, device):
    """``t`` as a C-contiguous tensor of its own on ``device``."""
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


def split(x, axis, devices):
    """``x`` cut into len(devices) equal blocks along ``axis``, block i
    placed on devices[i]; with ``axis`` None, a whole copy on each."""
    n = len(devices)
    if axis is None:
        return [_place(x, d) for d in devices]
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of extent {x.shape[axis]} does not split "
                         f"into {n} shards")
    return [_place(b, d) for b, d in zip(torch.chunk(x, n, dim=axis), devices)]


def gather(shards, axis, device=None):
    """The blocks ``shards`` joined along ``axis`` on ``device`` (default:
    the first shard's); with ``axis`` None, the first (replicated) block."""
    device = shards[0].device if device is None else device
    if axis is None:
        return shards[0].to(device)
    return torch.cat([s.to(device) for s in shards], dim=axis)


class Sharding:
    """A layout of a tensor on a mesh: ``spec`` names, for each tensor
    axis, the mesh axis it is split along (or None), as a JAX
    ``PartitionSpec`` does; a tensor is replicated along mesh axes its
    spec does not name. It lays out through :func:`split` and
    :func:`gather`, as the sharded entries do."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def _axis(self, name):
        return self.spec.index(name) if name in self.spec else None

    def shard(self, x):
        """The blocks of ``x`` (a tensor, or numpy) as an object array shaped
        like the mesh: element [i, j] is the block of mesh place (i, j), on
        its device."""
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        rows = split(x, self._axis("dp"), list(self.mesh.devices[:, 0]))
        out = np.empty(self.mesh.devices.shape, dtype=object)
        for i, row in enumerate(rows):
            for j, b in enumerate(split(row, self._axis("sp"), self.mesh.row(i))):
                out[i, j] = b
        return out

    def gather(self, blocks, device=None):
        """The whole tensor from the blocks of :meth:`shard`, on ``device``
        (default: the first mesh place's)."""
        device = self.mesh.devices[0, 0] if device is None else device
        rows = [gather(list(r), self._axis("sp"), device) for r in blocks]
        return gather(rows, self._axis("dp"), device)


def volume_sharding(mesh):
    """(z, y, x) volume sharded along z on the 'sp' axis."""
    return Sharding(mesh, ("sp", None, None))


def spectrum_sharding(mesh):
    """rFFT half spectrum of a z-sharded volume, split along y on 'sp': the
    layout the pencil FFT leaves and the sharded RL keeps its OTFs in (the
    JAX package's function of this name says ('sp', None, None), but its
    sharded code lays spectra out as P(None, 'sp', None))."""
    return Sharding(mesh, (None, "sp", None))


def batch_sharding(mesh):
    """(t, z, y, x) timepoint batch: t on 'dp', z on 'sp'."""
    return Sharding(mesh, ("dp", "sp", None, None))


def replicated(mesh):
    return Sharding(mesh, ())
