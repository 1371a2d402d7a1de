"""Device census and selection over ``torch.cuda`` — the CUDA counterpart
of the reference's device utilities (``queryDevice``
reference:src/apifunc.cpp:328-394 and the per-call ``deviceNum``
convention, e.g. reference:src/api_reg.cpp:319).

Every entry takes an explicit ``torch.device``; nothing here sets a
process-wide default device.
"""

from __future__ import annotations

import torch


def query_device(verbose=True):
    """Return a list of CUDA device-description dicts; print them if
    verbose (``checkGPUDevice``)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    infos = []
    if verbose:
        print(" \n ===========================================")
        print(f"Detected {n} CUDA device(s):")
    for i in range(n):
        props = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        info = {
            "id": i,
            "platform": "cuda",
            "device_kind": props.name,
            "compute_capability": f"{props.major}.{props.minor}",
            "multiprocessors": props.multi_processor_count,
            "memory_total_mb": total / 1048576.0,
            "memory_free_mb": free / 1048576.0,
        }
        infos.append(info)
        if verbose:
            print(f"  Device {i}: {props.name} (sm_{props.major}{props.minor}, "
                  f"{props.multi_processor_count} SMs), "
                  f"{info['memory_total_mb']:.0f} MB total, "
                  f"{info['memory_free_mb']:.0f} MB free")
    if verbose:
        print(" ===========================================\n")
    return infos


def get_device(device_num=0):
    """Map the reference's ``deviceNum`` flag to ``torch.device('cuda', n)``.
    Availability is checked where the device is used (:func:`require_cuda`),
    so a CPU run (memory mode 0) may still pass the default number."""
    if device_num < 0:
        raise ValueError(f"Device {device_num} not available")
    return torch.device("cuda", int(device_num))


def require_cuda(device=None):
    """Return ``device`` (default ``cuda:0``) as a CUDA ``torch.device``;
    raise when CUDA is absent or the index is out of range."""
    device = torch.device("cuda", 0) if device is None else torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"Expected a CUDA device, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: no CUDA device or driver")
    index = 0 if device.index is None else device.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"Device {index} not available "
                         f"({torch.cuda.device_count()} devices present)")
    return torch.device("cuda", index)


def resolve_device(x=None, device=None):
    """The device an entry point runs on: ``device`` when given ('cpu' runs
    on the CPU, a CUDA device must be present), else the device of a
    tensor ``x``, else cuda:0. Never falls back to the CPU: without CUDA a
    CUDA choice raises (:func:`require_cuda`)."""
    if device is not None:
        device = torch.device(device)
        return device if device.type == "cpu" else require_cuda(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return require_cuda(None)


def committed_platform(t):
    """The device type a tensor lives on ('cpu', 'cuda'): the port's
    counterpart of the JAX package's committed-platform probe, read from
    the tensor itself."""
    return t.device.type


def free_memory_mb(device=None):
    """Free device memory in MB (``cudaMemGetInfo``, the records-array
    telemetry of reference:src/api_decon.cpp:103-106); -1 for the CPU or
    when CUDA is absent."""
    if device is None or torch.device(device).type != "cuda":
        return -1.0
    if not torch.cuda.is_available():
        return -1.0
    return torch.cuda.mem_get_info(torch.device(device))[0] / 1048576.0
