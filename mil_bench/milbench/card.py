"""The card the run uses, and the run's environment."""

from __future__ import annotations

import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "microimagelib_tpu")
QUERY = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"


def cache_dirs(root):
    """Point every kernel and build cache the process could use at fixed
    directories inside the checkout (the program builds its own library
    under ``build/`` beside its package)."""
    base = os.path.join(str(root), "build", "mil_bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_compute_cache")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules():
    """Top-level names of loaded modules that the run must not hold."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def require(chips):
    """Raise SystemExit (code 2) unless CUDA has at least ``chips`` cards."""
    import torch

    if not torch.cuda.is_available():
        print("mil_bench: torch.cuda.is_available() is false; no result", file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"mil_bench: {torch.cuda.device_count()} CUDA device(s), the cell asks "
              f"for {chips}; no result", file=sys.stderr)
        raise SystemExit(2)


def smi(fields, timeout=30):
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=timeout, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"


class ClockSampler:
    """``nvidia-smi`` sampling clocks and power once a second beside the
    window, in a child that is stopped and waited for."""

    def __init__(self):
        self.proc = None
        self.t0 = None

    def start(self):
        self.t0 = time.time()
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader",
                 "-lms", "1000"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True)
        except OSError:
            self.proc = None

    def stop(self):
        if self.proc is None:
            return []
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        return [line for line in out.splitlines() if line.strip()]
