"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/lib<name>-<hash>.so`` at the root of
the checkout (the hash covers the source and the flags, so an edited source
rebuilds), and loaded with ``ctypes``. Nothing but the repository's sources
goes into a build. ``build_all`` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("k1_epoch", "conv_ghost", "gn_relu", "clip_noise")

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by kernel.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> List[Path]:
    """Compile every kernel not built yet, one nvcc per source in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [_target(n) for n in names]


def _bind(name: str, lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    IA = ctypes.POINTER(ctypes.c_int)
    if name == "k1_epoch":
        lib.k1_epoch.argtypes = [ctypes.POINTER(P), I, IA, I,
                                 ctypes.POINTER(F), I, P]
        lib.k1_epoch.restype = I
        lib.k1_epoch_scratch.argtypes = [IA, I]
        lib.k1_epoch_scratch.restype = ctypes.c_longlong
        lib.k1_epoch_plan.argtypes = [IA, I, IA, I]
        lib.k1_epoch_plan.restype = I
        lib.k1_error_string.argtypes = [I]
        lib.k1_error_string.restype = ctypes.c_char_p
    elif name == "conv_ghost":
        lib.ghost_sq_norms_scratch.argtypes = [IA, I]
        lib.ghost_sq_norms_scratch.restype = ctypes.c_longlong
        lib.ghost_sq_norms.argtypes = [P, P, IA, I, I, P, P, P]
        lib.ghost_sq_norms.restype = I
        lib.weighted_kernel_grad_scratch.argtypes = [IA, I]
        lib.weighted_kernel_grad_scratch.restype = ctypes.c_longlong
        lib.weighted_kernel_grad.argtypes = [P, P, P, IA, I, I, P, P, P]
        lib.weighted_kernel_grad.restype = I
        lib.cg_error_string.argtypes = [I]
        lib.cg_error_string.restype = ctypes.c_char_p
    elif name == "gn_relu":
        lib.gn_relu_scratch.argtypes = [IA, IA, I, I]
        lib.gn_relu_scratch.restype = ctypes.c_longlong
        lib.gn_relu_fwd.argtypes = [P, P, P, P, P, IA, IA, I, F, P]
        lib.gn_relu_fwd.restype = I
        lib.gn_relu_bwd.argtypes = [P, P, P, P, P, P, P, P, IA, IA, I, F, P]
        lib.gn_relu_bwd.restype = I
        lib.gn_relu_occupancy.argtypes = [IA, IA, I, I]
        lib.gn_relu_occupancy.restype = I
        lib.gn_relu_launches.argtypes = [I]
        lib.gn_relu_launches.restype = ctypes.c_longlong
        lib.gn_error_string.argtypes = [I]
        lib.gn_error_string.restype = ctypes.c_char_p
    elif name == "clip_noise":
        lib.clip_noise_leaves.argtypes = [ctypes.POINTER(ctypes.c_longlong), I, I, I, I, I,
                                          P, P, P]
        lib.clip_noise_leaves.restype = I
        lib.cn_error_string.argtypes = [I]
        lib.cn_error_string.restype = ctypes.c_char_p
    else:
        raise ValueError(f"unknown kernel library {name}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _libs:
        so = _target(name)
        if not so.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(so))
        _bind(name, lib)
        _libs[name] = lib
    return _libs[name]
