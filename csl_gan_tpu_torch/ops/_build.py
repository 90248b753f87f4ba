"""Build and load the port's CUDA kernels at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` from ``csrc/<name>.cu``,
or from the translation units ``UNITS`` names for it, into a shared library
with a plain C interface, ``build/lib<name>-<hash>.so`` at the root of the
checkout (the hash covers its units, the headers ``csrc/*.cuh`` and the flags,
so an edited source rebuilds), and loaded with ``ctypes``. Nothing but the
repository's sources goes into a build. ``build_all`` starts one ``nvcc`` per
translation unit, all at once, each killed by the kernel if the process that
started it dies, then links the libraries of several units.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
KERNELS = ("k1_epoch", "conv_ghost", "gn_relu", "clip_noise")
# Libraries of several translation units, compiled at once and linked: K1's
# tile GEMM in its five product forms beside the rest of K1 (one unit took
# 100.8 s of nvcc, the other sources 5.6-8.1 s; NVIDIA H100 80GB HBM3
# machine, chip_smoke.py's build).
UNITS = {"k1_epoch": ("k1_epoch", "k1_gemm_nt", "k1_gemm_nt_bf16", "k1_gemm_tn",
                      "k1_gemm_tn_bf16", "k1_gemm_nn")}

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by kernel.
build_logs: Dict[str, str] = {}
# Seconds of each unit's nvcc (by file name) and of each link, in the last
# build_all that ran them.
build_seconds: Dict[str, float] = {}

# Run as ``python -c PDEATHSIG <parent pid> cmd...``: asks the kernel for
# SIGKILL when the parent dies (prctl PR_SET_PDEATHSIG, kept across execve),
# exits if the parent is already gone, then becomes cmd.
PDEATHSIG = ("import ctypes, os, signal, sys\n"
             "if ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL, 0, 0, 0) != 0:\n"
             "    sys.exit('prctl(PR_SET_PDEATHSIG) refused')\n"
             "if os.getppid() != int(sys.argv[1]):\n"
             "    sys.exit(1)\n"
             "os.execvp(sys.argv[2], sys.argv[2:])\n")


def dying_with_parent(cmd: List[str]) -> List[str]:
    """cmd, run so that the kernel kills it (SIGKILL) when the calling
    process dies, killed or not. Start it from the main thread: the kernel
    signals the death of the thread that started the child."""
    return [sys.executable, "-c", PDEATHSIG, str(os.getpid()), *map(str, cmd)]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def units(name: str) -> tuple:
    """The translation units of a library: ``csrc/<unit>.cu`` each."""
    return UNITS.get(name, (name,))


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{u}.cu" for u in units(name)] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode() + path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=KERNELS) -> List[Path]:
    """Compile every library not built yet: one nvcc per translation unit,
    all in parallel, then a link for each library of several units."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, libs = [], []
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp, parts = so.with_suffix(f".tmp{os.getpid()}"), []
        for u in units(name):
            # One unit: the library itself; several: an object each, linked below.
            out = tmp if len(units(name)) == 1 else so.with_suffix(f".{u}.{os.getpid()}.o")
            mode = ["-shared"] if len(units(name)) == 1 else ["-c"]
            cmd = [_nvcc(), *NVCC_FLAGS, *mode, "-o", str(out), str(CSRC / f"{u}.cu")]
            log = so.with_suffix(f".{u}.log{os.getpid()}")
            with open(log, "wb") as fh:
                procs.append((name, u, log, time.perf_counter(), subprocess.Popen(
                    dying_with_parent(cmd), stdout=fh, stderr=subprocess.STDOUT)))
            parts.append(out)
        libs.append((name, so, tmp, parts))
    pending = list(procs)
    while pending:                  # each unit's seconds as it ends
        for p in [p for p in pending if p[-1].poll() is not None]:
            build_seconds[f"{p[1]}.cu"] = time.perf_counter() - p[3]
            pending.remove(p)
        time.sleep(0.05)
    errors, logs, failed = [], {}, set()
    for name, u, log, _, proc in procs:
        out = log.read_text(errors="replace")
        log.unlink()
        logs[name] = logs.get(name, "") + out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {u}.cu:\n{out}")
            failed.add(name)
    build_logs.update(logs)
    for name, so, tmp, parts in libs:
        if len(parts) > 1:
            if name not in failed:
                t0 = time.perf_counter()
                link = subprocess.run(
                    dying_with_parent([_nvcc(), *ARCH, "-shared", "-o", str(tmp),
                                       *map(str, parts)]),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                build_seconds[f"{name} link"] = time.perf_counter() - t0
                if link.returncode != 0:
                    errors.append(f"nvcc could not link {name}:\n{link.stdout}")
                    failed.add(name)
            for part in parts:
                part.unlink(missing_ok=True)
        if name not in failed:
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
