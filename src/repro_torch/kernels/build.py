"""Build and load the hand-written CUDA kernels (plain C interface + ctypes).

Each `csrc/<name>.cu` compiles with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into its own shared library under `build/repro_torch_kernels/<hash>/` at
the repository root (listed in .gitignore), keyed by a hash of the sources
and flags, so a fresh checkout builds on first use and later processes
reuse the result.  All sources compile in parallel, one nvcc each.  Nothing
builds at import time: the wrappers call `library(name)` when they first
launch a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("bramac_matmul", "paged_attention", "mac2_kernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures: "p" = pointer / stream (c_void_p), "i" = int, "f" = float
_SIGNATURES = {
    # bramac_matmul_launch(x, w, xs, ws, acc, out, M, K, N, bits_a, signed,
    #                      w_packed, out_kind, bm, k_per_split, stream)
    "bramac_matmul": {"bramac_matmul_launch": "ppppppiiiiiiiiip",
                      "bramac_matmul_info": "iiiip"},
    "paged_attention": {"paged_decode_launch": "pppppppiiiiiiiiiiifp",
                        "paged_decode_q_launch": "pppppppppppiiiiiiiiifp",
                        "paged_decode_info": "iiip",
                        "paged_decode_q_info": "iip"},
    "mac2_kernel": {"mac2_mvm_launch": "pppiiiiiip",
                    "mac2_mvm_info": "iiip"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built with the CUDA toolkit's nvcc")
    return found


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every source that is not built yet, all nvcc processes at
    once; returns {name: ptxas report} for what was compiled now."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        if name not in _libs:
            path = _build_dir() / f"lib{name}.so"
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            for fn, sig in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = [_CTYPES[c] for c in sig]
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
