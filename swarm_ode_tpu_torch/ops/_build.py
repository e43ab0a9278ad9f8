"""Build the CUDA sources under `csrc/` into one shared library, bind it with
ctypes.

The kernels have a plain C interface (no PyTorch headers), so `nvcc` compiles
them in seconds. The library is built at first use into
`swarm_ode_tpu_torch/_build/`, named after a hash of the sources and flags, so
an edited source builds anew and an unchanged one is reused. Nothing here runs
at import time: the CPU path never builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C entry points and their argument lists: pointers and the stream as
# c_void_p, sizes as c_int. Every entry point returns a cudaError_t.
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "swarm_bitpack_query": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "swarm_bfs_query": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "swarm_bfs_query_smem_bytes": (_I,),
}

_library = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> pathlib.Path:
    """Compile csrc/*.cu into _build/libswarm_kernels_<hash>.so unless it is
    there already; the compiler's report (registers, spills) goes beside it
    as a .log file. Returns the library's path."""
    out = BUILD_DIR / f"libswarm_kernels_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), *cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} failed with CUDA error {err}")
