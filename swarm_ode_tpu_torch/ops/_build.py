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

from swarm_ode_tpu_torch.utils.profiling import setup_span

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# C entry points and their argument lists: pointers and the stream as
# c_void_p, sizes as c_int (c_longlong for an edge count). Every entry point
# except the *_smem_bytes queries returns a cudaError_t.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "swarm_bfs_query": (_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "swarm_bfs_query_smem_bytes": (_I, _I),
    "swarm_bfs_dist": (_P, _P, _P, _I, _I, _I, _I, _P),
    "swarm_bfs_dist_smem_bytes": (_I, _I),
    "swarm_segment_sum": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
}

_library = None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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
    there already: one nvcc per source, all started together, then one link.
    The compiler's report (registers, spills) goes beside the library as a
    .log file. Returns the library's path."""
    out = BUILD_DIR / f"libswarm_kernels_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in (p for p in sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    tmp = out.with_name(f"{tag}.so.tmp")
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout)
        if res.returncode != 0:
            failed.append(res.stdout)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), its first load
    under the set-up span `setup.kernel_library`."""
    global _library
    if _library is None:
        with setup_span("setup.kernel_library"):
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
