"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root (a directory ``.gitignore``
lists) and loaded with :mod:`ctypes`.  The library's file name carries a
hash of the source, of every header under ``csrc/`` (``*.cuh``, which the
sources include) and of the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  Nothing is compiled at import time.

:data:`LAUNCHES` counts kernel launches per kernel; each wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
path went through the kernels.  A kernel whose source holds more than one
design counts each launch a second time in :data:`VARIANT_LAUNCHES`,
under the design it went to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

#: kernel name -> launches so far (reset by callers that count one run)
LAUNCHES: dict[str, int] = {"bsmm_pairs": 0, "batched_gemm": 0,
                            "block_attention": 0, "block_attention_bwd": 0}

#: kernel name -> design -> launches so far, for kernels with several designs
VARIANT_LAUNCHES: dict[str, dict[str, int]] = {
    "bsmm_pairs": {"fma": 0, "mma": 0},
    "block_attention": {"fma": 0, "wgmma": 0},
    "block_attention_bwd": {"fma": 0, "wgmma": 0}}

#: kernels of this package, each one ``csrc/<name>.cu``
KERNELS = tuple(LAUNCHES)


def reset_launches() -> None:
    """Set every launch count, per kernel and per design, to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for per in VARIANT_LAUNCHES.values():
        for k in per:
            per[k] = 0

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def source_of(name: str) -> pathlib.Path:
    """The CUDA source of kernel ``name``."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; pick one of {KERNELS}")
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME)")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(source_of(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that has no library yet, all at once.

    One ``nvcc`` per source, started together.  Returns each built
    kernel's compiler output (``-Xptxas -v``: registers, shared memory,
    spills).  Raises if a compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source_of(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
