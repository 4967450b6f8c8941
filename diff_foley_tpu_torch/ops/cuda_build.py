"""Build and load the hand-written CUDA kernels of ``diff_foley_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Nothing here runs at import: a library is built at its first
use, or for all sources at once (in parallel, one ``nvcc`` per source) by
:func:`build`. Libraries are named by a hash of their sources and flags,
so an edited source is rebuilt and never mixed with a stale build.

The build directory is ``build/kernels`` beside the package (listed in
``.gitignore``), or ``$DFT_KERNEL_BUILD_DIR``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("attention_fwd", "attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("DFT_KERNEL_BUILD_DIR")
    return Path(env) if env else CSRC.parents[1] / "build" / "kernels"


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile the named sources that have no current library, all ``nvcc``
    processes started together. Returns {name: {"seconds", "ptxas"}};
    raises with the compiler's output when one fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path)
    report = {}
    try:
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, path)
            report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
