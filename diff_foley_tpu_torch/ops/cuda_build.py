"""Build and load the hand-written CUDA kernels of ``diff_foley_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Nothing here runs at import: a library is built at its first
use, or for all sources at once (in parallel, one ``nvcc`` per source) by
:func:`build`. Libraries are named by a hash of their sources and flags,
so an edited source is rebuilt and never mixed with a stale build.

The build directory is ``build/kernels`` beside the package (listed in
``.gitignore``), or ``$DFT_KERNEL_BUILD_DIR``.

The wrapper modules (``hopper_*.py``) call the C entries through
:func:`launch`, with the operands as :func:`ptr` and the stream as
:func:`stream`, and send CPU tensors to their plain versions by
:func:`on_cpu`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("attention_fwd", "attention_bwd", "attention_head_fwd",
           "attention_head_bwd", "groupnorm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: dict[str, ctypes.CDLL] = {}
# the sources this process compiled, in order (a warm-up reports them)
COMPILED: list[str] = []


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
            COMPILED.append(name)
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


# ---- calling a C entry -----------------------------------------------------

def on_cpu(what: str, *tensors) -> bool:
    """True when the tensors all lie on the CPU, False when all on CUDA
    devices; raises on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{what} operands must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(kinds)}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """The current stream of t's device, the last argument of every entry."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(name: str, fn: str, argtypes, *args, device) -> None:
    """Call the C entry ``fn`` of ``csrc/<name>.cu`` on ``device``; its
    argument types are set at the first call. Raises when it returns a
    cudaError."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = f(*args)
    if err:
        raise RuntimeError(f"{fn} launch failed: cudaError {err}")
