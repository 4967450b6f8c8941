"""Profiling and cost analysis (``diff_foley_tpu/utils/profiling.py``).

Parameter counts, a FLOP/byte/transcendental count of one call, wall-clock
timing that waits for the card (``torch.cuda.synchronize`` after the
timed calls; a CPU call needs no wait), and a ``torch.profiler`` trace
written as a Chrome trace.

``cost_analysis`` counts at PyTorch's dispatch level, with these rules:

- **flops**: 2·MAC of every matrix product and convolution, forward and
  backward (``torch.utils.flop_counter``'s formulas); elementwise work
  counts none, as in a model FLOP count;
- **bytes_accessed**: each operator's tensor operands read once and its
  results written once; views and allocations move none; of a batch norm
  or a max pooling only the first result counts, and a batch norm's
  backward reads its first five operands (what else they return or take,
  saved statistics, reserve space, indices, is sized by the backend);
- **transcendentals**: one per result element of exp, log, sigmoid, tanh,
  erf, the trigonometric functions, sqrt, rsqrt, pow, SiLU, GELU and
  softmax (and their ``*1p``/``m1``/base-2 and -10 forms and backward
  passes of SiLU and GELU);
- **the kernels**: a kernel call (attention, GroupNorm) counts its work
  by formula at its wrapper (``ops/kernel_cost.py``) and hides what runs
  inside it: the kernel on the card, the plain version on the CPU or on
  ``meta``. The count is the same on every device.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..ops import kernel_cost

_aten = torch.ops.aten
_TRANSCENDENTAL = {
    _aten.exp, _aten.exp2, _aten.expm1, _aten.log, _aten.log2, _aten.log10,
    _aten.log1p, _aten.sigmoid, _aten.tanh, _aten.erf, _aten.erfc,
    _aten.erfinv, _aten.sin, _aten.cos, _aten.tan, _aten.sqrt, _aten.rsqrt,
    _aten.pow, _aten.silu, _aten.silu_backward, _aten.gelu,
    _aten.gelu_backward, _aten._softmax, _aten._log_softmax,
    _aten.logsumexp}
# no bytes moved: allocations and factories with no tensor operand
_ALLOCATING = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided}
# results past the first are bookkeeping whose size the backend picks
# (batch norm's saved statistics, cuDNN's reserve space, pooling's indices):
# only the operands and the first result count
_FIRST_RESULT = {getattr(_aten, name) for name in (
    "native_batch_norm", "cudnn_batch_norm", "miopen_batch_norm",
    "_native_batch_norm_legit", "_native_batch_norm_legit_no_training",
    "max_pool1d_with_indices", "max_pool2d_with_indices",
    "max_pool3d_with_indices", "adaptive_max_pool2d",
    "adaptive_max_pool3d") if hasattr(_aten, name)}
# a batch norm's backward reads the output gradient, the input, the scale
# and the running statistics; its saved statistics are the backend's
_BATCH_NORM_BACKWARD = {getattr(_aten, name) for name in (
    "native_batch_norm_backward", "cudnn_batch_norm_backward",
    "miopen_batch_norm_backward") if hasattr(_aten, name)}


def count_params(tree, verbose: bool = False, name: str = "model") -> int:
    """Elements of a model's weights (util.py:251-255): a module's
    parameters and BatchNorm running statistics (the JAX package's params
    and batch_stats leaves), or the tensors of a mapping or sequence."""
    if isinstance(tree, torch.nn.Module):
        leaves = list(tree.parameters()) + [
            b for n, b in tree.named_buffers()
            if n.endswith(("running_mean", "running_var"))]
    else:
        leaves = [t for t in tree_leaves(tree) if hasattr(t, "numel")]
    total = sum(t.numel() for t in leaves)
    if verbose:
        print(f"{name} has {total * 1e-6:.2f} M params.")
    return total


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class CostCounter(TorchDispatchMode):
    """Counts flops, bytes and transcendentals of the operators it sees
    (the module docstring's rules); a kernel wrapper adds its formula's
    work through ``add`` and raises ``hidden`` while it runs."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = self.transcendentals = 0
        self.hidden = 0

    def add(self, flops: int, nbytes: int, transcendentals: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.transcendentals += transcendentals

    def __enter__(self):
        kernel_cost.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_cost.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.hidden:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet not in _ALLOCATING and not _is_view(func):
            operands, results = _tensors((args, kwargs)), _tensors(out)
            if packet in _FIRST_RESULT:
                results = results[:1]
            elif packet in _BATCH_NORM_BACKWARD:
                operands = operands[:5]
            # a tensor passed twice is read once; counted by identity, not
            # address, so that meta tensors count as the device's do
            seen, moved = set(), 0
            for t in operands + results:
                if id(t) not in seen:
                    seen.add(id(t))
                    moved += t.numel() * t.element_size()
            self.bytes += moved
        if packet in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in _tensors(out))
        return out


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{"flops", "bytes_accessed", "transcendentals"} of one call of
    ``fn(*args, **kwargs)`` (run once, gradients included where fn takes
    them), by the module docstring's rules. Tensors on ``meta`` count
    without computing."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.flops),
            "bytes_accessed": float(counter.bytes),
            "transcendentals": float(counter.transcendentals)}


def _wait(tree) -> None:
    """Wait for the card when any tensor of ``tree`` lies on one."""
    devices = {t.device for t in _tensors(tree) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def timed_call(fn: Callable, *args, iters: int = 10, warmup: int = 1):
    """Wall-clock of ``iters`` back-to-back calls, after ``warmup`` calls,
    waiting for the card before and after. → (seconds per call, last
    output)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait((args, out))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait((args, out))
    return (time.perf_counter() - t0) / iters, out


def timed_chained(step_fn: Callable, x0, iters: int = 5, chain: int = 10):
    """Median over ``iters`` trials of the per-call seconds of ``chain``
    dependent calls x → step_fn(x), with one wait at each trial's end."""
    _wait(step_fn(x0))
    times = []
    for _ in range(iters):
        x = x0
        t0 = time.perf_counter()
        for _ in range(chain):
            x = step_fn(x)
        _wait(x)
        times.append((time.perf_counter() - t0) / chain)
    return float(statistics.median(times))


def timed_dispatch(fn: Callable, *args, iters: int = 5):
    """Median wall-seconds of one call and the wait for its result: the
    launch latency that ``timed_chained`` amortises."""
    _wait((args, fn(*args)))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _wait(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


def flops_per_second(fn: Callable, *args, iters: int = 10) -> Dict[str, float]:
    """``cost_analysis`` with the seconds per call and TFLOP/s."""
    costs = cost_analysis(fn, *args)
    sec, _ = timed_call(fn, *args, iters=iters)
    return {**costs, "seconds_per_call": sec,
            "tflops_per_second": costs["flops"] / sec / 1e12}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the CPU, and the card when there is
    one); on exit its Chrome trace is written into ``log_dir``
    (``trace_<pid>_<ns>.json``, viewable in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
