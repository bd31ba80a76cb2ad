"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries build at first use
into ``build/kernels/<hash>/`` at the root of the checkout, keyed on a hash
of the sources and flags; :func:`build_all` starts one ``nvcc`` per source,
all together, so ``python3 chip_smoke.py`` builds everything itself.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.kernels import ref

_CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _ROOT / "build" / "kernels"
SOURCES = ("conv1d", "matmul", "banded_align", "fused_stream",
           "flash_attention", "ssd_scan")
SMEM_LIMIT = 232_448    # bytes of shared memory an H100 block may use
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# ptxas register/shared-memory report of each build, by source name
PTXAS_LOG: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / _digest() / f"lib{name}.so"


def build_all(names=SOURCES) -> list[str]:
    """Compile every missing library, one ``nvcc`` per source started
    together; returns the names that were compiled (not cached)."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return []
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        out = _lib_path(n)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        PTXAS_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return todo


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each kernel in one ``nvcc -Xptxas -v``
    report, by kernel (``name<template args>``), plus its warnings."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = _demangle(m.group(1))
            out[cur] = {}
        elif cur is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[cur].update(spill_stores=int(st), spill_loads=int(ld))
        elif cur is not None and "Used" in line and "registers" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line).group(1))
        if "warning" in line.lower():
            out.setdefault("warnings", []).append(line.strip())
    return out


def _demangle(name: str) -> str:
    """``_Z22flash_attention_kernelILi128EEv...`` -> ``flash_attention_
    kernel<128>``: the name and its integer and bool template arguments."""
    m = re.match(r"_Z(\d+)", name)
    if not m:
        return name
    start = m.end()
    base = name[start:start + int(m.group(1))]
    rest = name[start + int(m.group(1)):]
    args = re.match(r"I((?:L[ib]-?\d+E)+)E", rest)
    if args:
        vals = re.findall(r"L([ib])(-?\d+)E", args.group(1))
        base += "<" + ", ".join(("true" if v == "1" else "false")
                                if t == "b" else v for t, v in vals) + ">"
    return base


def check_tensor(what: str, t, dtype, shape=None, device=None) -> None:
    """Validate one kernel operand: CUDA, dtype, contiguity, shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def wants_grad(*tensors) -> bool:
    """Whether autograd is on and an operand requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd is on and an operand requires grad: the kernel
    writes through a raw pointer, so its output would carry no
    ``grad_fn`` and a training step would drop the gradient without a
    word.  JAX has no backward kernel either (no ``custom_vjp`` in its
    package).  The float kernels of the training paths (fp32 ``conv1d``
    and ``matmul``, ``matmul_bf16``, ``flash_attention``, ``ssd_scan``)
    carry the gradient of their plain versions (:func:`with_plain_grad`);
    the int8 and integer kernels and the fused tick refuse.  Called before
    any other check, so nothing launches."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{what}: an operand requires grad, but this kernel has no "
            "backward on the card; call it under torch.no_grad() or detach "
            "the operands (the float kernels of the training paths carry "
            "the plain version's gradient)")


# the profiler span of PlainGrad's backward (a plain version's re-run and
# its gradient), which a trace reads as the share of a step it takes
PLAIN_BACKWARD = "PlainGrad.plain_backward"


class PlainGrad(torch.autograd.Function):
    """A kernel's forward with its plain version's backward:
    ``PlainGrad.apply(kernel, plain, *inputs)``, where ``kernel`` and
    ``plain`` compute the same function of ``inputs`` (None entries pass
    through, with a None gradient).

    JAX has no backward kernel (its package has no ``custom_vjp``): its
    training differentiates the jnp reference.  So the forward launches
    the hand kernel and the backward re-runs ``plain`` on the saved inputs
    and takes its gradient, with TF32 off (``ref.full_fp32``) so that it
    is fp32 as on the CPU; only the inputs that need a gradient are
    differentiated.  The output is the kernel's own tensor, so it carries
    this function's ``grad_fn``."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.plain = plain
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad_out):
        # under torch.utils.checkpoint the first unpack recomputes the
        # block; the span after it is the plain backward alone
        saved = ctx.saved_tensors
        with torch.profiler.record_function(PLAIN_BACKWARD):
            ref.full_fp32()
            need = ctx.needs_input_grad[2:]
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_(n)
                          for t, n in zip(saved, need)]
                out = ctx.plain(*leaves)
                live = [t for t in leaves
                        if t is not None and t.requires_grad]
                got = iter(torch.autograd.grad(out, live, grad_out))
            return (None, None, *(next(got) if t is not None
                                  and t.requires_grad else None
                                  for t in leaves))


def with_plain_grad(kernel, plain, *inputs):
    """``kernel(*inputs)``; where autograd is on and an input requires
    grad, the same launch inside :class:`PlainGrad`, so the output carries
    ``plain``'s gradient.  Inside ``PlainGrad.forward`` autograd is off, so
    a wrapper that delegates to another (``flash_attention`` to
    ``tf32x3``) wraps once."""
    if wants_grad(*inputs):
        return PlainGrad.apply(kernel, plain, *inputs)
    return kernel(*inputs)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library for ``csrc/<name>.cu`` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all((name,))
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argument types declared (``c_void_p`` for
    every pointer and the stream, so no pointer is cut to 32 bits).  A
    library already loaded is read without the lock."""
    fn = getattr(_LIBS.get(lib_name) or library(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def launch(lib_name: str, fn_name: str, argtypes, *args) -> None:
    """Call a C launch entry point and raise if it reported a CUDA error
    (a refused launch never runs, and a later synchronize would not say
    so)."""
    rc = function(lib_name, fn_name, argtypes)(*args)
    if rc != 0:
        err = library(lib_name).kernel_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({err(rc).decode(errors='replace')})")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a CUDA tensor's, so
    indexed) as a C pointer value, read by PyTorch's raw accessor: 0.15 us
    a call on the H100 host, where ``torch.cuda.current_stream`` builds a
    Stream object in 8-10 us, and every kernel call asks once.  A CPU-only
    build of PyTorch lacks the accessor, so it is looked up here."""
    return torch._C._cuda_getCurrentRawStream(device.index)
