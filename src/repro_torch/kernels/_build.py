"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library's file name carries a hash of its source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source is rebuilt
and never served a stale library. :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for every one of them.

:func:`bind` and :func:`launch` are the wrappers' lean launch path: a C
function is looked up and typed once, and a launch reads the current
stream once and switches the current device only when the tensors lie on
another one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("entropy_judge", "fused_aggregate", "flash_attention",
           "decode_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


# the kernel wrappers that count their launches (:func:`counted`)
COUNTED: list = []


def counted(fn):
    """Mark ``fn`` as a kernel wrapper that counts its launches in
    ``fn.launches``: it adds to the count where it launches its kernel and
    nowhere else. :data:`COUNTED` lists every such wrapper, so a reader of
    the counts (a captured program, the chip smoke) needs no list of its
    own."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def refuse_autograd(what: str, *tensors) -> None:
    """Raises if autograd would record through a kernel wrapper that has
    no backward: grad mode on and any of ``tensors`` requiring grad. The
    wrapper's output comes from a C call that autograd cannot see, so
    going on would cut every gradient through it without a word. Checked
    on every device, so the CPU (where the wrapper would take its plain
    version) refuses as the card does."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the cuda route has no backward (the kernel writes "
            "its output outside autograd, and the JAX package's Pallas "
            "kernel defines no VJP either); build the model with "
            "kernels='torch' to train, or call it under torch.no_grad()")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels build only where the CUDA toolkit is "
            "installed")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.

    Returns, for each library built by this call, the seconds its
    ``nvcc`` took and its output (``-Xptxas -v`` lists registers, shared
    memory and spills). Raises with the compiler's output if any build
    fails; no process outlives the call.
    """
    missing = [n for n in names if not library_path(n).exists()]
    if not missing:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in missing:
            out = library_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        built = {}
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            built[name] = {"seconds": time.perf_counter() - t0, "log": log}
        return built
    finally:
        for proc, tmp, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


@functools.cache
def bind(name: str, symbol: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu``, typed with
    ``argtypes`` and an ``int`` result (a CUDA error code); looked up once."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def current_stream(index: int) -> int:
    """The ``cudaStream_t`` of device ``index``'s current stream, read as
    PyTorch's own generated launchers read it (the public
    ``torch.cuda.current_stream`` builds a Stream object first)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch(fn, index: int, *args) -> None:
    """Calls ``fn(*args, stream)`` with the current stream of CUDA device
    ``index``, made the current device only if it is not; raises if the C
    function returns a CUDA error."""
    if index == torch._C._cuda_getDevice():   # the current device
        err = fn(*args, current_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, current_stream(index))
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
