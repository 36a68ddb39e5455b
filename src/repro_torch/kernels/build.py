"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/`` at the repository
root, at first use; the wrappers call it through ``ctypes`` on PyTorch's
current stream. A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a stale build is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all at once.

No fast-math flag: RoPE and the softmax rely on full-precision ``sinf``,
``cosf`` and ``expf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("binary_matmul", "paged_attention", "megakernel",
           "packed_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
        if cand.exists():
            path = str(cand)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every library in `names` that is not built yet, one
    ``nvcc`` per source started together; returns the wall seconds.
    Raises with the compiler's output if any build fails. The compiler's
    register and shared-memory report goes to ``<library>.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, signatures: Optional[Dict[str, list]] = None
            ) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built on first use.
    ``signatures`` maps C function names to their ctypes ``argtypes``
    (each returns a C int); they are set once, when the library loads."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in (signatures or {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


_tickets: Dict[tuple, object] = {}


def tickets(kernel: str, device, n: int):
    """A zeroed int32 buffer of at least `n` counters for `kernel` on
    `device`, kept across launches: a kernel that counts arrivals on a
    ticket resets it to 0 before it ends, and a flag holds the number of
    the launch that set it, so one zeroing serves every launch on the
    device's stream. Grown (zeroed anew) when too small."""
    import torch
    key = (kernel, str(device))
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


# ---------------------------------------------------------------------------
# binding helpers shared by the wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    """The C interface's dtype code for an activation tensor."""
    name = str(t.dtype).removeprefix("torch.")
    if name not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16 "
                        f"activations, got {t.dtype}")
    return _DTYPE_CODES[name]


def check_cuda(kernel: str, dtype=None, **tensors) -> None:
    """Raise unless every tensor lies on the same CUDA device, is
    contiguous and (for the named ones) has `dtype`."""
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, "
                            f"got {t.dtype}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def current_stream(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(kernel: str, err: int) -> None:
    """Raise if the C function reported a CUDA error (a refused launch
    never runs, and synchronising would not report it)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")
