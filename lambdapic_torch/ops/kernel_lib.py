"""Build and load the port's CUDA kernels.

Each source in ``lambdapic_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded
with ctypes. The build runs at first use, one ``nvcc`` per source, all
started together, into ``lambdapic_torch/_build/`` (listed in
.gitignore); a library's file name carries a hash of its sources and
flags, so an edited source is rebuilt. Nothing here runs at import.

A failed build raises; there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"

# library name -> .cu source; every library also depends on the headers
# (csrc/*.cuh)
SOURCES = {"fields": "fields.cu", "cellstep": "cellstep.cu",
           "fold": "fold.cu", "fields3d": "fields3d.cu",
           "cellstep3d": "cellstep3d.cu", "fold3d": "fold3d.cu",
           "push2d": "push2d.cu", "deposit2d": "deposit2d.cu",
           "migrate": "migrate.cu", "sortcells": "sortcells.cu",
           "push3d": "push3d.cu", "deposit3d": "deposit3d.cu",
           "gather_tiled": "gather_tiled.cu",
           "deposit_tiled": "deposit_tiled.cu"}
# --fmad=false: no multiply-add contraction, so each kernel rounds as its
# plain PyTorch version does, op for op
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}


def nvcc_path() -> str:
    cand = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "nvcc"), shutil.which("nvcc")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every missing library, one nvcc process per source, all
    running at once. Returns name -> library path. Raises with the
    compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs: List[tuple] = []
    out = {}
    for name in names:
        so = _target(name)
        out[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, so, tmp, p in procs:
        log, _ = p.communicate()
        so.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def build_log(name: str) -> str:
    """The compiler output of the library's build (ptxas register and
    spill lines included)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def call(name: str, fn: str, ptrs: Sequence, ints: Sequence[int],
         reals: Sequence[float], device: torch.device) -> None:
    """Call ``fn(void** ptrs, const long long* ints, const double* reals,
    void* stream)`` of library ``name`` on the current stream of
    ``device``; raise if the C function reports a CUDA error."""
    f = _FNS.get((name, fn))
    if f is None:
        f = getattr(library(name), fn)
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FNS[(name, fn)] = f
    p = (ctypes.c_void_p * len(ptrs))(
        *[None if t is None else (t if isinstance(t, int) else t.data_ptr())
          for t in ptrs])
    i = (ctypes.c_longlong * len(ints))(*[int(v) for v in ints])
    r = (ctypes.c_double * len(reals))(*[float(v) for v in reals])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = f(ctypes.cast(p, ctypes.c_void_p), ctypes.cast(i, ctypes.c_void_p),
            ctypes.cast(r, ctypes.c_void_p), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}.{fn} failed: CUDA error {err}")


def check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    """Validate a kernel operand before its pointer is passed."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
