"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded through ``ctypes``. Builds happen at first use,
into ``<package>/build/`` (git-ignored), one ``nvcc`` per source, all started
together; a library is named by a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is reused. Building and loading hold
one lock, so threads that reach a library's first use together (the trials
of a concurrent sweep) compile it once and share one handle. Nothing here
runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
# -fmad=false keeps nvcc from contracting a*b + c into one FMA: the kernels
# pin their rounding with __fmul_rn/__fadd_rn too, so that they agree with
# their plain PyTorch versions bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("raster_exact", "raster_fast", "raster_prim", "raster_vec")

_loaded: dict[str, ctypes.CDLL] = {}
# held by build and load (re-entered by load's build), and by use_library
_lock = threading.RLock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the kernels")
    return path


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, in parallel.
    → {name: ptxas report} for the libraries compiled now."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(out.stem + ".partial.so")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
        reports, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            tmp.replace(out)
            out.with_suffix(".log").write_text(log)
            reports[name] = log
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, built on first use."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def build_variant(src: Path, flags=()) -> Path:
    """Compile ``src``, a variant of one of the sources with the same C entry
    points, with the package's flags plus ``flags`` into ``BUILD_DIR/
    variants/`` (named by a hash of source and flags; reused when built). →
    the library, for ``use_library``."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join((*NVCC_FLAGS, *flags)).encode())
    out = BUILD_DIR / "variants" / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return out


def use_library(name: str, path: Path) -> None:
    """From now on, the wrappers of library ``name`` call the library at
    ``path`` (a ``build_variant`` of its source)."""
    with _lock:
        _loaded[name] = ctypes.CDLL(str(path))


def entry_point(name: str, symbol: str, argtypes: list):
    """C function ``symbol`` of library ``name``, returning an int error
    code (``cudaGetLastError()`` after the launch)."""
    fn = getattr(load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``/``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)``, a kernel's C launch entry point, with ``device``
    (the tensors') the current card and its current stream last. The CUDA
    runtime launches on the current card, which on a machine with several
    need not be the tensors' (a rank whose current card is another one)."""
    with torch.cuda.device(device):
        return fn(*args, stream_ptr(device))


def raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError {err}")
