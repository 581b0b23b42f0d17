"""Build and load the port's CUDA kernels.

Every ``lexls_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source and all started together, and the
objects are linked into one shared library with a plain C interface, at
first use: into ``build/lexls_tpu_torch/`` at the root of a checkout (a
``pyproject.toml`` beside the package), and for an installed package into
``$XDG_CACHE_HOME/lexls_tpu_torch`` (``~/.cache/lexls_tpu_torch`` when that
variable is unset), since site-packages is no place to write.  The sources
ship with the package (``package-data`` in ``pyproject.toml``).  The
library is named after a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded.  It is loaded with
``ctypes``: pointers and the CUDA stream go in as ``c_void_p``, and every
C entry returns ``cudaGetLastError()`` so that a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

from .. import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def _build_dir() -> Path:
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "lexls_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "lexls_tpu_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output (ptxas register and spill counts)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=None)
def build() -> BuildInfo:
    """Compile the kernels unless a library of the same sources exists."""
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA source (*.cu) in {CSRC}: the package was installed "
                           "without its csrc/ (package-data in pyproject.toml)")
    digest = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    path = BUILD_DIR / f"liblexls_kernels-{digest.hexdigest()[:12]}.so"
    log_path = path.with_suffix(".log")
    if path.exists():
        return BuildInfo(path, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objects = [tmp.with_name(f"{tmp.name}.{f.stem}.o") for f in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(f)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for f, o in zip(sources, objects)]
    outputs = [proc.communicate()[0] for proc in procs]  # waits for every compiler
    log = "".join(outputs)
    try:
        for proc, f, out in zip(procs, sources, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {f.name}:\n{out}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
    finally:
        for o in objects:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, path)
    return BuildInfo(path, seconds, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build().path))


@functools.lru_cache(maxsize=None)
def bind(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry ``name`` with its argument types declared (once per
    entry: later calls return the bound function)."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def current_stream(device) -> int:
    """The raw handle of torch's current CUDA stream on ``device`` (through
    torch's own fast accessor where this torch has it: a launch's host time
    is part of its cost)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def launch(fn, name: str, args) -> None:
    """Call the bound C entry ``fn`` (which launches its kernel on the
    stream it is given) with the arguments that ``args()`` builds, raise if
    the launch was refused.  With tracing on (:mod:`lexls_tpu_torch.tracing`)
    building the arguments (pointers, ctypes arrays) and the call are the
    span ``lexls.launch`` and count in ``launches.<name>``; under
    ``recording(device_events=True)`` CUDA events bracket the call too, which
    time the kernel alone on the card."""
    if not tracing.enabled():
        check(fn(*args()), name)
        return
    with tracing.span("lexls.launch"):
        tracing.count(f"launches.{name}")
        argv = args()
        with tracing.device_interval(name):
            err = fn(*argv)
        check(err, name)
