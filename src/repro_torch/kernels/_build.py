"""Build the port's CUDA sources on first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain
``extern "C"`` interface, built by one ``nvcc`` call::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o .kernel_build/<name>-<hash>.so \\
         csrc/<name>.cu

into ``.kernel_build/`` beside the package (listed in ``.gitignore``),
keyed by a hash of the source, the shared headers and the flags: an edited
source rebuilds, an unchanged one loads the cached library.  ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them together.
A failed ``nvcc`` raises with the compiler's output.

Every launcher returns ``cudaGetLastError()``; ``launch`` raises if that is
not 0, and it is the one place that counts a kernel's launches.  Nothing is
built or loaded at import: this module is imported where there is no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600


@dataclass
class Built:
    """One built (or cached) kernel library."""

    name: str
    path: Path
    seconds: float          # nvcc wall time; 0.0 when loaded from the cache
    log: str                # nvcc's output: ptxas registers/shared/spills
    lib: ctypes.CDLL


_LIBS: Dict[str, Built] = {}
_FUNCS: Dict[tuple, object] = {}
_LAUNCHES: Dict[str, int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin): the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = ()) -> Dict[str, Built]:
    """Build (or load from the cache) the named kernel libraries, all
    sources by default; one ``nvcc`` per missing library, all started
    together."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    missing = []
    for name in names:
        if name in _LIBS:
            continue
        path = _lib_path(name)
        if path.exists():
            log = path.with_suffix(".log")
            _LIBS[name] = Built(name, path, 0.0,
                                log.read_text() if log.exists() else "",
                                ctypes.CDLL(str(path)))
        else:
            missing.append((name, path))
    if not missing:
        return {n: _LIBS[n] for n in names}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in missing:
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (path, tmp, t0, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or not tmp.exists():
            failures.append(f"nvcc failed for csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{out}")
            continue
        path.with_suffix(".log").write_text(out)
        os.replace(tmp, path)
        _LIBS[name] = Built(name, path, seconds, out, ctypes.CDLL(str(path)))
    if failures:
        raise RuntimeError("\n".join(failures))
    return {n: _LIBS[n] for n in names}


def function(name: str, symbol: str, argtypes: Sequence):
    """The ctypes launcher ``symbol`` of library ``name``, with its
    argument types set (``c_void_p`` for pointers and the stream), so no
    pointer is cut to a 32-bit int."""
    key = (name, symbol)
    if key not in _FUNCS:
        fn = getattr(build_all([name])[name].lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return _FUNCS[key]


def launch(kernel: str, fn, *args) -> None:
    """Call a launcher, raise on a nonzero ``cudaError_t`` and count the
    launch under ``kernel``."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel!r} failed to launch: "
                           f"cudaError_t {err}")
    _LAUNCHES[kernel] = _LAUNCHES.get(kernel, 0) + 1


def launch_count(kernel: str) -> int:
    return _LAUNCHES.get(kernel, 0)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
