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

The megakernel emitter (core/lowering/megakernel.py) writes CUDA C++ per
fused segment.  ``build_generated`` writes each such text to
``.kernel_build/gen/<hash>.cu``, keyed the same way, and builds it
with the same line plus ``-fmad=false`` (no f32 multiply and add may be
contracted into an FMA) and ``-I csrc`` (for ``mk_common.cuh``), several
texts in parallel.  Only sources in the repo and text the emitter wrote are
compiled.

Every launcher returns ``cudaGetLastError()``; ``launch`` raises if that is
not 0, and it is the one place that counts a kernel's launches.  Nothing is
built or loaded at import: this module is imported where there is no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / ".kernel_build"
GEN_DIR = BUILD_DIR / "gen"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GEN_FLAGS = NVCC_FLAGS + ("-fmad=false",)
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
_SHAPE_LAUNCHES: Dict[tuple, int] = {}


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


def _digest(flags: Sequence[str], source: bytes) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(source)
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    digest = _digest(NVCC_FLAGS, (CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"{name}-{digest}.so"


def _load(jobs) -> None:
    """Load or build (key, source, library, flags) jobs into ``_LIBS``:
    cached libraries load, one ``nvcc`` per missing one, all started
    together."""
    missing = []
    for key, src, path, flags in jobs:
        if key in _LIBS:
            continue
        if path.exists():
            log = path.with_suffix(".log")
            _LIBS[key] = Built(key, path, 0.0,
                               log.read_text() if log.exists() else "",
                               ctypes.CDLL(str(path)))
        else:
            missing.append((key, src, path, flags))
    if not missing:
        return
    nvcc = _nvcc()
    procs = {}
    for key, src, path, flags in missing:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *flags, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[key] = (src, path, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for key, (src, path, tmp, t0, proc) in procs.items():
        try:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or not tmp.exists():
            failures.append(f"nvcc failed for {src} "
                            f"(exit {proc.returncode}):\n{out}")
            continue
        path.with_suffix(".log").write_text(out)
        os.replace(tmp, path)
        _LIBS[key] = Built(key, path, seconds, out, ctypes.CDLL(str(path)))
    if failures:
        raise RuntimeError("\n".join(failures))


def build_all(names: Iterable[str] = ()) -> Dict[str, Built]:
    """Build (or load from the cache) the named kernel libraries, all
    sources by default; one ``nvcc`` per missing library, all started
    together."""
    names = list(names) or sorted(p.stem for p in CSRC.glob("*.cu"))
    _load([(name, CSRC / f"{name}.cu", _lib_path(name), NVCC_FLAGS)
           for name in names])
    return {n: _LIBS[n] for n in names}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Per entry function (mangled name) of a ``-Xptxas -v`` log: its
    registers, stack frame and spill bytes."""
    usage, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = usage.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return usage


def build_generated(sources: Dict[str, str]) -> Dict[str, Built]:
    """Build (or load from the cache) emitter-written CUDA sources, given
    as label -> text; one ``nvcc`` per missing library, all started
    together.  A library is keyed by its text's digest alone, so equal
    texts under other labels share one build.  Returns label -> Built."""
    keys, jobs = {}, []
    for label, text in sources.items():
        digest = _digest(GEN_FLAGS, text.encode())
        src = GEN_DIR / f"{digest}.cu"
        keys[label] = f"gen/{digest}"
        if keys[label] not in _LIBS and not src.with_suffix(".so").exists():
            GEN_DIR.mkdir(parents=True, exist_ok=True)
            src.write_text(text)
        jobs.append((keys[label], src, src.with_suffix(".so"), GEN_FLAGS))
    _load(jobs)
    return {label: _LIBS[key] for label, key in keys.items()}


def _bind(lib: ctypes.CDLL, symbol: str, argtypes: Sequence):
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def function(name: str, symbol: str, argtypes: Sequence):
    """The ctypes launcher ``symbol`` of library ``name``, with its
    argument types set (``c_void_p`` for pointers and the stream), so no
    pointer is cut to a 32-bit int."""
    key = (name, symbol)
    if key not in _FUNCS:
        _FUNCS[key] = _bind(build_all([name])[name].lib, symbol, argtypes)
    return _FUNCS[key]


def generated_function(name: str, text: str, symbol: str,
                       argtypes: Sequence):
    """The launcher ``symbol`` of the library built from emitter-written
    ``text`` (see ``function``)."""
    key = (name, text, symbol)
    if key not in _FUNCS:
        lib = build_generated({name: text})[name].lib
        _FUNCS[key] = _bind(lib, symbol, argtypes)
    return _FUNCS[key]


def launch(kernel: str, fn, *args, form: str = "", shape=None) -> None:
    """Call a launcher, raise on a nonzero ``cudaError_t`` and count the
    launch under ``kernel`` and, given a ``form``, under
    ``"<kernel>:<form>"`` too; given a ``shape`` (a tuple of the launch's
    sizes), under that form and shape as well (``shape_counts``)."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel!r}"
                           f"{f' ({form})' if form else ''} failed to "
                           f"launch: cudaError_t {err}")
    for key in (kernel, f"{kernel}:{form}") if form else (kernel,):
        _LAUNCHES[key] = _LAUNCHES.get(key, 0) + 1
    if shape is not None:
        key = (f"{kernel}:{form}", shape)
        _SHAPE_LAUNCHES[key] = _SHAPE_LAUNCHES.get(key, 0) + 1


def launch_count(kernel: str) -> int:
    return _LAUNCHES.get(kernel, 0)


def shape_counts(key: str) -> Dict[tuple, int]:
    """Launches under ``key`` (``"<kernel>:<form>"``) by shape."""
    return {shape: n for (k, shape), n in _SHAPE_LAUNCHES.items()
            if k == key}


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
    _SHAPE_LAUNCHES.clear()
