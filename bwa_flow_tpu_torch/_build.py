"""Build and load the package's native code: the hand-written CUDA
kernels, and the host libraries of the native route.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher. At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the root of the checkout, named by a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags, and loaded with
``ctypes``. A changed source therefore builds anew, and an unchanged one
loads from the previous build. nvcc's output (with ``-Xptxas -v``: each
kernel's registers, shared memory and spills) is kept beside the library
and returned by ``build_log``.

Each ``csrc/host/<name>.cpp`` (``_chain``, ``_region``, ``_wave``,
``_native``, ``_markdup``, ``_bam``, ``_fastq``) is a CPython extension.
At first use it is compiled with the system ``c++`` into ``build/host/``,
named by a hash of the source, the ``csrc/host/*.h`` headers it includes,
its flags (``_native``, ``_bam`` and ``_fastq`` take ``-pthread``;
``_bam`` and ``_fastq`` link zlib)
and the interpreter's include directory, under a file lock (one build
for every process of the checkout), and loaded as
``bwa_flow_tpu_torch.<name>``.

There is no fallback: a missing ``nvcc``, ``c++``, ``Python.h`` or
``zlib.h``, or a failed build, raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
HOST_SRC = CSRC / "host"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
# the CUDA sources (csrc/<name>.cu): both ksw_extend2 kernels, the four
# kernels of the seed program's loops and the LF walk of SA lookup
KERNELS = ("ksw_extend", "ksw_extend16", "seed_p1p3", "seed_fwd", "seed_bwd",
           "seed_cohort", "sa_walk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# setup.py's flags for the JAX package's copies of these extensions, plus
# what a shared CPython extension needs
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
HOST_LIBS = ("_chain", "_region", "_wave", "_native", "_markdup", "_bam",
             "_fastq")
# setup.py's per-extension flags, after the source (libraries link there);
# `_fastq`, the port's own, takes `_bam`'s
HOST_LIB_FLAGS = {"_native": ("-pthread",), "_bam": ("-pthread", "-lz"),
                  "_fastq": ("-pthread", "-lz")}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_HOST_MODS: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler (CUDA_HOME's, else the one on PATH)."""
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "bwa_flow_tpu_torch need the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output for the current build of csrc/<name>.cu ("" before
    the first build)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _start(name: str):
    """Start one nvcc for csrc/<name>.cu; None when already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)   # atomic: concurrent builders never see halves


def build_all(names) -> None:
    """Compile every named source not built yet, one nvcc each, all
    started together."""
    jobs = [(n, _start(n)) for n in names]
    for n, job in jobs:
        _finish(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------------------
# host libraries (CPython extensions)

def cxx() -> str:
    """Path of the system C++ compiler."""
    found = shutil.which("c++")
    if not found:
        raise RuntimeError("c++ not found: the native route of "
                           "bwa_flow_tpu_torch builds its host libraries "
                           "with the system C++ compiler")
    return found


def python_include() -> str:
    """The interpreter's include directory; raises without Python.h."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.isfile(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"Python.h not found in {inc}: the native route "
                           "of bwa_flow_tpu_torch needs the interpreter's "
                           "development headers")
    return inc


def host_headers(name: str) -> list[Path]:
    """The csrc/host headers csrc/host/<name>.cpp includes, directly or
    through another header, in the order first seen."""
    seen: list[Path] = []
    todo = [HOST_SRC / f"{name}.cpp"]
    while todo:
        for inc in _INCLUDE.findall(todo.pop(0).read_bytes()):
            p = HOST_SRC / inc.decode()
            if p.is_file() and p not in seen:
                seen.append(p)
                todo.append(p)
    return seen


def host_lib_path(name: str) -> Path:
    src = (HOST_SRC / f"{name}.cpp").read_bytes()
    src += b"".join(p.read_bytes() for p in host_headers(name))
    flags = HOST_FLAGS + HOST_LIB_FLAGS.get(name, ())
    key = src + " ".join(flags).encode() + python_include().encode()
    h = hashlib.sha256(key).hexdigest()
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return HOST_BUILD_DIR / f"{name}-{h[:16]}{suffix}"


def _host_start(name: str):
    """Take csrc/host/<name>.cpp's build lock and start its compiler;
    returns the job, or None (lock released) when it is built already.
    Another process building the same library holds the lock until its
    build is installed."""
    out = host_lib_path(name)
    if out.exists():
        return None
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lock = open(HOST_BUILD_DIR / f".{name}.lock", "w")
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            lock.close()
            return None
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [cxx(), *HOST_FLAGS, f"-I{python_include()}", "-o", str(tmp),
               str(HOST_SRC / f"{name}.cpp"), *HOST_LIB_FLAGS.get(name, ())]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except BaseException:
        lock.close()
        raise
    return proc, tmp, out, lock


def _host_finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out, lock = job
    try:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"c++ failed for csrc/host/{name}.cpp "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)   # atomic: concurrent loaders never see halves
    finally:
        lock.close()           # releases the build lock


def _build_host(names) -> dict:
    """Compile every named host library not built yet, one c++ each, all
    started together (locks taken in name order), and wait for every one,
    so no compiler is left running and no lock held. Returns each failed
    build's error by name."""
    jobs, errs = [], {}
    try:
        for n in sorted(names):
            jobs.append((n, _host_start(n)))
    finally:
        for n, job in jobs:
            try:
                _host_finish(n, job)
            except Exception as e:  # noqa: BLE001 - returned to raise
                errs[n] = e
    return errs


def build_host(names=HOST_LIBS) -> None:
    """Build every named host library not built yet, all at once; raises
    the first failure."""
    errs = _build_host(names)
    if errs:
        raise next(iter(errs.values()))


def host_module(name: str):
    """The host library csrc/host/<name>.cpp as the extension module
    bwa_flow_tpu_torch.<name>; the first call builds every host library
    not built yet, all at once, and raises if this one's build failed
    (another's failure raises when that one is asked for)."""
    mod = _HOST_MODS.get(name)
    if mod is not None:
        return mod
    with _LOCK:
        mod = _HOST_MODS.get(name)
        if mod is None:
            err = _build_host(HOST_LIBS).get(name)
            if err is not None:
                raise err
            full = f"{__package__}.{name}"
            path = str(host_lib_path(name))
            loader = importlib.machinery.ExtensionFileLoader(full, path)
            spec = importlib.util.spec_from_file_location(full, path,
                                                          loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            sys.modules[full] = mod
            _HOST_MODS[name] = mod
    return mod
