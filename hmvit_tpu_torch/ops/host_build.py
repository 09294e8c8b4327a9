"""Build and load the port's host C++ libraries (``native/*.cpp``): the
rotated-box clipper and NMS, and the pcd parser.

Each source compiles on first use with ``$CXX`` (else ``c++`` or
``g++``) and the flags of the JAX package's ``native/Makefile``, into
``_build/`` next to the package, under a name keyed by the hash of the
source, the compiler (its path and ``--version``) and the flags, so an
edited file or another compiler never loads a stale library.  A process
compiles into a temporary name and moves the result into place, so
processes that build at once (test workers) never load a half-written
file; within a process a lock makes one thread build.

A library that does not build or load is not hidden: :func:`load`
warns once with the compiler's output and returns ``None``, so a caller
can take its numpy path and count that it did; ``require=True`` raises
instead.  :func:`failure` returns the recorded reason.

:func:`count` records which path, native or numpy, served each call, by
library, in :data:`CALLS` and :data:`SECONDS`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# {library: {path: calls}} and {library: {path: seconds}}, by the path
# ("native" or "numpy") that served each call
CALLS: dict = {}
SECONDS: dict = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict = {}
_failures: dict = {}


class HostLibraryError(RuntimeError):
    """A host library did not compile or load."""


def compiler() -> str:
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not found:
        raise HostLibraryError("no C++ compiler: set CXX, or install g++")
    return found


def source(name: str) -> Path:
    return NATIVE_DIR / f"{name}.cpp"


def _version(cxx: str) -> str:
    """The compiler's ``--version`` text (its identity in the hash)."""
    try:
        return subprocess.run([cxx, "--version"], capture_output=True,
                              text=True).stdout
    except OSError:
        return ""


def library_path(name: str, cxx: str) -> Path:
    h = hashlib.sha256(" ".join((cxx, _version(cxx), *CXX_FLAGS)).encode())
    h.update(source(name).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library exists."""
    cxx = compiler()
    out = library_path(name, cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}_", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp,
                               str(source(name))],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise HostLibraryError(f"{cxx} failed on {source(name)}:\n"
                                 f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str, bind, require: bool = False):
    """The loaded library of ``native/<name>.cpp`` with ``bind(lib)``
    applied (it sets the ctypes signatures), built at the first call;
    ``None`` with one warning if it does not build or load, or
    :class:`HostLibraryError` when ``require``."""
    lib = _libs.get(name)
    if lib is not None or (name in _failures and not require):
        return lib
    with _lock:
        if name in _libs:
            return _libs[name]
        if name not in _failures:
            try:
                lib = ctypes.CDLL(str(build(name)))
                bind(lib)
                _libs[name] = lib
                return lib
            except (HostLibraryError, OSError, AttributeError) as err:
                _failures[name] = f"{type(err).__name__}: {err}"
                warnings.warn(f"hmvit_tpu_torch: the host library {name} is "
                              f"unavailable, its numpy path serves instead: "
                              f"{_failures[name]}", RuntimeWarning,
                              stacklevel=3)
        if require:
            raise HostLibraryError(f"{name}: {_failures[name]}")
        return None


def failure(name: str):
    """Why ``native/<name>.cpp`` did not build or load, or ``None``."""
    return _failures.get(name)


def count(name: str, served: str, seconds: float = 0.0) -> None:
    """Record one call of ``name`` served by ``served`` (``"native"`` or
    ``"numpy"``); thread-safe (the decode pool reads on several
    threads)."""
    with _count_lock:
        calls = CALLS.setdefault(name, {"native": 0, "numpy": 0})
        spent = SECONDS.setdefault(name, {"native": 0.0, "numpy": 0.0})
        calls[served] += 1
        spent[served] += seconds


def calls(name: str) -> dict:
    """``{"native": n, "numpy": n}``: the calls of ``name`` each path
    served since :func:`reset_counts`."""
    return dict(CALLS.get(name, {"native": 0, "numpy": 0}))


def seconds(name: str) -> dict:
    return dict(SECONDS.get(name, {"native": 0.0, "numpy": 0.0}))


def reset_counts() -> None:
    with _count_lock:
        CALLS.clear()
        SECONDS.clear()
