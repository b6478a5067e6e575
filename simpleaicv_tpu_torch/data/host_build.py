"""Builds the port's host libraries from ``data/csrc`` and loads them (the
host-code sibling of ``ops/_build.py``).

Each ``csrc/<name>.cpp`` exports a plain C interface. ``g++`` compiles it
into a shared library under ``simpleaicv_tpu_torch/_build/`` at first use,
and ``ctypes`` loads it. The library's file name carries a hash of its
source and flags, so an edited source is rebuilt. Two libraries:

* ``gather``: the packed loader's record gather; the C++ runtime only;
* ``jpeg``: the JPEG decode and resize; links ``-ljpeg``, so it builds only
  where libjpeg's header and library are installed.

Nothing here falls back: a missing ``g++`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
LINK = {"gather": (), "jpeg": ("-ljpeg",)}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cpp`` lives."""
    flags = " ".join(CXX_FLAGS + LINK[name]).encode()
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cpp").read_bytes()
                            + flags).hexdigest()
    return BUILD_DIR / f"libhost_{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compiles ``csrc/<name>.cpp`` unless it is built already; raises if
    ``g++`` is missing or the build fails."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the port's host "
                           "libraries are built with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cpp"),
           *LINK[name]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library '{name}' failed to build "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cpp``, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
