"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), named by the hash of its
source so an edited kernel is never served stale, and loaded with
``ctypes``.  Pointers and the stream are passed as ``c_void_p``.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
SOURCES = ("plist_pair", "tri_pair", "ewald_fused", "rect_pair", "gather",
           "constraint_clusters")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _compile_cmd(name: str, out: str) -> list:
    return [_nvcc()] + NVCC_FLAGS + ["-o", out, os.path.join(CSRC,
                                                             name + ".cu")]


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: nvcc/ptxas report} of what it built; raises
    on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        procs[name] = subprocess.Popen(
            _compile_cmd(name, out + ".tmp"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    report = {name: proc.communicate()[0] for name, proc in procs.items()}
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{report[name]}")
        os.replace(_lib_path(name) + ".tmp", _lib_path(name))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = _lib_path(name)
        if not os.path.exists(path):
            build_all((name,))
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
