"""Build a kernel source with ``nvcc`` into a shared library with a plain C
interface, in the repository's ``build/`` directory, and load it with
``ctypes``.

Each kernel package names its source and library and calls :func:`build`
and :func:`load`.  Nothing is built or loaded when this module is imported,
so the CPU tests import every kernel package freely.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    """The path of ``nvcc``: on ``PATH``, else under PyTorch's CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit to build")


def is_current(source: Path, library: Path) -> bool:
    """Whether ``library`` exists and is no older than ``source`` and the
    headers beside it that it includes (``#include "name"``), so an edit to
    a shared header rebuilds every library that includes it."""
    names = _LOCAL_INCLUDE.findall(source.read_text())
    deps = [source] + [source.parent / n for n in names
                       if (source.parent / n).exists()]
    return library.exists() and library.stat().st_mtime >= max(
        p.stat().st_mtime for p in deps)


def build(source: Path, library: Path, flags=NVCC_FLAGS,
          force: bool = False) -> str:
    """Compile ``source`` into ``library`` unless an up-to-date one exists.

    Returns the compiler's log (``-Xptxas=-v`` register and shared-memory
    report), or "" when the library was already built.  Raises with the
    compiler's output if ``nvcc`` fails.  The library is written under a
    temporary name and renamed, so a concurrent reader never loads half a
    file.
    """
    if not force and is_current(source, library):
        return ""
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)
    return proc.stdout + proc.stderr


def load(source: Path, library: Path, symbol: str, argtypes,
         restype=ctypes.c_int):
    """Build if needed, load ``library`` and return its C function
    ``symbol`` with ``argtypes`` and ``restype`` declared."""
    build(source, library)
    fn = getattr(ctypes.CDLL(str(library)), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn
