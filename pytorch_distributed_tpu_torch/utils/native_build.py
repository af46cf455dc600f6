"""Build a native (C++) library at first use: the port's copy of
``pytorch_distributed_tpu/utils/native_build.py``.

The port loads the repo's shared native sources (``native/*.cpp``)
through ctypes and never changes them or writes beside them: each
library is compiled with ``g++`` into the port's build directory
(``pytorch_distributed_tpu_torch/_build/``, ignored by git) under a
name that hashes the source and the flags, so an edited source or
another host's ISA flags build a new one. The compile writes a
temporary file and renames it into place, so concurrent first uses
race harmlessly.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parent.parent
#: the repo's shared native sources
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"


def host_cpu_flags() -> set:
    """The host's CPU feature flags from /proc/cpuinfo (empty elsewhere)."""
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read()
    except OSError:
        return set()
    for line in info.splitlines():
        if line.startswith("flags"):
            return set(line.split(":", 1)[1].split())
    return set()


def _arch_flags() -> list:
    """``-march=x86-64-v3`` when the host lists that whole feature set,
    else nothing (a partial set would SIGILL on the missing features)."""
    flags = host_cpu_flags()
    v3 = {"avx", "avx2", "bmi1", "bmi2", "fma", "f16c", "movbe", "xsave"}
    lzcnt = bool({"lzcnt", "abm"} & flags)
    return ["-march=x86-64-v3"] if (v3 <= flags and lzcnt) else []


def build_native_library(name: str, extra_flags: Sequence[str] = ()) -> str:
    """Compile ``native/<name>.cpp`` into the build directory if its
    library is missing; returns the library's path."""
    src = NATIVE_DIR / f"{name}.cpp"
    flags = ["-O3", "-std=c++17", "-fPIC", "-shared", *_arch_flags()]
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(flags + list(extra_flags)).encode())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return str(so)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [os.environ.get("CXX", "g++"), *flags, "-o", tmp, str(src),
           *extra_flags]   # after the source: -l libraries resolve in order
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"native build of {src.name} failed:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(so)
