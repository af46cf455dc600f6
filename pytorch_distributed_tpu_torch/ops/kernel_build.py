"""Build the port's CUDA kernels (``csrc/*.cu``) with ``nvcc`` at first use.

Each source compiles on its own into a shared library with a plain C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library's name carries a hash of the source, the headers in ``csrc/``
and the flags, so an edited source or header is rebuilt; ``ptxas``'s register and shared-memory report
goes to ``_build/<name>.log``. :func:`build` starts one ``nvcc`` per
missing library and waits for all of them, so the sources compile in
parallel. :func:`ptxas_report` reads that log back per kernel, and
:func:`sass_counts` counts instructions in a built library's machine code
(``cuobjdump -sass``, from the toolkit that holds ``nvcc``): how a run
shows that a kernel issues tensor-core instructions (``HMMA`` for
``mma.sync``, ``HGMMA`` for ``wgmma``). Nothing here runs at import: the
CPU tests import every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
#: where the kernel libraries are built (listed in .gitignore)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source at first use"
        )
    return path


def source(name: str) -> Path:
    return SOURCE_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library lives once built. Its name hashes
    the source, every header in ``csrc/`` (``*.cuh``, which the sources
    include) and the flags, so an edit to any of them rebuilds it."""
    digest = hashlib.sha256(source(name).read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source whose library is missing, all at once,
    and return ``{name: library path}``. Raises naming the first source
    that failed, with the end of the compiler's output."""
    names = list(names)
    libs = {n: library_path(n) for n in names}
    running = []
    for n, lib in libs.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(n))]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((n, lib, tmp, cmd, proc))
    failed = []
    for n, lib, tmp, cmd, proc in running:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{n}.log").write_text(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(
                f"nvcc failed ({proc.returncode}) building {source(n)}:\n"
                f"{out[-4000:]}"
            )
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def parse_ptxas(text: str) -> Dict[str, Dict[str, int]]:
    """``{kernel (mangled): {"registers", "spill_stores", "spill_loads"}}``
    from ``ptxas -v`` output."""
    report: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = report.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return report


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """:func:`parse_ptxas` of the build log of ``csrc/<name>.cu``."""
    return parse_ptxas((BUILD_DIR / f"{name}.log").read_text())


#: a SASS instruction line: address comment, optional predicate, opcode
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)")
#: the tensor-core opcodes: HMMA from mma.sync, HGMMA from wgmma
TENSOR_CORE_OPS = ("HMMA", "HGMMA")


def parse_sass(text: str) -> Dict[str, Dict[str, int]]:
    """``{kernel (mangled): {opcode: count}}`` over
    :data:`TENSOR_CORE_OPS` from ``cuobjdump -sass`` output (an opcode
    counts with any modifiers: ``HMMA.16816.F32.BF16`` is an ``HMMA``)."""
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = counts.setdefault(m.group(1),
                                        dict.fromkeys(TENSOR_CORE_OPS, 0))
            continue
        m = _SASS_OP.search(line)
        if current is not None and m and m.group(1) in current:
            current[m.group(1)] += 1
    return counts


def sass_counts(name: str) -> Dict[str, Dict[str, int]]:
    """:func:`parse_sass` of ``csrc/<name>.cu``'s built library. Raises if
    ``cuobjdump`` is not beside ``nvcc``."""
    tool = Path(nvcc()).with_name("cuobjdump")
    if not tool.exists():
        raise RuntimeError(f"cuobjdump not found beside nvcc ({tool})")
    out = subprocess.run(
        [str(tool), "-sass", str(library_path(name))], check=True,
        capture_output=True, text=True,
    ).stdout
    return parse_sass(out)
