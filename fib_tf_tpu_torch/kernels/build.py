"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled on first use into `build/fib_tf_tpu_torch/` at the
root of the checkout, under a name that carries a hash of its sources, the
headers they include and the flags, so an edited `.cu` or `.cuh` rebuilds
and an unchanged one loads at once.  Sources include their headers with
quoted relative includes (`#include "br_cell.cuh"`), which the compiler
resolves against the including file's directory; `includes` follows them
the same way, so the hash covers every header a source reaches.  The
libraries have a plain C interface (no PyTorch headers), which keeps a
build to seconds.  A missing nvcc or a failed build raises; nothing falls
back to the plain PyTorch path.

Importing this module needs neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fib_tf_tpu_torch"

# no --use_fast_math: logf feeds e_Ca and the fits want IEEE division.
# -Xptxas -v writes each kernel's registers and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# the CUDA toolkit's default install prefix, used when neither CUDA_HOME
# nor PATH names nvcc
_DEFAULT_CUDA_HOME = "/usr/local/cuda"


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the toolkit's
    default prefix.  Raises RuntimeError when there is none."""
    for home in (os.environ.get("CUDA_HOME"), None, _DEFAULT_CUDA_HOME):
        cand = (shutil.which("nvcc") if home is None
                else str(Path(home) / "bin" / "nvcc"))
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of fib_tf_tpu_torch are built from source on first use"
    )


def _flags(defines: Sequence[str], flags: Sequence[str]):
    return (*NVCC_FLAGS, *flags, *(f"-D{d}" for d in defines))


def includes(sources: Sequence[Path]) -> tuple:
    """The headers `sources` depend on: the transitive closure of their
    quoted `#include "..."` lines, each resolved against the including
    file's directory (and normalised), sorted.  A header reached twice, or
    through a cycle, is listed once."""
    found, todo = set(), [Path(src) for src in sources]
    while todo:
        path = todo.pop()
        for line in path.read_text().splitlines():
            if line.startswith('#include "'):
                name = line.split('"')[1]
                hdr = Path(os.path.normpath(path.parent / name))
                if hdr not in found:
                    found.add(hdr)
                    todo.append(hdr)
    return tuple(sorted(found))


def library_path(name: str, sources: Sequence[Path],
                 defines: Sequence[str] = (),
                 flags: Sequence[str] = ()) -> Path:
    """Where `build` puts the library of `sources`: keyed by a hash of
    their bytes, of the headers they include (`includes`) and of the nvcc
    flags (with the preprocessor `defines` and the extra `flags`)."""
    h = hashlib.sha256(" ".join(_flags(defines, flags)).encode())
    for src in [*sources, *includes(sources)]:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: Sequence[Path],
          defines: Sequence[str] = (), flags: Sequence[str] = ()) -> Path:
    """Compile `sources` into one shared library unless a library of the
    same sources, headers (`includes`), `defines` (macros set with -D,
    which select what a source compiles) and extra nvcc `flags` exists;
    return its path.  The headers are hashed, not passed to nvcc.  The
    compiler's output (with the -Xptxas -v resource report) is kept
    beside it as `<lib>.log`."""
    out = library_path(name, sources, defines, flags)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *_flags(defines, flags), "-o", str(tmp),
           *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_name(out.name + ".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    # atomic publish: a concurrent builder of the same sources writes the
    # same bytes, and readers never see a partial file
    os.replace(tmp, out)
    return out


def load(name: str, sources: Sequence[Path],
         defines: Sequence[str] = (),
         flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the library of `sources`."""
    return ctypes.CDLL(str(build(name, sources, defines, flags)))
