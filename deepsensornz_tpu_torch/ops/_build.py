"""Build and load the SetConv CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source started together, then linked into one
shared library (the ``.cuh`` headers they include are hashed with them),
loaded with ``ctypes``. The build runs at first use, from the package's own
sources, into ``_build/`` beside them; the library's name carries a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the existing library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("mma_split.cuh", "setconv_encode.cu", "setconv_encode_grad.cu",
           "setconv_decode.cu")  # all hashed
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """The CUDA toolkit's nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the SetConv CUDA kernels are compiled "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libsetconv_{h.hexdigest()[:16]}.so"


def _run(cmd: list) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc`` per ``.cu`` source, all started together, then one link.
    The compilers' output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``."""
    path = library_path()
    if path.is_file():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{Path(n).stem}.o" for n in SOURCES if n.endswith(".cu")]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC_DIR / f"{o.stem}.cu")]
                for o in objs]
        with ThreadPoolExecutor(len(cmds)) as pool:
            procs = list(pool.map(_run, cmds))
        lib = Path(tmp) / path.name
        cmds.append([nvcc, "-shared", "-o", str(lib), *map(str, objs)])
        if all(p.returncode == 0 for p in procs):
            procs.append(_run(cmds[-1]))
        for cmd, proc in zip(cmds, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        path.with_suffix(".log").write_text("".join(p.stdout + p.stderr for p in procs))
        os.replace(lib, path)  # atomic: a concurrent loader sees all or nothing
    return path


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature
    (pointers and the stream as ``c_void_p``, never the 32-bit default)."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.setconv_encode_offgrid.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.setconv_encode_offgrid.restype = i
    lib.setconv_encode_offgrid_grad.argtypes = [p, p, p, p, p, p, p, p, i, p, p,
                                                *[i] * 5, ctypes.c_float, p]
    lib.setconv_encode_offgrid_grad.restype = i
    lib.setconv_decode_grid.argtypes = [p, p, i, p, p, p, p, p, p, *[i] * 12, p]
    lib.setconv_decode_grid.restype = i
    lib.setconv_error_string.argtypes = [i]
    lib.setconv_error_string.restype = ctypes.c_char_p
    return lib
