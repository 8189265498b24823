"""Builds the port's CUDA kernels and loads them with ctypes.

Every `*.cu` source under `kernels/**/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into one shared library with a plain C interface. The
sources are compiled in parallel, one `nvcc` each, then linked; they
include shared headers (`kernels/csrc/*.cuh`) by their path under the
kernels directory, which is on the include path. The build runs at first
use, into `build/torch_kernels/` at the root of the checkout (listed in
`.gitignore`), under a name keyed by a hash of every file under
`kernels/**/csrc/` (sources and headers) and the flags, so an edited
source or header is rebuilt and an unchanged tree is loaded as it is.

Nothing here runs at import time: the CPU tests import every module and
this machine may have no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-I", str(KERNELS_DIR))
_CSRC_SUFFIXES = (".cu", ".cuh")


class KernelLibrary:
    """The loaded shared library, with what its build reported."""

    def __init__(self, path: Path, log: str):
        self.path = path
        self.log = log      # nvcc/ptxas output; empty if built earlier
        self.lib = ctypes.CDLL(str(path))
        self.lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        self.lib.repro_cuda_error_string.restype = ctypes.c_char_p

    def function(self, name: str, argtypes) -> ctypes._CFuncPtr:
        """A launcher of the library, with its C signature declared (every
        launcher returns the CUDA error code of its launch as an int)."""
        fn = getattr(self.lib, name)
        if fn.argtypes is None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        return fn

    def check(self, rc: int, what: str) -> None:
        """Raise if a launcher returned a CUDA error code."""
        if rc != 0:
            msg = self.lib.repro_cuda_error_string(rc).decode()
            raise RuntimeError(f"{what} failed to launch: CUDA error "
                               f"{rc} ({msg})")


def sources() -> List[Path]:
    return sorted(KERNELS_DIR.glob("**/csrc/*.cu"))


def csrc_files() -> List[Path]:
    """Every file the build reads: the sources and the headers they
    include."""
    return sorted(p for p in KERNELS_DIR.glob("**/csrc/*")
                  if p.suffix in _CSRC_SUFFIXES and p.is_file())


def library_name() -> str:
    """The library's file name, keyed by the flags and the path and
    content of every file under `kernels/**/csrc/`."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in csrc_files():
        h.update(f.relative_to(KERNELS_DIR).as_posix().encode())
        h.update(f.read_bytes())
    return f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands in parallel; raise with their output if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for c, pr in zip(cmds, procs):
        out, _ = pr.communicate(timeout=900)
        logs.append(out)
        if pr.returncode != 0:
            failed.append(f"{' '.join(c)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def _build(target: Path) -> str:
    nvcc = _nvcc()
    tmp = target.parent / f"tmp-{os.getpid()}-{target.stem}"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        objs = [tmp / f"{i}_{src.stem}.o" for i, src in enumerate(sources())]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(o)]
                        for src, o in zip(sources(), objs)])
        lib = tmp / target.name
        log += _run_all([[nvcc, "-shared", "-gencode",
                          "arch=compute_90a,code=sm_90a",
                          *map(str, objs), "-o", str(lib)]])
        os.replace(lib, target)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return log


_LOCK = threading.Lock()
_LIBRARY: Optional[KernelLibrary] = None


def load_library() -> KernelLibrary:
    """Build (at first use) and load the kernel library."""
    global _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            target = BUILD_DIR / library_name()
            log = "" if target.is_file() else _build(target)
            _LIBRARY = KernelLibrary(target, log)
        return _LIBRARY
