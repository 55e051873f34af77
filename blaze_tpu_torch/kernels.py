"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under `csrc/` with a plain C entry. At
first use it is compiled with `nvcc` for Hopper (`sm_90a`) into a shared
library under `build/` (listed in .gitignore), or under the directory
`$BLAZE_TPU_TORCH_BUILD_DIR` names, and loaded with `ctypes`. The native
library (`native/`) builds into the same directory.
Nothing is downloaded; the CUDA toolkit's `nvcc` is found through
`$CUDA_HOME`, `/usr/local/cuda` or `$PATH`. The library's file name carries
a hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded. Each build, and each library found already built,
is reported to the compile service (runtime/compile_service.note_build).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
# the libraries' directory: BLAZE_TPU_TORCH_BUILD_DIR, read at import,
# else the package's build/ (the JAX package's BLAZE_TPU_XLA_CACHE is the
# counterpart: where its compiled programs persist)
BUILD_DIR = Path(os.environ.get("BLAZE_TPU_TORCH_BUILD_DIR")
                 or _PKG / "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry points of each kernel library: name -> (argtypes, restype)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "mxu_accumulate": {
        "mxu_accumulate_scratch_bytes": ([_LL, _I, _I], _LL),
        "mxu_accumulate_into": ([_P, _P, _P, _I, _P, _I, _LL, _I, _I, _P,
                                 _P, _LL, _I, _P, _P], _I),
        "mxu_accumulate_error": ([_I], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build wall time, "ptxas": compiler resource notes}
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names: List[str]) -> Dict[str, Path]:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns name -> library path."""
    from blaze_tpu_torch.runtime import compile_service

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            compile_service.note_build(name, None)
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        seconds = time.perf_counter() - t0
        compile_service.note_build(name, int(seconds * 1e9))
        BUILD_INFO[name] = {
            "seconds": seconds,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "entry function" in ln]}
    return {name: _lib_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = argtypes, restype
            _libs[name] = lib
        return lib
