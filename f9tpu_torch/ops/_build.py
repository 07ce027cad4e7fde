"""Build and load the port's hand-written CUDA kernels.

``nvcc`` compiles every ``f9tpu_torch/csrc/*.cu`` (one process per source,
all started together) and links them into one shared library with a plain
C interface, loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  The library lands in ``f9tpu_torch/_build/<hash>/``,
keyed by a hash of the sources and flags, and is reused while they are
unchanged.  Nothing is compiled or loaded when this module is imported;
`load_library` does it at the first kernel launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["load_library", "build_seconds", "ptxas_report"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: wall seconds the last build took (0.0 when the cached library was reused)
build_seconds = 0.0
#: what ptxas reported for the last build (registers, shared memory, spills)
build_log = ""


def ptxas_report(log: str) -> dict:
    """ptxas's ``-v`` lines read per kernel: {mangled name: {"registers",
    "spill_stores", "spill_loads", "stack"}} (bytes but the registers)."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            found.setdefault(name, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found.setdefault(name, {})["registers"] = int(m.group(1))
    return found


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.f9_cycle_src.argtypes = [vp, vp, vp, vp, i32, i64, i64, i32, i32, i32,
                                 i32, i64, i64, i32, i32, i32, i32, i32, i32,
                                 i32, vp]
    lib.f9_cycle_src.restype = i32
    lib.f9_cycle_src_win.argtypes = [vp, vp, vp, vp, i32, i64, i64, i32, i32, i32,
                                     i32, i64, i64, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.f9_cycle_src_win.restype = i32
    lib.f9_cycle_src_geometry.argtypes = []
    lib.f9_cycle_src_geometry.restype = i32
    lib.f9_cycle_src_blocks_per_sm.argtypes = [i32, i32, i32]
    lib.f9_cycle_src_blocks_per_sm.restype = i32
    lib.f9_cycle_src_win_blocks_per_sm.argtypes = [i32, i32, i32]
    lib.f9_cycle_src_win_blocks_per_sm.restype = i32
    f32 = ctypes.c_float
    lib.f9_epilogue.argtypes = [vp] * 13 + [i32, i32, i64, i64, i32, f32, f32, f32, i64,
                                            i32, i32, i32, vp]
    lib.f9_epilogue.restype = i32
    lib.f9_upols_mac.argtypes = [vp, vp, vp, i64, i64, i64, i32, i32, i32, vp]
    lib.f9_upols_mac.restype = i32
    lib.f9_fir_fold.argtypes = [vp, vp, vp, i64, i64, i32, vp]
    lib.f9_fir_fold.restype = i32
    lib.f9_ma_past.argtypes = [vp, vp, i64, i64, i32, f32, vp]
    lib.f9_ma_past.restype = i32
    lib.f9_slanted_cummax.argtypes = [vp] * 7 + [i64, i64, i64, i32, i32, i32, f32, vp]
    lib.f9_slanted_cummax.restype = i32
    lib.f9_window_max.argtypes = [vp, vp, vp, i64, i64, i32, i32, vp]
    lib.f9_window_max.restype = i32
    lib.f9_cycle_fold.argtypes = [vp] * 5 + [i64, i64, i64, i64, i32, i32, i32, i32, i32, i32,
                                             vp]
    lib.f9_cycle_fold.restype = i32
    lib.f9_cycle_fold_cycles.argtypes = []
    lib.f9_cycle_fold_cycles.restype = i32
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from the checkout's sources on
    first use.  Raises RuntimeError with nvcc's output if the build fails."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
        for s in srcs:
            with open(s, "rb") as f:
                h.update(os.path.basename(s).encode() + b"\0" + f.read())
        out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
        so = os.path.join(out_dir, "libf9kernels.so")
        if not os.path.exists(so):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{so}.tmp-{os.getpid()}"
            cu = [s for s in srcs if s.endswith(".cu")]
            objs = [os.path.join(out_dir, f"{os.path.basename(c)}.{os.getpid()}.o")
                    for c in cu]
            t0 = time.time()
            # one nvcc per source, all at once, then one link
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-I", CSRC, "-o", o, c],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for c, o in zip(cu, objs)]
            logs = [proc.communicate()[1] for proc in procs]     # all end first
            for c, proc, err in zip(cu, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {os.path.basename(c)} "
                                       f"(exit {proc.returncode}):\n{err}")
            proc = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n{proc.stderr}")
            for o in objs:
                os.remove(o)
            os.replace(tmp, so)
            build_seconds = time.time() - t0
            build_log = "".join(logs)
        _lib = _declare(ctypes.CDLL(so))
        return _lib
