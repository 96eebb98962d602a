"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface and include no PyTorch
header, so each compiles in seconds.  Each source compiles to an object file
in its own ``nvcc`` process, all started together, and one more ``nvcc`` links
them into ``.kernel_build/libdiffpir_kernels.so`` at the root of the
repository.  The library is built at first use and again whenever a source,
the flags or the compiler path change (a hash of them is stored beside it).
Nothing here runs when the module is imported.

``use_library(path, digest)`` loads a library built elsewhere (a bundle's
sidecar, ``export.LoadedRestore.save_aot``) in place of a build, when
``digest`` equals ``library_digest()`` of these sources, flags and torch
version; otherwise it loads nothing, and the first launch builds as usual.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["BUILD_DIR", "BuildInfo", "find_nvcc", "build", "load_library",
           "spill_bytes", "library_digest", "use_library", "library_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".kernel_build")
LIB_NAME = "libdiffpir_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C functions: name -> argtypes (every one returns a cudaError_t)
_SIGNATURES = {
    # x, out, scale, bias, film_scale, film_shift, workspace, counters,
    # B, HW, C, G, S, slice, rows, eps, silu, is_bf16, stream
    "diffpir_groupnorm_silu": [_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # x, partial, workspace, B, HW, C, G, K (channel chunks), M (pixel
    # segments), rows, is_bf16, stream
    "diffpir_groupnorm_partial_stats": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, out, scale, bias, film_scale, film_shift, stats, B, HW, C, G, rows,
    # silu, is_bf16, stream
    "diffpir_groupnorm_apply_stats": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _I, _I, _P],
    # qkv, out, workspace, B, T, heads, ch, variant, rows, slice_ch, key_splits,
    # kv_chunks, is_bf16, stream
    "diffpir_legacy_qkv_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                     _P],
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: str          # the shared library
    built: bool        # False when an up-to-date library was reused
    seconds: float     # wall time of the build (0 when reused)
    log: str           # nvcc's output, ptxas register and spill report included
                       # (kept beside the library and returned when it is reused)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``; raises with the places tried."""
    tried = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        tried.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    tried.append(on_path or "nvcc on PATH")
    tried.append("/usr/local/cuda/bin/nvcc")
    for cand in tried:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found; tried: " + ", ".join(tried))


def spill_bytes(log: str) -> int:
    """Bytes of spill stores and loads over every kernel in a ``-Xptxas -v``
    log; raises if the log holds no spill report at all."""
    found = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    if not found:
        raise ValueError("no ptxas spill report in the build log")
    return sum(int(a) + int(b) for a, b in found)


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _run_all(cmds: list[list[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_path: str | None = None


def build() -> BuildInfo:
    """Compile the library if it is missing or stale; returns what was done."""
    nvcc = find_nvcc()
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    stamp_path = lib_path + ".sha256"
    log_path = lib_path + ".log"
    digest = _digest(nvcc)
    if all(map(os.path.exists, (lib_path, stamp_path, log_path))):
        with open(stamp_path) as f:
            if f.read().strip() == digest:
                with open(log_path) as lf:
                    return BuildInfo(lib_path, False, 0.0, lf.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = []
    compile_cmds = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        compile_cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src])
    log = _run_all(compile_cmds)
    tmp_lib = os.path.join(BUILD_DIR, f"tmp{tag}_{LIB_NAME}")
    log += _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-shared", "-o", tmp_lib, *objs]])
    for obj in objs:
        os.remove(obj)
    os.replace(tmp_lib, lib_path)
    with open(log_path, "w") as f:
        f.write(log)
    with open(stamp_path, "w") as f:
        f.write(digest + "\n")
    return BuildInfo(lib_path, True, time.perf_counter() - t0, log)


def library_digest() -> str:
    """A hash of the sources, the flags (the target, sm_90a, among them) and
    the torch version: what a library built elsewhere must match."""
    import torch

    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(torch.__version__.encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _open(path: str) -> ctypes.CDLL:
    global _lib, _lib_path
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib, _lib_path = lib, path
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    with _lock:
        return _lib if _lib is not None else _open(build().path)


def use_library(path: str, digest: str) -> bool:
    """Load the library at ``path`` instead of building one, if ``digest``
    is ``library_digest()``; returns whether it did (a library already
    loaded in this process stays)."""
    with _lock:
        if _lib is not None:
            return True
        if digest != library_digest():
            return False
        _open(path)
        return True


def library_path() -> str:
    """The path of the library this process loaded (building it if needed)."""
    load_library()
    return _lib_path

