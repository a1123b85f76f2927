"""Build and load the port's native libraries from ``csrc/`` at first use.

Three libraries, each one source file with a plain C interface, loaded
with ctypes:

  - ``crc32c``: csrc/crc32c.c, host CRC32-C, built with ``cc``;
  - ``gf_matmul``: csrc/gf_matmul.cu, the GF(2^8) kernel for Hopper, built
    with ``nvcc -gencode arch=compute_90a,code=sm_90a``;
  - ``dataplane``: csrc/dataplane.cpp, the volume server's native data
    plane (``volume -dataplane native``), host C++17 built with ``c++``
    and linked with zlib (``-lz``, after the source).

Outputs go to ``seaweedfs_tpu_torch/build/`` under a name that carries a
hash of the source and the command, so an edited source never loads a
stale library.  Each build writes a temporary name and ``os.replace``s it
into place, so several processes (pytest-xdist workers) may build the same
library at once.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


_P, _I32, _I64, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_uint32)
_U, _U64, _S = ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_char_p
_PU, _PU64, _PI = (ctypes.POINTER(ctypes.c_uint),
                   ctypes.POINTER(ctypes.c_ulonglong),
                   ctypes.POINTER(ctypes.c_int))
_CRC = (_U32, [_U32, _P, ctypes.c_size_t])
# name -> (source, compiler argv, {function: (restype, argtypes)}, the
# libraries linked after the source)
_SPECS = {
    "crc32c": ("crc32c.c", lambda: ["cc", "-O3", "-shared", "-fPIC"],
               {"crc32c_extend": _CRC, "crc32c_extend_table": _CRC}, []),
    "gf_matmul": ("gf_matmul.cu", lambda: [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        {"gf_matmul_launch": (_I32, [_P, _I32, _I32, _P, _I64, _P, _I64,
                                     _I64, _I32, _I32, _I32, _P, _I32]),
         "gf_table_build_launch": (_I32, [_P, _I32, _I32, _P, _P, _I32]),
         "gf_noop_launch": (_I32, [_P, _I32])}, []),
    "dataplane": ("dataplane.cpp", lambda: [
        "c++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        "-Wall"], {
        "dp_start": (_P, [_S, _I32]),
        "dp_port": (_I32, [_P]),
        "dp_add_volume": (_I32, [_P, _U, _S, _S, _I32, _I32]),
        "dp_remove_volume": (_I32, [_P, _U]),
        "dp_write": (_I32, [_P, _U, _U64, _U, _P, _U, _PU]),
        "dp_append": (_I32, [_P, _U, _U64, _U, _P, _U64, _I32]),
        "dp_read": (_I32, [_P, _U, _U64, _U, _P, _PU]),
        "dp_read_record": (_I32, [_P, _U, _U64, _U, _I32, _P, _PU64,
                                  _PI]),
        "dp_delete": (_I32, [_P, _U, _U64, _U, _PU]),
        "dp_stat": (_I32, [_P, _U, _PU64, _PU64, _PU64, _PU64, _PU64]),
        "dp_sync": (_I32, [_P, _U]),
        "dp_free": (None, [_P]),
        "dp_frames": (None, [_P, _PU64, _PU64, _PU64]),
        "dp_stop": (None, [_P])}, ["-lz"]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# per library: {"seconds": build wall time (0.0 when already built),
# "log": compiler output}; chip_smoke.py prints it
BUILD_INFO: dict[str, dict] = {}


def _target(name: str) -> tuple[str, list[str], list[str], str]:
    source, cmd, _, libs = _SPECS[name]
    src = os.path.join(CSRC_DIR, source)
    argv = cmd()
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(argv + libs).encode()).hexdigest()
    return (src, argv, libs,
            os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so"))


def build(names: list[str]) -> dict[str, str]:
    """Build every library in ``names`` that is not built yet, all
    compilers running at once; returns name -> library path."""
    paths: dict[str, str] = {}
    running = []
    t0 = time.perf_counter()
    for name in names:
        src, argv, libs, out = _target(name)
        paths[name] = out
        if os.path.exists(out):
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.Popen(argv + ["-o", tmp, src] + libs,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failures.append(f"{name}: exit {proc.returncode}\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("native build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with every
    entry's ctypes prototype declared (pointers as c_void_p, so a 64-bit
    address is never cut to a C int)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            for fn, (restype, argtypes) in _SPECS[name][2].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return lib
