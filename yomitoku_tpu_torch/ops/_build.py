"""Build and load the port's CUDA kernels (``yomitoku_tpu_torch/csrc``).

Each ``.cu`` source compiles with its own ``nvcc`` process, all started
together, and the objects link into one shared library with a plain C
interface, loaded through ``ctypes`` (no PyTorch headers, so the build
takes seconds).  The library lands in ``build/yomitoku_tpu_torch/``
at the repository root, named by a hash of the sources and flags: a
changed source rebuilds, an unchanged one reuses the library.  A failed
build raises with nvcc's output; nothing falls back to the plain version.

The host C++ of the port (``csrc/*.cpp``: the DBNet contours, and the PDF
engine's rasterizer, CCITT and JBIG2 decoders) builds the same way with
the host's g++, one library per source (``host_library``).

Nothing here runs at import time: the first kernel launch builds.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yomitoku_tpu_torch"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-lineinfo",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: storage-type codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


class KernelBuildError(RuntimeError):
    pass


class _Library:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, path, seconds, log):
        self.path = path
        self.build_seconds = seconds  # 0.0 when an existing build was reused
        self.build_log = log  # nvcc / ptxas output (registers, spills)
        lib = ctypes.CDLL(str(path))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.yt_gemm.argtypes = [
            i32, i32, vp, i64, vp, i64, i32, vp, vp, i64, vp, i64,
            i32, i32, i32, vp, vp, ctypes.c_float, i32, vp, vp,
        ]
        lib.yt_gemm.restype = i32
        lib.yt_attention.argtypes = [
            i32, i32, i32, i32, vp, i64, i64, vp, i64, i64, vp, i64, i64,
            vp, i64, i64, vp, i32, i32, i32, i32, i32, ctypes.c_float, vp,
        ]
        lib.yt_attention.restype = i32
        ip = ctypes.POINTER(ctypes.c_int)
        lib.yt_ms_deformable_attention.argtypes = [
            i32, i32, vp, vp, vp, vp, i32, i64, i32, i32, i32, i32, ip, ip, vp,
        ]
        lib.yt_ms_deformable_attention.restype = i32
        lib.yt_quantize_rows.argtypes = [
            i32, vp, i64, vp, vp, ctypes.c_float, vp, vp, i32, i32, i32, vp,
        ]
        lib.yt_quantize_rows.restype = i32
        lib.yt_gemm_int8.argtypes = [
            i32, vp, i64, vp, i64, vp, vp, vp, vp, i64, vp, i64,
            i32, i32, i32, i32, i32, i32, vp,
        ]
        lib.yt_gemm_int8.restype = i32
        lib.yt_conv.argtypes = [
            i32, ip, vp, i32, vp, vp, vp, i32, vp, vp, vp, vp,
            i32, i32, i32, i32, i32, i32, vp, vp,
        ]
        lib.yt_conv.restype = i32
        lib.yt_bottleneck.argtypes = [
            i32, vp, i32, i32, i32, i32, i32, i32, i32,
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ip, vp, vp,
        ]
        lib.yt_bottleneck.restype = i32
        lib.yt_identity_stage.argtypes = [
            i32, vp, i32, i32, i32, i32, i32, i32, i32,
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ip, vp, vp,
        ]
        lib.yt_identity_stage.restype = i32
        lib.yt_error_string.argtypes = [i32]
        lib.yt_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, code: int, what: str):
        if code != 0:
            msg = self.lib.yt_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_LOADED = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once -> [(command, output, exit code)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    return [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]


def build() -> _Library:
    """Compile (or reuse) the kernel library; raise on any failure."""
    cu, _ = _sources()
    if not cu:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    out = BUILD_DIR / f"libyt_kernels_{source_hash()}.so"
    if out.exists():
        return _Library(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    objs = [tmp.with_name(f"{tmp.stem}.{f.stem}.o") for f in cu]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    results = _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
                       for f, o in zip(cu, objs))
    if all(rc == 0 for _, _, rc in results):
        results += _run_all(
            [[nvcc, "-shared", *GENCODE, "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(text for _, text, _ in results)
    for cmd, text, rc in results:
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{text}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a torn file
    return _Library(out, seconds, log)


#: held while a library is built or loaded: threads that reach their first
#: launch together (DocumentAnalyzer.batch) build it once, and would
#: otherwise write the same temporary files
_BUILD_LOCK = threading.Lock()


def library() -> _Library:
    """The process's kernel library, built at first use."""
    global _LOADED
    if _LOADED is None:
        with _BUILD_LOCK:
            if _LOADED is None:
                _LOADED = build()
    return _LOADED


HOST_FLAGS = ("-O2", "-shared", "-fPIC")
_HOST = {}
_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)


def host_library(stem: str) -> ctypes.CDLL:
    """The host C++ library ``csrc/<stem>.cpp`` (no CUDA), compiled at
    first use with the host's g++ into ``BUILD_DIR`` (named by a hash of
    the source and flags) and loaded; raises KernelBuildError when it
    cannot be built."""
    if stem not in _HOST:
        with _BUILD_LOCK:
            if stem not in _HOST:
                _HOST[stem] = _build_host(stem)
    return _HOST[stem]


def _build_host(stem):
    src = CSRC / f"{stem}.cpp"
    text = src.read_bytes()
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + text)
    # a source that includes another (jbig2.cpp includes ccitt.cpp)
    # rebuilds when either changes
    for name in _INCLUDE.findall(text.decode("utf-8", "replace")):
        h.update((CSRC / name).read_bytes())
    out = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise KernelBuildError(f"no host C++ compiler to build {src.name}")
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"{cxx} failed (exit {proc.returncode}) on {src.name}:\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
