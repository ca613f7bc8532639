"""Build and load the package's CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` of this package with ``nvcc`` for
``sm_90a`` (one ``nvcc`` per source, all started together, then one link)
into a shared library with a plain C interface, under ``build/heat_tpu_torch/``
at the repository root, and loads it with ``ctypes``.  The library's name
carries a hash of the sources and flags, so a build is reused until a source
changes.  Nothing is built at import time: the CPU never needs the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

__all__ = ["load", "load_variant", "BUILD_DIR", "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "heat_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ARCH + ["-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
# what the last build did: seconds and the compiler's output (with ptxas's
# register and shared-memory report per kernel)
build_info = {"seconds": None, "log": "", "library": None}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: List[Path], flags: List[str]) -> str:
    h = hashlib.sha256(" ".join(flags + LINK_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):  # the headers the sources include
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path, sources: List[Path], flags: List[str]) -> str:
    """Compile and link ``sources`` into ``target``; the compiler's output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{target.stem}.{tag}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *flags, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = target.with_name(f"{target.name}.{tag}.tmp")
    link = subprocess.run(
        [nvcc, *LINK_FLAGS, *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, target)  # atomic: concurrent ranks may build at once
    return "\n".join(logs)


def _declare_kmeans(lib: ctypes.CDLL) -> None:
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    lib.heat_kmeans_assign.argtypes = [i32, ptr, ptr, i64, i32, i32, i32, ptr, ptr, ptr, ptr]
    lib.heat_kmeans_assign.restype = i32
    lib.heat_kmeans_em_grid.argtypes = [i32, i64, i32, i32, i32]
    lib.heat_kmeans_em_grid.restype = i32
    lib.heat_kmeans_em_stats.argtypes = [i32, ptr, ptr, i64, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.heat_kmeans_em_stats.restype = i32
    lib.heat_kmeans_launch_config.argtypes = [i32, i32, i32, i32, i32, ptr]
    lib.heat_kmeans_launch_config.restype = i32
    lib.heat_kmeans_strerror.argtypes = [i32]
    lib.heat_kmeans_strerror.restype = ctypes.c_char_p
    lib.heat_kmeans_residency.argtypes = [i32, i32, ptr, i32]
    lib.heat_kmeans_residency.restype = i32


def _declare(lib: ctypes.CDLL) -> None:
    _declare_kmeans(lib)
    i32, i64, ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
    f32 = ctypes.c_float
    # (device, operand and output pointers, bhq, bhk, S, d, bf16, scale, causal, stream)
    tail = [i64, i64, i32, i32, i32, f32, i32, ptr]
    lib.heat_flash_fwd.argtypes = [i32] + [ptr] * 5 + tail
    lib.heat_flash_fwd.restype = i32
    lib.heat_flash_bwd_dq.argtypes = [i32] + [ptr] * 7 + tail
    lib.heat_flash_bwd_dq.restype = i32
    lib.heat_flash_bwd_dkv.argtypes = [i32] + [ptr] * 8 + tail
    lib.heat_flash_bwd_dkv.restype = i32
    # (device, operand, position and output pointers, b, sq, sk, d, bf16, scale, causal, s_valid, masked, stream)
    pos_tail = [i64, i32, i32, i32, i32, f32, i32, i32, i32, ptr]
    lib.heat_flash_pos_fwd.argtypes = [i32] + [ptr] * 7 + pos_tail
    lib.heat_flash_pos_fwd.restype = i32
    lib.heat_flash_pos_bwd_dq.argtypes = [i32] + [ptr] * 9 + pos_tail
    lib.heat_flash_pos_bwd_dq.restype = i32
    lib.heat_flash_pos_bwd_dkv.argtypes = [i32] + [ptr] * 10 + pos_tail
    lib.heat_flash_pos_bwd_dkv.restype = i32
    lib.heat_flash_route.argtypes = [i32]
    lib.heat_flash_route.restype = i32
    lib.heat_flash_strerror.argtypes = [i32]
    lib.heat_flash_strerror.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernels' library, built first if its sources changed."""
    global _lib
    if _lib is None:
        sources = _sources()
        target = BUILD_DIR / f"libheat_tpu_torch_{_digest(sources, COMPILE_FLAGS)}.so"
        if not target.exists():
            t0 = time.perf_counter()
            build_info["log"] = _build(target, sources, COMPILE_FLAGS)
            build_info["seconds"] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        _declare(lib)
        build_info["library"] = str(target)
        _lib = lib
    return _lib


def load_variant(source: Path) -> ctypes.CDLL:
    """A library of the one KMeans source ``source``, a variant of
    ``csrc/kmeans.cu`` that a measurement script wrote, built beside the
    package's library; the kernels' wrappers keep calling the library
    ``load()`` returns."""
    source = Path(source)
    h = hashlib.sha256(_digest([source], COMPILE_FLAGS).encode() + str(source.resolve()).encode()).hexdigest()[:16]
    target = BUILD_DIR / f"libheat_kmeans_variant_{h}.so"
    if not target.exists():
        _build(target, [source], COMPILE_FLAGS)
    lib = ctypes.CDLL(str(target))
    _declare_kmeans(lib)
    return lib
