"""Build and load the port's CUDA kernels.

The sources under `datafusion_tpu_torch/csrc/` are compiled by `nvcc`
for `sm_90a` (Hopper) into one shared library with a plain C interface,
loaded through `ctypes`: no PyTorch headers, so a build takes seconds.
Each source compiles in its own `nvcc` process, all started together,
then one link step. The library lands in `datafusion_tpu_torch/build/`
under a name keyed by the sources' hash, so a source change rebuilds and
an unchanged checkout reuses the last build.

Float division must stay IEEE-exact, so no `--use_fast_math` (nvcc's
default `-prec-div=true` is kept).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from datafusion_tpu_torch.errors import ExecutionError

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("fused_stage.cu", "segreduce.cu", "partition.cu", "ragged_shuffle.cu")
HEADERS = ("reduce_common.cuh", "launch_fill.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise ExecutionError("nvcc not found: the CUDA kernels cannot be built here")
    return nvcc


def library_path(defines: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for name in SOURCES + HEADERS:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libdftorch_kernels_{h.hexdigest()[:16]}.so"


def build_library(verbose: bool = False, defines: tuple = ()) -> tuple[Path, float, str]:
    """Compile the kernels if the library for these sources is missing.
    Returns (library path, build seconds, compiler log). `verbose` adds
    `-Xptxas -v` (registers, shared memory and spills per kernel);
    `defines` (`-DNAME=VALUE` flags) build a library of their own, as
    scripts/fold_variants.py's ablations do."""
    lib = library_path(defines)
    if lib.exists() and not verbose:
        return lib, 0.0, ""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    flags = list(NVCC_FLAGS) + list(defines) + (["-Xptxas", "-v"] if verbose else [])
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *flags, "-c", str(SRC_DIR / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        log = []
        failed = []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise ExecutionError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise ExecutionError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)  # atomic: concurrent builders never see half a file
    return lib, time.perf_counter() - t0, "\n".join(log)


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    from datafusion_tpu_torch.utils.trace import span

    with span("dft.build"):
        return bind(ctypes.CDLL(str(build_library()[0])))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C entries' signatures on a loaded library. The structs passed
    by value (K1's Program, K5's ExchangeArgs) are checked against their
    ctypes mirrors once, here."""
    from datafusion_tpu_torch.ops.pallas.fused_stage import _CProgram
    from datafusion_tpu_torch.ops.pallas.ragged_shuffle import ExchangeArgs

    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dft_fused_stage.argtypes = [vp, i64, i32, i32, vp]
    lib.dft_fused_stage.restype = i32
    lib.dft_fused_stage_program_size.argtypes = []
    lib.dft_fused_stage_program_size.restype = i32
    lib.dft_segreduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, i32, vp]
    lib.dft_segreduce.restype = i32
    lib.dft_segreduce_dense.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp]
    lib.dft_segreduce_dense.restype = i32
    lib.dft_slab_partition.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, vp, vp, vp, vp, i32, i32, vp, vp, vp]
    lib.dft_slab_partition.restype = i32
    lib.dft_windowed_reduce.argtypes = [vp, i64, i32, i32, vp, vp, vp, vp, vp, vp, vp]
    lib.dft_windowed_reduce.restype = i32
    lib.dft_windowed_reduce_slab.argtypes = [vp, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.dft_windowed_reduce_slab.restype = i32
    lib.dft_ragged_exchange.argtypes = [vp, vp, i32, i32, i64, i32, vp]
    lib.dft_ragged_exchange.restype = i32
    lib.dft_ragged_exchange_args_size.argtypes = []
    lib.dft_ragged_exchange_args_size.restype = i32
    lib.dft_ragged_exchange_fold.argtypes = [vp, vp, i32, i32, i64, i32, i32, i32, vp, vp, vp, vp, i32, vp]
    lib.dft_ragged_exchange_fold.restype = i32
    lib.dft_enable_peer_access.argtypes = [i32, i32]
    lib.dft_enable_peer_access.restype = i32
    for name, struct in (("dft_fused_stage_program_size", _CProgram), ("dft_ragged_exchange_args_size", ExchangeArgs)):
        if getattr(lib, name)() != ctypes.sizeof(struct):
            raise ExecutionError(f"{struct.__name__}'s layout differs between Python and CUDA")
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry reports a non-zero cudaGetLastError()."""
    if rc != 0:
        raise ExecutionError(f"{what}: CUDA error {rc}")
