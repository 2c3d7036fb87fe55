"""Builds the CUDA sources under ``csrc/`` into one shared library with a plain
C interface and loads it with ctypes.

The build runs at first use, with ``nvcc -gencode arch=compute_90a,code=sm_90a``
for Hopper, into ``kernels/build/`` (git-ignored): one ``nvcc -c`` per source,
all started together, then one link. The library's file name
carries a hash of the sources and their headers (``*.cu``, ``*.cuh``), so an
edited source or header is rebuilt and a stale library is never loaded. Nothing here runs at import time: this module is
imported on machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, so ctypes passes them as 64-bit values)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, w, xs, ws, out, M, K, N, splits, rows per split, out_kind, stream
    "mq_w4a8_gemv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w, xs, ws, out, M, K, N, splits, rows per split, out_kind, stream
    "mq_int8_gemv": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, ldx, w, xs, ws, out, M, K, N, w4, out_kind, tokens per block, stream
    "mq_int8_gemm": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # the same arguments (any N)
    "mq_int8_gemm_ragged": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P],
    # q, k_new, v_new, k_cache, v_cache, pos, start, out, part, counters,
    # pos_all, start_all, B, S, H, KVH, splits, scale, stream
    "mq_attn_decode": [_P] * 10 + [_I] * 7 + [_F, _P],
    # q, k, v, out, B, T, H, KVH, scale, stream
    "mq_flash_attn_causal": [_P] * 4 + [_I] * 4 + [_F, _P],
    # x, w, ws, out, M, K, N, splits, rows per split, stream
    "mq_w8_bf16_gemv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w, acc, M, K, N, splits, rows per split, variant, stream
    "mq_w4_unpack_gemv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # g, u, ldg, ldu, A, Bt, scale, out, T, K, qmin, qmax, in_f32, blocks,
    # sub-rows per chunk, ring slots, stream
    "mq_fused_swiglu_had_quant": [_P, _P, _I, _I, _P, _P, _P, _P] + [_I] * 8
                                 + [_P],
    # g, u, ldg, ldu, gs, us, A, Bt, scale, out, T, K, qmin, qmax, blocks,
    # sub-rows per chunk, ring slots, stream
    "mq_dequant_swiglu_had_quant": [_P, _P, _I, _I] + [_P] * 6 + [_I] * 7
                                   + [_P],
    # x, ldx, A, Bt, scale, out, T, K, qmin, qmax, in_f32, blocks, sub-rows
    # per chunk, ring slots, stream
    "mq_had_quant": [_P, _I, _P, _P, _P, _P] + [_I] * 8 + [_P],
    # x, ldx, w, scale, out, T, n, eps, qmin, qmax, stream
    "mq_rms_norm_quant": [_P, _I, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    # x, ldx, sign(hadK), c, hm, out, T, K, is_f32, blocks, ring slots,
    # stream
    "mq_fwht": [_P, _I, _P, _F, _F, _P] + [_I] * 5 + [_P],
    # x, ldx, At, hm, out, T, K, is_f32, stream
    "mq_fwht_dense": [_P, _I, _P, _F, _P, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libmquant_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; their stderr, or raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    errs = [p.communicate()[1] for p in procs]  # waits for every one
    for p, err in zip(procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{err}")
    return errs


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the sources if their library is missing. Returns (path,
    seconds spent compiling; 0.0 when the library was already there)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    compile_cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
                     "-fPIC", *(["-Xptxas=-v"] if verbose else []), "-c",
                     "-o", str(obj), str(src)]
                    for src, obj in zip(_sources(), objs)]
    t0 = time.perf_counter()
    try:
        errs = _run_all(compile_cmds)
        errs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *(str(o) for o in objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    dt = time.perf_counter() - t0
    if verbose and any(errs):
        print("".join(errs), flush=True)
    os.replace(tmp, out)
    return out, dt


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
