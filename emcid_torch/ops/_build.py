"""Build and bind the hand-written CUDA kernels under ``emcid_torch/csrc``.

Each ``.cu`` file is compiled with its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``build/kernels/`` at the repo root (gitignored), named by a hash of the
sources, so an edited kernel is rebuilt and an unchanged one is reused.
Nothing is built at import: the first kernel launch builds.

Every wrapper that launches a kernel adds one to its entry in ``LAUNCHES``
right after the launch, so a run can show which kernels it went through.
K1-K4, K5b and K6b have several routes (one C entry point each, picked in
Python); their launches are also counted per route in ``ROUTES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_v2.cu", "short_kv.cu", "groupnorm.cu", "layernorm.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("K1 flash_v2_fwd", "K2 flash_v2_dq", "K3 flash_v2_dkv",
           "K4 short_kv_fwd", "K5f groupnorm_fwd", "K5b groupnorm_bwd",
           "K6f layernorm_fwd", "K6b layernorm_bwd")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
ROUTES: Dict[str, Dict[str, int]] = {
    "K1 flash_v2_fwd": {"mma": 0, "d512": 0, "fma": 0},
    "K2 flash_v2_dq": {"mma": 0, "fma": 0},
    "K3 flash_v2_dkv": {"mma": 0, "fma": 0},
    "K4 short_kv_fwd": {"mma": 0, "fma": 0},
    "K5b groupnorm_bwd": {"resident": 0, "stream": 0},
    "K6b layernorm_bwd": {"rows": 0, "generic": 0},
}
# int32 counters of the norm backwards' in-kernel fold (csrc/common.cuh),
# per device
FOLD_COUNTERS = 64

_lib: Optional[ctypes.CDLL] = None
_sms: Dict[int, int] = {}
_counters: Dict[int, torch.Tensor] = {}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {
    # q, k, v, o, lse, B, H, N, M, D, scale, dtype, stream: K1's fma, mma
    # and d512 routes
    "emcid_flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    "emcid_flash_fwd_mma": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    "emcid_flash_fwd_d512": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, dout, lse, delta, dq, B, H, N, M, D, scale, dtype, stream:
    # K2's fma and mma routes
    "emcid_flash_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    "emcid_flash_dq_mma": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, B, H, N, M, D, scale, dtype,
    # stream: K3's fma and mma routes
    "emcid_flash_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    "emcid_flash_dkv_mma": [_P] * 8 + [_I] * 5 + [_F, _I, _P],
    # q, k, v, o, B, H, N, M, D, scale, dtype, stream: K4's fma and mma
    # routes
    "emcid_short_kv_fwd": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    "emcid_short_kv_fwd_mma": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
    # x, gamma, beta, y, stats, B, C, S, G, eps, act, dtype, pdtype, stream
    "emcid_gn_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # x, g, gamma, beta, stats, dx, dgamma, dbeta, part, counters, B, C, S,
    # G, act, dtype, pdtype, stream: K5b's resident and stream routes
    "emcid_gn_bwd_resident": [_P] * 10 + [_I] * 7 + [_P],
    "emcid_gn_bwd": [_P] * 10 + [_I] * 7 + [_P],
    # x, gamma, beta, y, rows, C, eps, act, dtype, pdtype, stream
    "emcid_ln_fwd": [_P] * 4 + [_L, _I, _F, _I, _I, _I, _P],
    # x, g, gamma, beta, dx, dgamma, dbeta, part, counters, rows, C, eps,
    # act, nblocks, dtype, pdtype, stream: K6b's rows and generic routes
    "emcid_ln_bwd_rows": [_P] * 9 + [_L, _I, _F, _I, _I, _I, _I, _P],
    "emcid_ln_bwd": [_P] * 9 + [_L, _I, _F, _I, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for routes in ROUTES.values():
        for route in routes:
            routes[route] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (one nvcc each, in parallel) and link the
    library; returns its path.  The compiler's register/spill report is
    kept beside it in ``ptxas.log``."""
    out = BUILD_DIR / f"libemcid_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src}\n{text}")
        if proc.returncode:
            failed.append(src)
    (BUILD_DIR / "ptxas.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(".so.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    tmp.replace(out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.emcid_error_string.argtypes = [ctypes.c_int]
        handle.emcid_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def check_cuda_inputs(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one
    supported dtype on one device."""
    first = tensors[0]
    dtype_code(first)
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: inputs differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def run(name: str, fn_name: str, *args, route: Optional[str] = None) -> None:
    """Call a C entry point, raise on a CUDA error, count the launch (and
    its route, for the kernels listed in ``ROUTES``)."""
    handle = lib()
    err = getattr(handle, fn_name)(*args)
    if err:
        msg = handle.emcid_error_string(err).decode()
        raise RuntimeError(f"{name}: launch failed with CUDA error {err} "
                           f"({msg})")
    LAUNCHES[name] += 1
    if route is not None:
        ROUTES[name][route] += 1


def aligned16(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary (the
    tensor-core routes copy 16-byte pieces)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def sm_count(t: torch.Tensor) -> int:
    """The SM count of the card ``t`` lies on, read once per device."""
    idx = t.device.index
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def fold_groups(parts: int) -> int:
    """Groups of the two-level fold over ``parts`` blocks' partial rows
    (``fold_group_size`` in ``csrc/common.cuh``: ceil(sqrt(parts)) blocks a
    group)."""
    size = math.isqrt(parts - 1) + 1
    return -(-parts // size)


def fold_counters(t: torch.Tensor, n: int) -> torch.Tensor:
    """The fold counters of the device ``t`` lies on, zeroed once: every
    backward leaves them at 0 again.  The port runs on one stream; two
    backwards running at once on two streams would need a set each."""
    if n > FOLD_COUNTERS:
        raise ValueError(f"the fold needs {n} counters, more than "
                         f"{FOLD_COUNTERS}")
    idx = t.device.index
    if idx not in _counters:
        _counters[idx] = torch.zeros(FOLD_COUNTERS, dtype=torch.int32,
                                     device=t.device)
    return _counters[idx]
