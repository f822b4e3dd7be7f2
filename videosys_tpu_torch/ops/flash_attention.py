"""Flash-attention forward: hand-written CUDA kernel for Hopper, with its
plain PyTorch version beside it.

The kernel (`csrc/flash_fwd.cu`) replaces both forward Pallas kernels of the
JAX package (`videosys_tpu/ops/flash_attention.py`: `_single_pass_kernel`
and the blocked `_flash_kernel`). It is compiled with `nvcc` into a shared
library with a C interface at first use, into `build/kernels/` at the
repository root, and loaded with `ctypes`; importing this module builds
nothing.

`flash_attention` launches the kernel for CUDA tensors and runs
`flash_attention_plain` for CPU tensors, nothing else: a CUDA tensor the
kernel cannot take raises. `LAUNCHES` counts kernel launches by the CUDA
variant launched (`kernel_variant`), so a run can show that its attention
went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
MAX_HEAD_DIM = 512
# widest head (padded to a multiple of 16) whose accumulator one block holds
# in registers; wider heads split their output columns over blocks
MMA_MAX_PADDED_D = 128

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "flash_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

LAUNCHES = {"mma": 0, "mma_split": 0, "f32": 0}
_lib = None
build_info: dict = {}


def kernel_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The `__global__` variant `csrc/flash_fwd.cu` launches: the SIMT
    kernel for fp32, else the tensor-core kernel, with output-column splits
    when the padded head is wider than MMA_MAX_PADDED_D."""
    if dtype == torch.float32:
        return "f32"
    padded = -(-head_dim // 16) * 16
    return "mma" if padded <= MMA_MAX_PADDED_D else "mma_split"


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def flash_attention_plain(q, k, v, scale=None, kv_mask=None):
    """The kernel's math in plain PyTorch: fp32 scores and softmax, masked
    keys at DEFAULT_MASK_VALUE (a fully masked row averages v over its Nk
    keys), probabilities cast to q's dtype before the PV product.
    q: [B, H, Nq, D]; k, v: [B, H, Nk, D]; kv_mask: [B, Nk] bool."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], DEFAULT_MASK_VALUE)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(q.dtype)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Path:
    """Compile the kernel library if this source has not been built yet and
    return its path. The file name carries the source's hash, so an edited
    source builds anew."""
    src = _SOURCE.read_bytes()
    lib = BUILD_DIR / f"libflash_fwd_{hashlib.sha256(src).hexdigest()[:12]}.so"
    if lib.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "")
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    build_info.update(seconds=time.perf_counter() - t0, log=res.stderr)
    return lib


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.flash_fwd.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_fwd.restype = ctypes.c_int
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(q, k, v, scale, kv_mask):
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
        if t.shape != (B, H, Nk, D):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(B, H, Nk, D)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes fp32/bf16/fp16, not {q.dtype}")
    if not 0 < D <= MAX_HEAD_DIM or Nq == 0 or Nk == 0:
        raise ValueError(f"unsupported shape q={tuple(q.shape)}, Nk={Nk}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if kv_mask is not None:
        if kv_mask.dtype != torch.bool or kv_mask.shape != (B, Nk) \
                or kv_mask.device != q.device or not kv_mask.is_contiguous():
            raise ValueError("kv_mask must be a contiguous [B, Nk] bool "
                             "tensor on q's device")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    lib = _library()
    out = torch.empty_like(q)
    vec = int(D % 8 == 0 and all(t.data_ptr() % 16 == 0
                                 for t in (q, k, v, out)))
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None, out.data_ptr(),
        _DTYPE_CODES[q.dtype], B * H, H, Nq, Nk, D, float(scale), vec,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.flash_fwd_error_string(err).decode())
    LAUNCHES[kernel_variant(q.dtype, D)] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Non-causal attention. q: [B, H, Nq, D]; k, v: [B, H, Nk, D];
    kv_mask: optional [B, Nk] bool, True = attend. CUDA tensors launch the
    kernel (or raise); CPU tensors run `flash_attention_plain`."""
    if q.device.type == "cuda":
        return _launch(q, k, v, scale, kv_mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, kv_mask=kv_mask)
    raise ValueError(f"no flash attention for device {q.device}")
