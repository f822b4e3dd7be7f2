"""Flash attention, forward and backward: hand-written CUDA kernels for
Hopper, each with its plain PyTorch version beside it.

The kernels replace the five Pallas kernels of the JAX package
(`videosys_tpu/ops/flash_attention.py`):

* `csrc/flash_fwd.cu`: `_single_pass_kernel` and the blocked `_flash_kernel`
  (a short-row kernel for rows of at most 16 queries and keys, a wgmma kernel
  of two 64-row warpgroups for heads up to 128 wide and one for wider heads,
  all with an optional log-sum-exp output);
* `csrc/flash_bwd_fused.cu`: `_flash_bwd_kernel` -> `flash_bwd_fused` (dq,
  dk, dv from q, k, v, mask and dO alone) for bf16 and fp16: a statistics
  kernel and a thread-block-cluster kernel, or one short-row kernel;
* `csrc/flash_bwd_dq.cu`: `_flash_bwd_dq_kernel` -> `flash_bwd_dq` (dq from
  the forward's log-sum-exp and output, and di = rowsum(dO * O), which it
  computes first and writes out) for bf16 and fp16: a wgmma kernel of two
  warpgroups owning 128 q rows;
* `csrc/flash_bwd_dkv.cu`: `_flash_bwd_dkv_kernel` -> `flash_bwd_dkv` (dk,
  dv from the log-sum-exp and that di) for bf16 and fp16: a wgmma kernel of
  two warpgroups owning 128 keys;
* `csrc/flash_bwd.cu`: the fp32 `flash_bwd_fused`, `flash_bwd_dkv` and
  `flash_bwd_dq`.

`FlashAttentionFunction` takes the place of the JAX package's custom-VJP
glue: its forward decides which backward will run (`backward_variant`) and
saves the output and the log-sum-exp only for the blocked pair, whose
backward runs `flash_bwd_dq` (which writes di) and then `flash_bwd_dkv`.

The sources are compiled with `nvcc` into shared libraries with a C
interface at first use, into `build/kernels/` at the repository root, and
loaded with `ctypes`; importing this module builds nothing.

`flash_attention` launches kernels for CUDA tensors and runs the plain
versions for CPU tensors, nothing else: a CUDA tensor a kernel cannot take
raises. When no input needs a gradient it launches the forward kernel
alone. `LAUNCHES` counts kernel launches: forward launches by the CUDA
variant launched (`kernel_variant`: `short`, `narrow`, `wgmma`, `f32`), backward
launches by kernel (`bwd_fused`: the statistics + cluster kernels,
`bwd_fused_short`: the short-row kernel, `bwd_dkv`, `bwd_dq`; fp32 inputs,
which take the SIMT variants, count under `*_f32`).
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
from typing import Dict, Optional

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 512
# widest head the narrow forward takes: each of its two warpgroups keeps a
# 64-row accumulator of up to 128 columns in registers; wider heads take the
# wide kernel, whose two warpgroups split 256 or 512 padded columns
NARROW_MAX_HEAD_DIM = 128
# rows of at most this many queries and keys take the short-row kernels
# (one warp per (batch, head) on a 16 x 16 tile), forward and backward
SHORT_ROWS = 16
# widest head the backward kernels take (accumulators in registers)
BWD_MAX_HEAD_DIM = 128

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SOURCES = {"fwd": _CSRC / "flash_fwd.cu", "bwd": _CSRC / "flash_bwd.cu",
            "bwd_fused": _CSRC / "flash_bwd_fused.cu",
            "bwd_dkv": _CSRC / "flash_bwd_dkv.cu",
            "bwd_dq": _CSRC / "flash_bwd_dq.cu"}
_HEADERS = (_CSRC / "flash_common.cuh", _CSRC / "wgmma.cuh",
            _CSRC / "tma.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Dispatch of the backward. For bf16 and fp16 `flash_bwd_fused` is a
# statistics kernel (grid over q tiles) and a cluster kernel in which each
# block of a thread-block cluster owns FUSED_KEYS_PER_BLOCK keys of one
# (batch, head): a portable cluster has at most FUSED_MAX_CLUSTER blocks, so
# it takes rows of up to 512 keys; rows of at most SHORT_ROWS queries
# and keys take the short-row kernel (one warp per (batch, head)). Longer rows
# go to the blocked pair, and so do long q rows with too few blocks to fill
# the card (fewer than NUM_SMS, more than FUSED_MAX_TILE_PAIRS 64 x 64 tile
# pairs each): the pair's grids also spread over the q tiles. The fp32 fused
# kernel gives one block to each (batch, head) and keeps two fp32 statistics
# per q row in shared memory beside its tiles, so the 227 KB a block may use
# limit its row count. Where both routes take a 16-bit row, the card's
# numbers decide (`tools/bwd_dispatch.py`, the pair's dq kernel computing the
# di = rowsum(dO * O) its dk/dv kernel reads): the fused backward up to
# FUSED_MAX_KEYS keys (the training path's 8-token captions), the pair above.
# (The pair was faster from 8 keys up in two calls, at 8 keys by the least.)
SMEM_PER_BLOCK = 232448
NUM_SMS = 132
FUSED_MAX_TILE_PAIRS = 1024
FUSED_KEYS_PER_BLOCK = 64
FUSED_MAX_CLUSTER = 8
FUSED_MAX_KEYS = 8
# ring stages of the narrow forward and the dq kernel (K, V) and of the dk/dv
# kernel (Q, dO, lse, di); warps of a short-row block
NARROW_STAGES = 3
DKV_STAGES = 3
DQ_STAGES = 3
SHORT_WARPS = 8

LAUNCHES = {"short": 0, "narrow": 0, "wgmma": 0, "f32": 0,
            "bwd_fused": 0, "bwd_fused_short": 0, "bwd_dkv": 0, "bwd_dq": 0,
            "bwd_fused_f32": 0, "bwd_dkv_f32": 0, "bwd_dq_f32": 0}
_libs: Dict[str, ctypes.CDLL] = {}
build_info: dict = {}


def kernel_variant(dtype: torch.dtype, Nq: int, Nk: int, head_dim: int) -> str:
    """The forward kernel `csrc/flash_fwd.cu` launches for these shapes
    (`fwd_variant` there): "f32" (SIMT) for fp32; for bf16 and fp16 "short"
    (rows of at most SHORT_ROWS queries and keys, heads up to 128),
    "narrow" (wgmma, two warpgroups of 64 q rows, heads up to 128) or
    "wgmma" (the wide kernel, heads of 129 to 512)."""
    if dtype == torch.float32:
        return "f32"
    if head_dim > NARROW_MAX_HEAD_DIM:
        return "wgmma"
    return "short" if Nq <= SHORT_ROWS and Nk <= SHORT_ROWS else "narrow"


def _padded_width(D: int) -> int:
    """The columns a head of D takes in the shared memory of the short,
    narrow and backward kernels: the next of 32, 64, 80, 128."""
    return 32 if D <= 32 else 64 if D <= 64 else 80 if D <= 80 else 128


def narrow_smem_bytes(D: int) -> int:
    """Shared memory the narrow forward asks for (`narrow_smem_bytes` in
    csrc/flash_fwd.cu): Q of 128 rows and NARROW_STAGES stages of a K and a
    V tile of 64 rows at the padded width, 64 key flags a stage, an 8-byte
    mbarrier a stage and one for Q."""
    return (2 + 2 * NARROW_STAGES) * 64 * _padded_width(D) * 2 \
        + NARROW_STAGES * 64 + (NARROW_STAGES + 1) * 8


def short_fwd_smem_bytes(D: int) -> int:
    """Shared memory the short-row forward asks for (`short_smem_bytes` in
    csrc/flash_fwd.cu): per warp a Q, a K and a V tile of 16 rows, rows
    padded by 8 elements."""
    return SHORT_WARPS * 3 * 16 * (_padded_width(D) + 8) * 2


def dkv_smem_bytes(D: int) -> int:
    """Shared memory the 16-bit dk/dv kernel asks for (`dkv_smem_bytes` in
    csrc/flash_bwd_dkv.cu): K and V of 128 keys, DKV_STAGES stages of a Q
    and a dO tile of 64 rows and their fp32 lse and di, an 8-byte mbarrier a
    stage and one for K and V."""
    return (4 + 2 * DKV_STAGES) * 64 * _padded_width(D) * 2 \
        + DKV_STAGES * 2 * 64 * 4 + (DKV_STAGES + 1) * 8


def dq_smem_bytes(D: int) -> int:
    """Shared memory the 16-bit dq kernel asks for (`dq_smem_bytes` in
    csrc/flash_bwd_dq.cu): Q and dO of 128 rows and DQ_STAGES stages of a K
    and a V tile of 64 rows at the padded width, 64 key flags a stage, an
    8-byte mbarrier a stage and one for Q and dO."""
    return (4 + 2 * DQ_STAGES) * 64 * _padded_width(D) * 2 \
        + DQ_STAGES * 64 + (DQ_STAGES + 1) * 8


def wide_smem_bytes(head_dim: int) -> int:
    """Shared memory the wgmma forward asks for (`wide_smem_bytes` in
    csrc/flash_fwd.cu): Q, one K and one V tile of 64 rows at the padded
    width (256 or 512), two 64 x 64 fp32 score halves, key flags."""
    dp = 256 if -(-head_dim // 16) * 16 <= 256 else 512
    return 3 * 64 * dp * 2 + 2 * 32 * 128 * 4 + 2 * 64


def fused_kernel_smem_bytes(which: str, D: int) -> int:
    """Shared memory a block of the 16-bit fused backward asks for
    (`flash_bwd_fused_mma_smem` in csrc/flash_bwd_fused.cu). "stats": Q, dO
    and two buffers each of K and V, 64 rows; "cluster": K and V of 64 keys,
    two buffers each of Q and dO, the dS^T tile, two buffers of received
    fp32 dq shares (70 rows), row statistics: two blocks fit an SM at
    head_dim 72; "short": per warp four 16-row tiles and the P and dS
    tiles."""
    dp = _padded_width(D)
    if which == "stats":
        return 6 * 64 * dp * 2 + 2 * 64
    if which == "cluster":
        return ((2 * FUSED_KEYS_PER_BLOCK + 4 * 64) * dp * 2
                + 64 * 64 * 2 + 2 * 70 * dp * 4 + 4 * 64 * 4)
    if which == "short":
        return 8 * (4 * 16 * (dp + 8) + 2 * 16 * 24) * 2
    raise ValueError(which)


def fused_smem_bytes(Nq: int, D: int) -> int:
    """Shared memory the fp32 `flash_bwd_fused` asks for (the formula of
    `flash_bwd_fused_smem` in csrc/flash_bwd.cu): four 64-row tiles, the P
    and dS tiles, 64 key flags, and 8 bytes of row statistics per q row
    padded to 64."""
    stats = 2 * (-(-Nq // 64) * 64) * 4
    ld = (-(-D // 16) * 16) | 1
    return (4 * 64 * ld + 2 * 64 * 65) * 4 + 64 + stats


def fused_kind(Nq: int, Nk: int, dtype: torch.dtype) -> Optional[str]:
    """The kernel `flash_bwd_fused` launches for these shapes: "f32" (SIMT,
    one block per (batch, head)), "short" (rows of at most 16 queries and
    keys), "cluster" (statistics + cluster kernels, up to 512 keys), or
    None where it takes none (`flash_bwd_fused_mma_kind` in the source)."""
    if dtype == torch.float32 or dtype == torch.float64:
        return "f32"
    if Nq <= SHORT_ROWS and Nk <= SHORT_ROWS:
        return "short"
    if Nk <= FUSED_MAX_CLUSTER * FUSED_KEYS_PER_BLOCK:
        return "cluster"
    return None


def backward_variant(B: int, H: int, Nq: int, Nk: int, D: int,
                     dtype: torch.dtype) -> str:
    """Which backward `FlashAttentionFunction` runs for these shapes:
    "fused" (`flash_bwd_fused`, nothing saved but q, k, v) or "blocked"
    (`flash_bwd_dq` + `flash_bwd_dkv`, which need the forward's output and
    log-sum-exp). Shapes alone decide, on every device."""
    kind = fused_kind(Nq, Nk, dtype)
    if kind is None or (kind == "cluster" and Nk > FUSED_MAX_KEYS):
        return "blocked"
    if kind == "f32" and fused_smem_bytes(Nq, D) > SMEM_PER_BLOCK:
        return "blocked"
    blocks = B * H
    if kind == "cluster":
        blocks *= -(-Nk // FUSED_KEYS_PER_BLOCK)
    tile_pairs = -(-Nq // 64) * -(-Nk // 64)
    if blocks < NUM_SMS and tile_pairs > FUSED_MAX_TILE_PAIRS:
        return "blocked"
    return "fused"


def backward_launch_keys(variant: str, dtype: torch.dtype, Nq: int,
                         Nk: int) -> tuple:
    """The `LAUNCHES` keys one backward of `variant` adds one to, at rows of
    Nq queries and Nk keys (the fused backward counts its short-row kernel
    under its own key)."""
    if variant != "fused":
        names = ("bwd_dkv", "bwd_dq")
    elif fused_kind(Nq, Nk, dtype) == "short":
        names = ("bwd_fused_short",)
    else:
        names = ("bwd_fused",)
    suffix = "_f32" if dtype == torch.float32 else ""
    return tuple(n + suffix for n in names)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---- plain versions -------------------------------------------------------

def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q, k, scale, kv_mask):
    acc = _acc_dtype(q)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], DEFAULT_MASK_VALUE)
    return s


def flash_attention_plain(q, k, v, scale=None, kv_mask=None,
                          return_lse: bool = False):
    """The forward kernel's math in plain PyTorch: fp32 scores and softmax,
    masked keys at DEFAULT_MASK_VALUE (a fully masked row averages v over
    its Nk keys), probabilities cast to q's dtype before the PV product.
    q: [B, H, Nq, D]; k, v: [B, H, Nk, D]; kv_mask: [B, Nk] bool. With
    `return_lse` also the fp32 log-sum-exp of the scaled scores [B, H, Nq]
    (DEFAULT_MASK_VALUE itself for a fully masked row)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale, kv_mask)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.matmul(p, v).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(lse <= 0.5 * DEFAULT_MASK_VALUE,
                      torch.full_like(lse, DEFAULT_MASK_VALUE), lse)
    return out, lse


def _grads_from(p, ds, q, k, do, scale, kv_mask):
    """dq, dk, dv from P and dS (fp32), both rounded to the inputs' dtype
    before their products as the kernels round them. A masked score is a
    constant, so dS is 0 there (P already is, except in a fully masked
    row)."""
    acc = _acc_dtype(q)
    if kv_mask is not None:
        ds = ds.masked_fill(~kv_mask[:, None, None, :], 0.0)
    ds = ds.to(q.dtype).to(acc)
    p = p.to(q.dtype).to(acc)
    dq = torch.matmul(ds, k.to(acc)) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(k.dtype)


def flash_attention_bwd_plain(q, k, v, kv_mask, do, scale=None):
    """`flash_bwd_fused`'s math in plain PyTorch: (dq, dk, dv) from q, k,
    v, the mask and dO alone. P = softmax(S) is recomputed, delta =
    rowsum(P * dP), dS = P * (dP - delta)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    p = torch.softmax(_scores(q, k, scale, kv_mask), dim=-1)
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    delta = (p * dp).sum(-1, keepdim=True)
    return _grads_from(p, p * (dp - delta), q, k, do, scale, kv_mask)


def flash_attention_bwd_lse_plain(q, k, v, kv_mask, do, o, lse, scale=None):
    """`flash_bwd_dkv` + `flash_bwd_dq`'s math in plain PyTorch: P = exp(S -
    lse) from the forward's log-sum-exp [B, H, Nq] (a fully masked row,
    lse = DEFAULT_MASK_VALUE, has P = 1/Nk), delta = rowsum(dO * O)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    s = _scores(q, k, scale, kv_mask)
    lse = lse.to(acc)
    dead = lse <= 0.5 * DEFAULT_MASK_VALUE
    lse = torch.where(dead, torch.full_like(lse, DEFAULT_MASK_VALUE), lse)
    p = torch.exp(s - lse[..., None])
    p = torch.where(dead[..., None], p / k.shape[2], p)
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    delta = (do.to(acc) * o.to(acc)).sum(-1, keepdim=True)
    return _grads_from(p, p * (dp - delta), q, k, do, scale, kv_mask)


# ---- plain versions of how the kernels combine partial results -------------

def scores_by_depth_halves_plain(q, k, scale, padded: int):
    """The wgmma forward's scores: head_dim zero-padded to `padded` (256 or
    512), each warpgroup's product over one half of the depth, the two fp32
    halves summed. Equals `_scores` without a mask."""
    acc = _acc_dtype(q)
    pad = padded - q.shape[-1]
    qp = torch.nn.functional.pad(q.to(acc), (0, pad))
    kp = torch.nn.functional.pad(k.to(acc), (0, pad))
    half = padded // 2
    halves = [torch.matmul(qp[..., lo:lo + half],
                           kp[..., lo:lo + half].transpose(-1, -2))
              for lo in (0, half)]
    return (halves[0] + halves[1]) * scale


def row_stats_by_key_tiles_plain(q, k, v, kv_mask, do, scale=None,
                                 tile: int = 64):
    """The statistics kernel's running merge: per 64-key tile a row's (max,
    sum of e, sum of e * dP), rescaled into the running triple. Returns the
    log-sum-exp of the scaled scores (DEFAULT_MASK_VALUE for a fully masked
    row) and delta = rowsum(P * dP), both [B, H, Nq]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    s_all = _scores(q, k, scale, kv_mask)
    dp_all = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    m = torch.full(s_all.shape[:-1], -math.inf, dtype=acc)
    l = torch.zeros_like(m)
    d = torch.zeros_like(m)
    for k0 in range(0, k.shape[2], tile):
        s, dp = s_all[..., k0:k0 + tile], dp_all[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.max(-1).values)
        alpha = torch.exp(m - m_new)
        e = torch.exp(s - m_new[..., None])
        l = l * alpha + e.sum(-1)
        d = d * alpha + (e * dp).sum(-1)
        m = m_new
    lse = torch.where(m <= 0.5 * DEFAULT_MASK_VALUE,
                      torch.full_like(m, DEFAULT_MASK_VALUE), m + torch.log(l))
    return lse, d / l


def _scores_log2(q, k, scale, kv_mask, key_rows: bool = False):
    """Scores in log2 units as the tile kernels make them: q k^T times
    scale * log2(e) in fp32, masked keys set to DEFAULT_MASK_VALUE after the
    scaling. With `key_rows` the transposed tile, keys by rows (k q^T)."""
    acc = _acc_dtype(q)
    a, b = (k, q) if key_rows else (q, k)
    s = torch.matmul(a.to(acc), b.to(acc).transpose(-1, -2)) * (scale * LOG2E)
    if kv_mask is not None:
        keep = kv_mask[:, None, :, None] if key_rows else kv_mask[:, None, None, :]
        s = s.masked_fill(~keep, DEFAULT_MASK_VALUE)
    return s


def flash_attention_by_key_tiles_plain(q, k, v, scale=None, kv_mask=None,
                                       return_lse: bool = False,
                                       tile: int = 64):
    """The narrow forward's online softmax in plain PyTorch: the keys in
    `tile`-key tiles, scores in log2 units, a running (max, sum of 2^(s -
    max), acc) per row that each tile rescales, P rounded to q's dtype before
    its product, the sum divided out once at the end. With `return_lse` also
    the natural log-sum-exp [B, H, Nq] (DEFAULT_MASK_VALUE for a fully masked
    row). Equals `flash_attention_plain` up to rounding."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    s_all = _scores_log2(q, k, scale, kv_mask)
    m = torch.full(s_all.shape[:-1], -math.inf, dtype=acc)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape, dtype=acc)
    for k0 in range(0, k.shape[2], tile):
        s = s_all[..., k0:k0 + tile]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.matmul(
            p.to(q.dtype).to(acc), v[:, :, k0:k0 + tile].to(acc))
        m = m_new
    out = (o / l[..., None]).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(m <= 0.5 * DEFAULT_MASK_VALUE,
                      torch.full_like(m, DEFAULT_MASK_VALUE),
                      (m + torch.log2(l)) / LOG2E)
    return out, lse


def flash_bwd_dkv_by_key_blocks_plain(q, k, v, kv_mask, do, lse, di,
                                      scale=None, keys: int = 128,
                                      q_tile: int = 64):
    """`flash_bwd_dkv`'s split in plain PyTorch: per block of `keys` keys
    (two warpgroups of 64 on the card) dk and dv summed over the q rows in
    `q_tile`-row tiles from the transposed tiles S^T and dP^T, P^T = 2^(S^T -
    lse log2(e)) from the forward's natural log-sum-exp [B, H, Nq] (a fully
    masked row, lse = DEFAULT_MASK_VALUE, has P = 1/Nk), dS^T = P^T (dP^T -
    di), both rounded to the inputs' dtype before their products. Returns
    (dk, dv), equal to those of `flash_attention_bwd_lse_plain` up to
    rounding."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    Nq, Nk = q.shape[2], k.shape[2]
    lse, di = lse.to(acc), di.to(acc)
    dead = lse <= 0.5 * DEFAULT_MASK_VALUE
    lse2 = torch.where(dead, torch.full_like(lse, DEFAULT_MASK_VALUE),
                       lse * LOG2E)
    pmul = torch.where(dead, torch.full_like(lse, 1.0 / Nk),
                       torch.ones_like(lse))
    dks, dvs = [], []
    for k0 in range(0, Nk, keys):
        kr, vr = k[:, :, k0:k0 + keys], v[:, :, k0:k0 + keys]
        mr = None if kv_mask is None else kv_mask[:, k0:k0 + keys]
        dk = torch.zeros(kr.shape, dtype=acc)
        dv = torch.zeros(kr.shape, dtype=acc)
        for q0 in range(0, Nq, q_tile):
            rows = slice(q0, q0 + q_tile)
            qt, dot = q[:, :, rows].to(acc), do[:, :, rows].to(acc)
            st = _scores_log2(qt, kr, scale, mr, key_rows=True)
            p = torch.exp2(st - lse2[:, :, None, rows]) * pmul[:, :, None, rows]
            dpt = torch.matmul(vr.to(acc), dot.transpose(-1, -2))
            ds = p * (dpt - di[:, :, None, rows])
            if mr is not None:
                ds = ds.masked_fill(~mr[:, None, :, None], 0.0)
            dv = dv + torch.matmul(p.to(q.dtype).to(acc), dot)
            dk = dk + torch.matmul(ds.to(q.dtype).to(acc), qt)
        dks.append(dk * scale)
        dvs.append(dv)
    return torch.cat(dks, 2).to(k.dtype), torch.cat(dvs, 2).to(k.dtype)


def flash_bwd_dq_by_q_blocks_plain(q, k, v, kv_mask, do, lse, out, scale=None,
                                   rows: int = 128, tile: int = 64):
    """`flash_bwd_dq`'s split in plain PyTorch: per block of `rows` q rows
    (two warpgroups of 64 on the card) di = rowsum(dO * O) from the block's
    own dO and O, then dq summed over the keys in `tile`-key tiles from S and
    dP, P = 2^(S - lse log2(e)) from the forward's natural log-sum-exp [B, H,
    Nq], P = 0 at a masked key (a masked score is a constant; a fully masked
    row attends to none), dS = P (dP - di) rounded to the inputs' dtype before
    its product. Returns (dq, di [B, H, Nq] fp32), equal to the dq of
    `flash_attention_bwd_lse_plain` and its delta up to rounding."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    Nq, Nk = q.shape[2], k.shape[2]
    lse = lse.to(acc)
    lse2 = torch.where(lse <= 0.5 * DEFAULT_MASK_VALUE,
                       torch.full_like(lse, DEFAULT_MASK_VALUE), lse * LOG2E)
    dqs, dis = [], []
    for q0 in range(0, Nq, rows):
        sl = slice(q0, q0 + rows)
        qb, dob = q[:, :, sl].to(acc), do[:, :, sl].to(acc)
        di = (dob * out[:, :, sl].to(acc)).sum(-1)
        dq = torch.zeros(qb.shape, dtype=acc)
        for k0 in range(0, Nk, tile):
            kt, vt = k[:, :, k0:k0 + tile].to(acc), v[:, :, k0:k0 + tile].to(acc)
            s = torch.matmul(qb, kt.transpose(-1, -2)) * (scale * LOG2E)
            p = torch.exp2(s - lse2[:, :, sl, None])
            if kv_mask is not None:
                p = p.masked_fill(~kv_mask[:, None, None, k0:k0 + tile], 0.0)
            dp = torch.matmul(dob, vt.transpose(-1, -2))
            ds = (p * (dp - di[..., None])).to(q.dtype).to(acc)
            dq = dq + torch.matmul(ds, kt)
        dqs.append(dq * scale)
        dis.append(di)
    return torch.cat(dqs, 2).to(q.dtype), torch.cat(dis, 2).float()


def cluster_key_ranges(Nk: int) -> list:
    """[(first key, keys)] of the blocks of one cluster: the 16-key groups of
    a row dealt out evenly over ceil(Nk / 64) blocks, as
    `flash_bwd_cluster_mma` deals them."""
    blocks = -(-Nk // FUSED_KEYS_PER_BLOCK)
    groups = -(-Nk // 16)
    base, extra = divmod(groups, blocks)
    out = []
    for rank in range(blocks):
        first = (rank * base + min(rank, extra)) * 16
        n = (base + (rank < extra)) * 16
        out.append((first, min(n, Nk - first)))
    return out


def flash_attention_bwd_cluster_plain(q, k, v, kv_mask, do, scale=None):
    """`flash_bwd_fused`'s cluster design in plain PyTorch: row statistics
    from the running merge over key tiles, then per block of a cluster (its
    key range) P = exp(S - lse), dS, the block's dk and dv, and its share of
    dq; the shares are summed in rank order (the kernel deals the rows of a
    share out to the blocks, each of which sums its rows in that order).
    Equals `flash_attention_bwd_plain`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    acc = _acc_dtype(q)
    lse, delta = row_stats_by_key_tiles_plain(q, k, v, kv_mask, do, scale)
    dead = lse <= 0.5 * DEFAULT_MASK_VALUE
    Nk = k.shape[2]
    dq = torch.zeros_like(q, dtype=acc)
    dks, dvs = [], []
    for first, n in cluster_key_ranges(Nk):
        kr, vr = k[:, :, first:first + n], v[:, :, first:first + n]
        mr = None if kv_mask is None else kv_mask[:, first:first + n]
        s = _scores(q, kr, scale, mr)
        p = torch.exp(s - lse[..., None])
        p = torch.where(dead[..., None], p / Nk, p)
        dp = torch.matmul(do.to(acc), vr.to(acc).transpose(-1, -2))
        ds = p * (dp - delta[..., None])
        if mr is not None:
            ds = ds.masked_fill(~mr[:, None, None, :], 0.0)
        dq = dq + torch.matmul(ds, kr.to(acc))  # rank order
        dks.append(torch.matmul(ds.transpose(-1, -2), q.to(acc)) * scale)
        dvs.append(torch.matmul(p.transpose(-1, -2), do.to(acc)))
    return ((dq * scale).to(q.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(k.dtype))


# ---- build and load -------------------------------------------------------

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Dict[str, Path]:
    """Compile the kernel libraries whose sources have not been built yet
    (one `nvcc` per source, started together) and return their paths by
    name ("fwd", "bwd", "bwd_fused", "bwd_dkv", "bwd_dq"). A file name carries the hash of its
    source and the shared headers, so an edited source builds anew."""
    header = b"".join(h.read_bytes() for h in _HEADERS)
    libs, running = {}, []
    t0 = time.perf_counter()
    for name, source in _SOURCES.items():
        digest = hashlib.sha256(header + source.read_bytes()).hexdigest()[:12]
        lib = BUILD_DIR / f"libflash_{name}_{digest}.so"
        libs[name] = lib
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(source)]
        running.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for name, lib, tmp, proc in running:
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    if running:
        build_info.update(seconds=time.perf_counter() - t0,
                          log="".join(logs))
    build_info.setdefault("seconds", 0.0)
    build_info.setdefault("log", "")
    return libs


def _library(name: str):
    if name not in _libs:
        paths = build()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd = ctypes.CDLL(str(paths["fwd"]))
        fwd.flash_fwd.argtypes = [ptr] * 6 + [i32] * 6 + [f32, i32, ptr]
        fwd.flash_fwd_variant.argtypes = [i32] * 4
        fwd.flash_fwd_smem.argtypes = [i32, i32]
        fwd.flash_fwd_smem.restype = ctypes.c_long
        bwd = ctypes.CDLL(str(paths["bwd"]))
        tail = [i32] * 6 + [f32, i32, ptr]
        tail32 = [i32] * 5 + [f32, ptr]  # fp32 only: no dtype, no `vec`
        bwd.flash_bwd_fused.argtypes = [ptr] * 8 + tail32
        bwd.flash_bwd_dkv.argtypes = [ptr] * 9 + tail32
        bwd.flash_bwd_dq.argtypes = [ptr] * 9 + tail32
        bwd.flash_bwd_fused_smem.argtypes = [i32, i32]
        bwd.flash_bwd_fused_smem.restype = ctypes.c_long
        fused = ctypes.CDLL(str(paths["bwd_fused"]))
        fused.flash_bwd_fused_mma.argtypes = [ptr] * 9 + tail
        fused.flash_bwd_fused_mma_kind.argtypes = [i32, i32, i32]
        fused.flash_bwd_fused_mma_smem.argtypes = [i32, i32]
        fused.flash_bwd_fused_mma_smem.restype = ctypes.c_long
        dkv = ctypes.CDLL(str(paths["bwd_dkv"]))
        dkv.flash_bwd_dkv_wgmma.argtypes = [ptr] * 9 + tail
        dkv.flash_bwd_dkv_wgmma_smem.argtypes = [i32]
        dkv.flash_bwd_dkv_wgmma_smem.restype = ctypes.c_long
        dq = ctypes.CDLL(str(paths["bwd_dq"]))
        dq.flash_bwd_dq_wgmma.argtypes = [ptr] * 9 + tail
        dq.flash_bwd_dq_wgmma_smem.argtypes = [i32]
        dq.flash_bwd_dq_wgmma_smem.restype = ctypes.c_long
        for lib, fns, err in (
                (fwd, ("flash_fwd", "flash_fwd_variant"),
                 "flash_fwd_error_string"),
                (dkv, ("flash_bwd_dkv_wgmma",),
                 "flash_bwd_dkv_wgmma_error_string"),
                (dq, ("flash_bwd_dq_wgmma",),
                 "flash_bwd_dq_wgmma_error_string"),
                (bwd, ("flash_bwd_fused", "flash_bwd_dkv", "flash_bwd_dq"),
                 "flash_bwd_error_string"),
                (fused, ("flash_bwd_fused_mma", "flash_bwd_fused_mma_kind"),
                 "flash_bwd_fused_mma_error_string")):
            for fn in fns:
                getattr(lib, fn).restype = i32
            getattr(lib, err).argtypes = [i32]
            getattr(lib, err).restype = ctypes.c_char_p
        _libs.update(fwd=fwd, bwd=bwd, bwd_fused=fused, bwd_dkv=dkv,
                     bwd_dq=dq)
    return _libs[name]


# ---- launches -------------------------------------------------------------

def _check(q, k, v, scale, kv_mask, max_head_dim):
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must match q's device and dtype")
        if t.shape != (B, H, Nk, D):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(B, H, Nk, D)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernel takes fp32/bf16/fp16, not {q.dtype}")
    if not 0 < D <= max_head_dim or Nq == 0 or Nk == 0:
        raise ValueError(f"unsupported shape q={tuple(q.shape)}, Nk={Nk}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if kv_mask is not None:
        if kv_mask.dtype != torch.bool or kv_mask.shape != (B, Nk) \
                or kv_mask.device != q.device or not kv_mask.is_contiguous():
            raise ValueError("kv_mask must be a contiguous [B, Nk] bool "
                             "tensor on q's device")
    return 1.0 / math.sqrt(D) if scale is None else float(scale)


def _vec(D: int, *tensors) -> int:
    """1 when rows can be copied in 16-byte chunks."""
    return int(D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _launch(q, k, v, scale, kv_mask, save_lse: bool = False):
    """Forward kernel: the output, and the fp32 log-sum-exp [B, H, Nq] when
    `save_lse` (else None)."""
    scale = _check(q, k, v, scale, kv_mask, MAX_HEAD_DIM)
    B, H, Nq, D = q.shape
    lib = _library("fwd")
    out = torch.empty_like(q)
    lse = torch.empty(B, H, Nq, dtype=torch.float32, device=q.device) \
        if save_lse else None
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
        out.data_ptr(), _ptr(lse), _DTYPE_CODES[q.dtype], B * H, H, Nq,
        k.shape[2], D, scale, _vec(D, q, k, v, out),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: "
                           + lib.flash_fwd_error_string(err).decode())
    LAUNCHES[kernel_variant(q.dtype, Nq, k.shape[2], D)] += 1
    return out, lse


def _check_bwd(q, k, v, scale, kv_mask, do):
    scale = _check(q, k, v, scale, kv_mask, BWD_MAX_HEAD_DIM)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError("dO must be contiguous and match q")
    return scale


def _raise_bwd(lib, name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.flash_bwd_error_string(err).decode())


def flash_bwd_fused(q, k, v, kv_mask, do, scale=None):
    """Launch `flash_bwd_fused`: (dq, dk, dv) of CUDA tensors. bf16 and fp16
    take the short-row kernel, or the statistics kernel and the cluster
    kernel (one count under `bwd_fused`; the row statistics pass between
    them through 8 bytes per row of scratch); fp32 the SIMT kernel."""
    scale = _check_bwd(q, k, v, scale, kv_mask, do)
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    kind = fused_kind(Nq, Nk, q.dtype)
    if kind is None:
        raise ValueError(f"flash_bwd_fused takes at most "
                         f"{FUSED_MAX_CLUSTER * FUSED_KEYS_PER_BLOCK} keys "
                         f"in {q.dtype}, not {Nk}")
    if kind == "f32" and fused_smem_bytes(Nq, D) > SMEM_PER_BLOCK:
        raise ValueError(f"flash_bwd_fused cannot hold the statistics of "
                         f"{Nq} rows in shared memory")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if kind == "f32":
        lib = _library("bwd")
        err = lib.flash_bwd_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B * H, H, Nq, Nk, D, scale, stream)
        _raise_bwd(lib, "flash_bwd_fused", err)
    else:
        lib = _library("bwd_fused")
        stats = torch.empty(2, B * H, Nq, dtype=torch.float32,
                            device=q.device) if kind == "cluster" else None
        err = lib.flash_bwd_fused_mma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            do.data_ptr(), _ptr(stats), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _DTYPE_CODES[q.dtype], B * H, H, Nq, Nk, D, scale,
            _vec(D, q, k, v, do, dq), stream)
        if err != 0:
            raise RuntimeError(
                "flash_bwd_fused launch failed: "
                + lib.flash_bwd_fused_mma_error_string(err).decode())
    LAUNCHES[backward_launch_keys("fused", q.dtype, Nq, Nk)[0]] += 1
    return dq, dk, dv


def _check_stats(q, **stats):
    for name, t in stats.items():
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous fp32 [B, H, Nq] "
                             f"tensor on q's device")


def flash_bwd_dkv(q, k, v, kv_mask, do, lse, di, scale=None):
    """Launch `flash_bwd_dkv`: (dk, dv) of CUDA tensors from the forward's
    log-sum-exp and di = rowsum(dO * O) (`flash_bwd_dq` writes it), both
    fp32 [B, H, Nq]. bf16 and fp16 take the wgmma kernel of
    csrc/flash_bwd_dkv.cu, fp32 the SIMT kernel of csrc/flash_bwd.cu."""
    scale = _check_bwd(q, k, v, scale, kv_mask, do)
    _check_stats(q, lse=lse, di=di)
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    if q.dtype == torch.float32:
        lib = _library("bwd")
        _raise_bwd(lib, "flash_bwd_dkv", lib.flash_bwd_dkv(
            *ptrs, B * H, H, Nq, Nk, D, scale, stream))
    else:
        lib = _library("bwd_dkv")
        err = lib.flash_bwd_dkv_wgmma(
            *ptrs, _DTYPE_CODES[q.dtype], B * H, H, Nq, Nk, D, scale,
            _vec(D, q, k, v, do, dk, dv), stream)
        if err != 0:
            raise RuntimeError("flash_bwd_dkv launch failed: "
                               + lib.flash_bwd_dkv_wgmma_error_string(err).decode())
    LAUNCHES[backward_launch_keys("blocked", q.dtype, Nq, Nk)[0]] += 1
    return dk, dv


def flash_bwd_dq(q, k, v, kv_mask, do, lse, out, scale=None):
    """Launch `flash_bwd_dq`: (dq, di) of CUDA tensors from the forward's
    log-sum-exp (fp32 [B, H, Nq]) and output `out`; di = rowsum(dO * O),
    fp32 [B, H, Nq], is computed by the kernel first and is what
    `flash_bwd_dkv` reads. bf16 and fp16 take the wgmma kernel of
    csrc/flash_bwd_dq.cu, fp32 the SIMT kernel of csrc/flash_bwd.cu."""
    scale = _check_bwd(q, k, v, scale, kv_mask, do)
    _check_stats(q, lse=lse)
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device \
            or not out.is_contiguous():
        raise ValueError("the forward's output must be contiguous and match q")
    B, H, Nq, D = q.shape
    Nk = k.shape[2]
    dq = torch.empty_like(q)
    di = torch.empty(B, H, Nq, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            do.data_ptr(), out.data_ptr(), lse.data_ptr(), di.data_ptr(),
            dq.data_ptr())
    if q.dtype == torch.float32:
        lib = _library("bwd")
        _raise_bwd(lib, "flash_bwd_dq", lib.flash_bwd_dq(
            *ptrs, B * H, H, Nq, Nk, D, scale, stream))
    else:
        lib = _library("bwd_dq")
        err = lib.flash_bwd_dq_wgmma(
            *ptrs, _DTYPE_CODES[q.dtype], B * H, H, Nq, Nk, D, scale,
            _vec(D, q, k, v, do, out, dq), stream)
        if err != 0:
            raise RuntimeError("flash_bwd_dq launch failed: "
                               + lib.flash_bwd_dq_wgmma_error_string(err).decode())
    LAUNCHES[backward_launch_keys("blocked", q.dtype, Nq, Nk)[1]] += 1
    return dq, di


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with the kernels' own backward. `apply(q, k, v, kv_mask,
    scale, backward)`: `backward` is "fused", "blocked" or None for
    `backward_variant`'s choice. The forward saves q, k, v and the mask,
    and for the blocked pair also the output and the log-sum-exp. CUDA
    tensors launch the kernels; CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, backward=None):
        B, H, Nq, D = q.shape
        variant = backward or backward_variant(B, H, Nq, k.shape[2], D,
                                               q.dtype)
        if variant not in ("fused", "blocked"):
            raise ValueError(f"unknown backward {variant!r}")
        need_lse = variant == "blocked"
        if q.device.type == "cuda":
            out, lse = _launch(q, k, v, scale, kv_mask, save_lse=need_lse)
        elif need_lse:
            out, lse = flash_attention_plain(q, k, v, scale, kv_mask,
                                             return_lse=True)
        else:
            out, lse = flash_attention_plain(q, k, v, scale, kv_mask), None
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, kv_mask,
                              out if need_lse else None, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        do = do.contiguous()
        on_card = q.device.type == "cuda"
        if lse is None:
            fn = flash_bwd_fused if on_card else flash_attention_bwd_plain
            dq, dk, dv = fn(q, k, v, kv_mask, do, ctx.scale)
        elif on_card:
            # the dq kernel computes di = rowsum(dO * O) for the dk/dv kernel
            dq, di = flash_bwd_dq(q, k, v, kv_mask, do, lse, out, ctx.scale)
            dk, dv = flash_bwd_dkv(q, k, v, kv_mask, do, lse, di, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_lse_plain(
                q, k, v, kv_mask, do, out, lse, ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Non-causal attention. q: [B, H, Nq, D]; k, v: [B, H, Nk, D];
    kv_mask: optional [B, Nk] bool, True = attend. CUDA tensors launch the
    kernels (or raise); CPU tensors run the plain versions. When an input
    needs a gradient the call goes through `FlashAttentionFunction`, whose
    backward is `flash_bwd_fused` or `flash_bwd_dq` + `flash_bwd_dkv` on the
    card; otherwise only the forward kernel is launched."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, kv_mask, scale, None)
    if q.device.type == "cuda":
        return _launch(q, k, v, scale, kv_mask)[0]
    return flash_attention_plain(q, k, v, scale=scale, kv_mask=kv_mask)
