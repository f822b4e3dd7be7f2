"""The redesigned kernels' dispatch and their ways of combining partial
results, on the CPU. (a) `kernel_variant`, `backward_variant`, `fused_kind`,
`backward_launch_keys` and the Python mirrors of the kernels' shared-memory
formulas, at the main paths' shapes and at the edges where the route changes,
never above the 232,448 bytes a block may ask for. (b) Plain PyTorch versions
of the ways the kernels split the work (two halves of the depth summed into
one score tile; the narrow forward's online softmax over 64-key tiles in
exp2 units; row statistics merged over key tiles; key ranges of a cluster
with their dq shares summed in rank order; dk and dv per block of 128 keys
over 64-row q tiles; dq and di = rowsum(dO * O) per block of 128 q rows over
64-key tiles), held against the unblocked plain versions at 1e-5
(forward) and 1e-4 (gradients) and, through the Pallas kernels in interpret
mode, against the JAX package. The CUDA kernels themselves are held against
the plain versions on a card (test_torch_port_kernel.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.ops.flash_attention import (
    _flash_attention_bwd_blocked_impl, _flash_attention_fwd_impl)
from videosys_tpu.ops.flash_attention import flash_attention as jax_flash
from videosys_tpu_torch.ops import flash_attention as fa

SMEM_LIMIT = 232448
# an SM's shared memory, of which each resident block also takes 1 KB
SM_SMEM = 233472
BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32


# ---- (a) dispatch ----------------------------------------------------------

@pytest.mark.parametrize("dtype,Nq,Nk,D,want", [
    (BF16, 1590, 1590, 72, "narrow"), (FP16, 1590, 1590, 128, "narrow"),
    (BF16, 1590, 1590, 129, "wgmma"), (BF16, 6360, 6360, 256, "wgmma"),
    (FP16, 6360, 6360, 257, "wgmma"), (BF16, 6360, 6360, 512, "wgmma"),
    (FP32, 1590, 1590, 129, "f32"), (FP32, 6360, 6360, 512, "f32"),
    # short rows: at most 16 queries and 16 keys, heads up to 128
    (BF16, 15, 15, 72, "short"), (BF16, 16, 16, 72, "short"),
    (FP16, 1, 1, 8, "short"), (BF16, 15, 15, 128, "short"),
    (BF16, 17, 16, 72, "narrow"), (BF16, 16, 17, 72, "narrow"),
    (BF16, 17, 17, 72, "narrow"), (BF16, 15, 15, 129, "wgmma"),
    (FP32, 15, 15, 72, "f32"), (FP32, 16, 16, 128, "f32"),
    # cross attention: 1590 queries against a bucketed caption
    (BF16, 1590, 64, 72, "narrow"), (BF16, 1590, 16, 72, "narrow"),
    # more than SINGLE_PASS_MAX_KV keys: CogVideoX's joint rows, Open-Sora-
    # Plan v1.2's self-attention, the 1080p training row; the JAX line at
    # 4096 keys; Vchitect's cross rows (333 keys) stay on narrow, and so
    # does a long row whose D % 8 != 0 (TMA copies 16-byte rows)
    (BF16, 17776, 17776, 64, "long"), (BF16, 9600, 9600, 96, "long"),
    (FP16, 8160, 8160, 72, "long"), (BF16, 4096, 4096, 72, "narrow"),
    (BF16, 4097, 4097, 72, "long"), (BF16, 34920, 333, 64, "narrow"),
    (BF16, 64, 4200, 128, "long"), (BF16, 8160, 8160, 76, "narrow"),
    (FP32, 17776, 17776, 64, "f32"), (BF16, 9600, 9600, 129, "wgmma"),
])
def test_forward_route_by_head_dim(dtype, Nq, Nk, D, want):
    assert fa.kernel_variant(dtype, Nq, Nk, D) == want
    assert want in fa.LAUNCHES


@pytest.mark.parametrize("D,padded", [(129, 256), (200, 256), (256, 256),
                                      (257, 512), (300, 512), (512, 512)])
def test_wide_forward_shared_memory(D, padded):
    want = 3 * 64 * padded * 2 + 2 * 64 * 64 * 4 + 128
    assert fa.wide_smem_bytes(D) == want <= SMEM_LIMIT


@pytest.mark.parametrize("fn", [fa.narrow_smem_bytes, fa.short_fwd_smem_bytes,
                                fa.dkv_smem_bytes, fa.dq_smem_bytes])
@pytest.mark.parametrize("D", [8, 32, 33, 64, 72, 80, 81, 128])
def test_redesigned_kernels_shared_memory(fn, D):
    n = fn(D)
    assert 0 < n <= SMEM_LIMIT
    assert n <= fn(128)  # a wider head never asks for less


@pytest.mark.parametrize("D", range(8, 129, 8))
def test_long_forward_shared_memory(D):
    """`flash_fwd_long` at every head width it takes: within the 227 KB a
    block may ask for, never less for a wider head, at least two K/V stages,
    and one block an SM, as its design states (its warpgroups fill the
    register file: 128 * 24 + 256 * 240 or 128 * 32 + 384 * 160)."""
    n = fa.long_smem_bytes(D)
    assert 0 < n <= SMEM_LIMIT
    assert all(n <= fa.long_smem_bytes(w) for w in range(D, 129, 8))
    assert 2 <= fa.long_stages(D) <= fa.LONG_MAX_STAGES
    assert n + 1024 <= SM_SMEM < 2 * (n + 1024)


@pytest.mark.parametrize("D,consumers,stages", [(64, 3, 4), (72, 2, 4),
                                                (96, 2, 4), (128, 2, 3)])
def test_long_forward_ring(D, consumers, stages):
    """Q of 64 rows a consumer warpgroup (three at 64 padded columns, two
    above) and `stages` stages of a K and a V tile of 128 keys at the
    head's own width (D = 96 is not padded to 128), 128 key flags and four
    8-byte mbarriers a stage, one mbarrier for Q."""
    dp = fa._long_width(D)
    assert dp == {64: 64, 72: 80, 96: 96, 128: 128}[D]
    assert fa.long_consumers(D) == consumers
    assert fa.long_stages(D) == stages
    assert fa.long_smem_bytes(D) == 64 * consumers * dp * 2 + stages * (
        2 * fa.LONG_KEYS * dp * 2 + fa.LONG_KEYS + 4 * 8) + 8


@pytest.mark.parametrize("D,blocks", [(32, 2), (64, 2), (72, 2), (80, 2),
                                      (128, 1)])
def test_narrow_forward_blocks_per_sm(D, blocks):
    """Two blocks of the narrow forward (two warpgroups each) share an SM up
    to 80 padded columns, as its launch bounds ask; 128 columns take one."""
    n = fa.narrow_smem_bytes(D)
    assert blocks * (n + 1024) <= SM_SMEM
    if D == 72:
        # Q 128 x 80, three stages of K and V 64 x 80, bf16; 64 key flags
        # a stage; four 8-byte mbarriers
        assert n == (128 + 3 * 2 * 64) * 80 * 2 + 3 * 64 + 4 * 8


@pytest.mark.parametrize("D", [8, 32, 64, 72, 80, 128])
def test_dq_kernel_shared_memory(D):
    """Q and dO of 128 rows and three stages of a K and a V tile of 64 rows
    at the padded width, bf16; 64 key flags a stage; four 8-byte mbarriers:
    about 101 KB at D = 72, so two blocks fit an SM up to 80 columns."""
    dp = 32 if D <= 32 else 64 if D <= 64 else 80 if D <= 80 else 128
    n = fa.dq_smem_bytes(D)
    assert n == (2 * 64 + 2 * 64 + 3 * 2 * 64) * dp * 2 + 3 * 64 + 4 * 8
    assert (2 if dp <= 80 else 1) * (n + 1024) <= SM_SMEM


@pytest.mark.parametrize("which", ["stats", "cluster", "short"])
@pytest.mark.parametrize("D", [8, 32, 33, 64, 72, 80, 81, 128])
def test_fused_backward_shared_memory(which, D):
    n = fa.fused_kernel_smem_bytes(which, D)
    assert 0 < n <= SMEM_LIMIT
    # a wider head never asks for less
    assert n <= fa.fused_kernel_smem_bytes(which, 128)


@pytest.mark.parametrize("Nq,Nk,dtype,want", [
    (405, 405, BF16, "cluster"), (405, 300, BF16, "cluster"),
    (405, 8, BF16, "cluster"), (15, 15, BF16, "short"),
    (16, 16, FP16, "short"), (17, 16, BF16, "cluster"),
    (16, 17, BF16, "cluster"), (1, 1, BF16, "short"),
    (8160, 512, BF16, "cluster"), (64, 513, BF16, None),
    (8160, 8160, FP16, None), (15, 15, FP32, "f32"), (64, 5000, FP32, "f32"),
])
def test_fused_kind(Nq, Nk, dtype, want):
    assert fa.fused_kind(Nq, Nk, dtype) == want


@pytest.mark.parametrize("shape,dtype,want,keys", [
    # 16-bit rows of more than FUSED_MAX_KEYS keys take the pair
    ((30, 16, 405, 405, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((30, 16, 405, 256, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((30, 16, 405, 257, 72), FP16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((30, 16, 405, 9, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((60, 16, 144, 7, 72), FP16, "fused", ("bwd_fused",)),
    ((30, 16, 405, 300, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((810, 16, 15, 15, 72), BF16, "fused", ("bwd_fused_short",)),
    ((30, 16, 405, 8, 72), BF16, "fused", ("bwd_fused",)),
    ((60, 16, 144, 144, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((2, 16, 700, 512, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((2, 16, 700, 513, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((3, 2, 405, 405, 72), FP32, "fused", ("bwd_fused_f32",)),
    ((30, 16, 1590, 1590, 72), FP16, "blocked", ("bwd_dkv", "bwd_dq")),
    # one (batch, head), 256 q tiles x 8 key tiles: too few blocks
    ((1, 1, 16320, 512, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
    ((3, 2, 15, 15, 72), FP32, "fused", ("bwd_fused_f32",)),
    ((1, 1, 26000, 64, 72), FP32, "blocked", ("bwd_dkv_f32", "bwd_dq_f32")),
])
def test_backward_route_and_keys(shape, dtype, want, keys):
    B, H, Nq, Nk, D = shape
    assert fa.backward_variant(*shape, dtype) == want
    assert fa.backward_launch_keys(want, dtype, Nq, Nk) == keys
    assert all(key in fa.LAUNCHES for key in keys)


@pytest.mark.parametrize("Nq,ok", [(64, True), (14000, True), (15000, False)])
def test_fp32_fused_statistics_fit(Nq, ok):
    assert (fa.fused_smem_bytes(Nq, 72) <= SMEM_LIMIT) == ok


@pytest.mark.parametrize("Nk", [1, 15, 16, 63, 64, 65, 128, 129, 300, 405,
                                500, 512])
def test_cluster_key_ranges(Nk):
    ranges = fa.cluster_key_ranges(Nk)
    assert len(ranges) == -(-Nk // 64) <= fa.FUSED_MAX_CLUSTER
    assert ranges[0][0] == 0 and sum(n for _, n in ranges) == Nk
    for (a, n), (b, _) in zip(ranges, ranges[1:]):
        assert a + n == b and n % 16 == 0
    sizes = [-(-n // 16) for _, n in ranges]  # 16-key groups per block
    assert max(sizes) <= 4 and max(sizes) - min(sizes) <= 1


# ---- (b) the combinations ---------------------------------------------------

def _inputs(B, H, Nq, Nk, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, H, Nq, D), (B, H, Nk, D), (B, H, Nk, D), (B, H, Nq, D)))


def _mask(Nk, lens):
    return None if lens is None else \
        np.arange(Nk)[None] < np.array(lens)[:, None]


@pytest.mark.parametrize("D,padded", [(130, 256), (256, 256), (300, 512),
                                      (512, 512)])
def test_depth_halves_sum_to_the_scores(D, padded):
    q, k, _, _ = _inputs(2, 1, 37, 53, D, seed=D)
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    got = fa.scores_by_depth_halves_plain(q, k, 0.11, padded)
    torch.testing.assert_close(got, fa._scores(q, k, 0.11, None),
                               atol=1e-5, rtol=1e-5)


CASES = [
    # B, H, Nq, Nk, D, real lengths (None: no mask; 0: a fully masked row)
    (2, 2, 150, 405, 24, None),         # seven key ranges, ragged tails
    (3, 1, 70, 300, 72, (300, 77, 0)),  # five ranges, masked keys, dead row
    (2, 2, 33, 65, 16, (65, 1)),        # two ranges, one key attended
    (1, 2, 100, 129, 32, None),         # three ranges
]


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", CASES)
def test_row_statistics_merge(B, H, Nq, Nk, D, lens):
    """Merging per-tile (max, sum, sum of e * dP) gives the row's
    log-sum-exp and delta."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, H, Nq, Nk, D, Nk))
    mask = _mask(Nk, lens)
    mask = None if mask is None else torch.from_numpy(mask)
    lse, delta = fa.row_stats_by_key_tiles_plain(q, k, v, mask, do)
    out, want_lse = fa.flash_attention_plain(q, k, v, None, mask,
                                             return_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(delta, (do * out).sum(-1), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", CASES)
def test_cluster_design_matches_unblocked_plain(B, H, Nq, Nk, D, lens):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, H, Nq, Nk, D, Nq))
    mask = _mask(Nk, lens)
    mask = None if mask is None else torch.from_numpy(mask)
    got = fa.flash_attention_bwd_cluster_plain(q, k, v, mask, do)
    want = fa.flash_attention_bwd_plain(q, k, v, mask, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    if mask is not None:
        dead = (~mask)[:, None, :, None].expand_as(got[1])
        live_row = mask.any(1)[:, None, None, None].expand_as(got[1])
        # masked keys get exactly zero, except in a fully masked row (P = 1/Nk)
        assert bool((got[1][dead] == 0).all())
        assert bool((got[2][dead & live_row] == 0).all())


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", [
    c for c in CASES if c[5] is None or 0 not in c[5]])
def test_cluster_design_matches_jax_kernels(B, H, Nq, Nk, D, lens):
    """Against `jax.grad` of the Pallas kernels in interpret mode (the JAX
    kernels differ on fully masked rows, which stay with the test above)."""
    q, k, v, ct = _inputs(B, H, Nq, Nk, D, seed=3)
    mask = _mask(Nk, lens)
    jm = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jnp.vdot(jax_flash(q, k, v, kv_mask=jm, interpret=True), ct)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    got = fa.flash_attention_bwd_cluster_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), torch.from_numpy(ct))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", CASES + [
    (2, 2, 15, 15, 72, (15, 0)),   # short rows, one fully masked
    (1, 1, 130, 64, 72, None),     # one key tile, 130 rows: a ragged block
])
def test_key_tile_forward_matches_unblocked_plain(B, H, Nq, Nk, D, lens):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, H, Nq, Nk, D, Nk))
    mask = _mask(Nk, lens)
    mask = None if mask is None else torch.from_numpy(mask)
    got, lse = fa.flash_attention_by_key_tiles_plain(q, k, v, None, mask,
                                                     return_lse=True)
    want, want_lse = fa.flash_attention_plain(q, k, v, None, mask,
                                              return_lse=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


def _jax_forward(q, k, v, mask, save_lse):
    """The JAX package's forward in interpret mode: `_single_pass_kernel`
    (whole key row) without the log-sum-exp, the KV-blocked `_flash_kernel`
    (128-key blocks) with it; (out, lse [B, H, Nq] or None) as numpy."""
    B, H, Nq, _ = q.shape
    jm = None if mask is None else jnp.asarray(mask)
    res = _flash_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, None, 128, 128,
        True, save_lse=save_lse)
    if not save_lse:
        return np.asarray(res), None
    out, lse = res
    return np.asarray(out), np.asarray(lse)[:, :Nq, 0].reshape(B, H, Nq)


LIVE_CASES = [c for c in CASES if c[5] is None or 0 not in c[5]]


@pytest.mark.parametrize("save_lse", [False, True])
@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", LIVE_CASES)
def test_key_tile_forward_matches_jax_kernels(B, H, Nq, Nk, D, lens, save_lse):
    """The narrow forward's split against `_single_pass_kernel` and, with the
    log-sum-exp, `_flash_kernel` (the JAX kernels differ on fully masked
    rows, which stay with the test above)."""
    q, k, v, _ = _inputs(B, H, Nq, Nk, D, seed=5)
    mask = _mask(Nk, lens)
    want, want_lse = _jax_forward(q, k, v, mask, save_lse)
    got, lse = fa.flash_attention_by_key_tiles_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), None,
        None if mask is None else torch.from_numpy(mask), return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if save_lse:
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5,
                                   rtol=1e-5)


# rows of more than 4096 keys (flash_fwd_long's): ragged q and key tails,
# the first long row, a ragged mask, a fully masked row, each padded width
LONG_CASES = [
    # B, H, Nq, Nk, D, real lengths (None: no mask; 0: a fully masked row)
    (1, 2, 64, 4200, 64, None),
    (2, 1, 130, 4097, 72, (4097, 1000)),
    (2, 1, 70, 4500, 96, (4500, 0)),
    (1, 1, 129, 4224, 128, None),
]


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", LONG_CASES)
def test_long_forward_plain_matches_unblocked_plain(B, H, Nq, Nk, D, lens):
    """`flash_fwd_long`'s plain version (the online softmax over 128-key
    tiles) against the unblocked plain version, output and log-sum-exp."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, H, Nq, Nk, D, Nk))
    mask = _mask(Nk, lens)
    mask = None if mask is None else torch.from_numpy(mask)
    got, lse = fa.flash_attention_long_plain(q, k, v, None, mask,
                                             return_lse=True)
    want, want_lse = fa.flash_attention_plain(q, k, v, None, mask,
                                              return_lse=True)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("D", [64, 96])
def test_long_forward_plain_matches_jax_kernel(D):
    """Against the JAX package's `_flash_kernel` (interpret mode), the kernel
    it takes above 4096 keys, under a ragged mask (the JAX kernels differ on
    fully masked rows), at the JAX package's 2e-5."""
    q, k, v, _ = _inputs(1, 2, 64, 4200, D, seed=D)
    mask = _mask(4200, (3001,))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), kv_mask=jnp.asarray(mask),
                                interpret=True))
    got = fa.flash_attention_long_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), None,
        torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("D", [72, 128])
def test_long_forward_lse_matches_jax_kernel(D):
    """The log-sum-exp the blocked backward reads, against
    `_flash_attention_fwd_impl(save_lse=True)`."""
    q, k, v, _ = _inputs(2, 1, 70, 4300, D, seed=D + 1)
    mask = _mask(4300, (4300, 2222))
    want, want_lse = _jax_forward(q, k, v, mask, save_lse=True)
    got, lse = fa.flash_attention_long_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), None,
        torch.from_numpy(mask), return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", CASES + [
    (2, 1, 70, 128, 72, (128, 40)),  # one full block of 128 keys
    (1, 2, 65, 129, 32, None),       # a second block of one key
])
def test_dkv_key_blocks_match_unblocked_plain(B, H, Nq, Nk, D, lens):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, H, Nq, Nk, D, Nq))
    mask = _mask(Nk, lens)
    mask = None if mask is None else torch.from_numpy(mask)
    out, lse = fa.flash_attention_plain(q, k, v, None, mask, return_lse=True)
    di = (do * out).sum(-1)
    got = fa.flash_bwd_dkv_by_key_blocks_plain(q, k, v, mask, do, lse, di)
    want = fa.flash_attention_bwd_lse_plain(q, k, v, mask, do, out, lse)[1:]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    if mask is not None:
        # masked keys of rows that attend to something get exactly zero
        dead = ((~mask) & mask.any(1, keepdim=True))[:, None, :, None]
        assert not bool(got[0].masked_select(dead).any())
        assert not bool(got[1].masked_select(dead).any())


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", LIVE_CASES)
def test_dkv_key_blocks_match_jax_kernel(B, H, Nq, Nk, D, lens):
    """dk and dv per block of 128 keys against `_flash_bwd_dkv_kernel` in
    interpret mode, both fed the JAX forward's output and log-sum-exp."""
    q, k, v, do = _inputs(B, H, Nq, Nk, D, seed=7)
    mask = _mask(Nk, lens)
    jm = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, jlse = _flash_attention_fwd_impl(jq, jk, jv, jm, None, 128, 128, True,
                                          save_lse=True)
    _, dk, dv = _flash_attention_bwd_blocked_impl(jq, jk, jv, jm, jdo, out,
                                                  jlse, None, True)
    lse = torch.from_numpy(np.asarray(jlse)[:, :Nq, 0].reshape(B, H, Nq))
    out, tdo = torch.from_numpy(np.asarray(out)), torch.from_numpy(do)
    got = fa.flash_bwd_dkv_by_key_blocks_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), tdo, lse,
        (tdo * out).sum(-1))
    for g, w in zip(got, (dk, dv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_stub_text_encoder_resolves_its_device():
    from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder

    y, m = StubTextEncoder(8, 4, device="cpu").encode(["a b"])
    assert y.device.type == "cpu" and m.sum().item() == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StubTextEncoder(8, 4)


DQ_EDGES = [
    (2, 1, 127, 100, 72, (100, 0)),  # one block short of 128 rows, dead row
    (1, 2, 128, 70, 32, None),       # one full block
    (2, 1, 129, 65, 72, (65, 30)),   # a second block of one row
    (1, 1, 149, 130, 24, None),      # 21 rows past a block
]


def _dq_inputs(B, H, Nq, Nk, D, lens, seed):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B, H, Nq, Nk, D, seed))
    mask = _mask(Nk, lens)
    return q, k, v, do, None if mask is None else torch.from_numpy(mask)


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", CASES + DQ_EDGES)
def test_dq_q_blocks_match_unblocked_plain(B, H, Nq, Nk, D, lens):
    """dq and di per block of 128 q rows over 64-key tiles against the
    unblocked plain backward (1e-4) and rowsum(dO * O) (1e-5 relative)."""
    q, k, v, do, mask = _dq_inputs(B, H, Nq, Nk, D, lens, Nq + Nk)
    out, lse = fa.flash_attention_plain(q, k, v, None, mask, return_lse=True)
    dq, di = fa.flash_bwd_dq_by_q_blocks_plain(q, k, v, mask, do, lse, out)
    want = fa.flash_attention_bwd_lse_plain(q, k, v, mask, do, out, lse)[0]
    torch.testing.assert_close(dq, want, atol=1e-4, rtol=1e-4)
    want_di = (do * out).sum(-1)
    assert di.dtype == torch.float32 and di.shape == (B, H, Nq)
    assert (di - want_di).abs().max() <= 1e-5 * want_di.abs().max()
    if mask is not None and not mask.all(1).all():
        dead = ~mask.any(1)
        # a fully masked batch row attends to no key: no dq at all
        assert not bool(dq[dead].any())


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", LIVE_CASES)
def test_dq_q_blocks_match_jax_kernel(B, H, Nq, Nk, D, lens):
    """dq per block of 128 q rows against `_flash_bwd_dq_kernel` in
    interpret mode, both fed the JAX forward's output and log-sum-exp."""
    q, k, v, do = _inputs(B, H, Nq, Nk, D, seed=11)
    mask = _mask(Nk, lens)
    jm = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out, jlse = _flash_attention_fwd_impl(jq, jk, jv, jm, None, 128, 128, True,
                                          save_lse=True)
    dq, _, _ = _flash_attention_bwd_blocked_impl(jq, jk, jv, jm, jdo, out,
                                                 jlse, None, True)
    lse = torch.from_numpy(np.asarray(jlse)[:, :Nq, 0].reshape(B, H, Nq))
    got, di = fa.flash_bwd_dq_by_q_blocks_plain(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), torch.from_numpy(do),
        lse, torch.from_numpy(np.asarray(out)))
    np.testing.assert_allclose(got.numpy(), np.asarray(dq), atol=1e-4,
                               rtol=1e-4)
    want_di = (do * np.asarray(out)).sum(-1)
    assert np.abs(di.numpy() - want_di).max() <= 1e-5 * np.abs(want_di).max()
