"""The redesigned kernels' dispatch and their ways of combining partial
results, on the CPU. (a) `kernel_variant`, `backward_variant`, `fused_kind`,
`backward_launch_keys` and the Python mirrors of the kernels' shared-memory
formulas, at the main paths' shapes and at the edges where the route changes,
never above the 232,448 bytes a block may ask for. (b) Plain PyTorch versions
of the combinations the kernels make (two halves of the depth summed into one
score tile; row statistics merged over key tiles; key ranges of a cluster with
their dq shares summed in rank order), held against the unblocked plain
versions at 1e-5 (forward) and 1e-4 (gradients) and, through `jax.grad` of
the Pallas kernels in interpret mode, against the JAX package. The CUDA
kernels themselves are held against the plain versions on a card
(test_torch_port_kernel.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.ops.flash_attention import flash_attention as jax_flash
from videosys_tpu_torch.ops import flash_attention as fa

SMEM_LIMIT = 232448
BF16, FP16, FP32 = torch.bfloat16, torch.float16, torch.float32


# ---- (a) dispatch ----------------------------------------------------------

@pytest.mark.parametrize("dtype,D,want", [
    (BF16, 72, "mma"), (FP16, 128, "mma"), (BF16, 129, "wgmma"),
    (BF16, 256, "wgmma"), (FP16, 257, "wgmma"), (BF16, 512, "wgmma"),
    (FP32, 129, "f32"), (FP32, 512, "f32"),
])
def test_forward_route_by_head_dim(dtype, D, want):
    assert fa.kernel_variant(dtype, D) == want
    assert want in fa.LAUNCHES


@pytest.mark.parametrize("D,padded", [(129, 256), (200, 256), (256, 256),
                                      (257, 512), (300, 512), (512, 512)])
def test_wide_forward_shared_memory(D, padded):
    want = 3 * 64 * padded * 2 + 2 * 64 * 64 * 4 + 128
    assert fa.wide_smem_bytes(D) == want <= SMEM_LIMIT


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
    ((30, 16, 405, 405, 72), BF16, "fused", ("bwd_fused",)),
    ((810, 16, 15, 15, 72), BF16, "fused", ("bwd_fused_short",)),
    ((30, 16, 405, 8, 72), BF16, "fused", ("bwd_fused",)),
    ((60, 16, 144, 144, 72), BF16, "fused", ("bwd_fused",)),
    ((2, 16, 700, 512, 72), BF16, "fused", ("bwd_fused",)),
    ((2, 16, 700, 513, 72), BF16, "blocked", ("bwd_dkv", "bwd_dq")),
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


def test_stub_text_encoder_resolves_its_device():
    from videosys_tpu_torch.models.text_encoders.t5 import StubTextEncoder

    y, m = StubTextEncoder(8, 4, device="cpu").encode(["a b"])
    assert y.device.type == "cpu" and m.sum().item() == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StubTextEncoder(8, 4)
