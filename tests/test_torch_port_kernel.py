"""The CUDA flash-attention kernels, forward and backward, against their
plain PyTorch versions, on a card. Skips without one. This file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernel.py
"""

import numpy as np
import pytest
import torch

from videosys_tpu_torch.ops import flash_attention as fa

F32_TOL = 2e-5
# Half-precision outputs are held by two relative measures, rel_l2 =
# |got - want|_2 / |want|_2 and rel_max = max|got - want| / max|want|, at
# limits (rel_l2, rel_max) set from the readings of `__main__` below on an
# H100: the kernel read at most half of each (bf16 3.2e-3 / 5.7e-3, fp16
# 4.4e-4 / 8.7e-4), and a plain version that drops one key per row read at
# least 1.1e-2 / 2.7e-2 wherever a row had a key to drop.
HALF_LIMITS = {torch.bfloat16: (6.5e-3, 1.2e-2), torch.float16: (1e-3, 2e-3)}
# di = rowsum(dO * O), which the dq kernel writes for the dk/dv kernel: 1e-5
# relative to its largest entry (fp32 sums in another order).
DI_TOL = 1e-5
# Gradients: fp32 at 1e-4 absolute (the JAX package's own gradient
# tolerance); half precision by the same two measures, the worst of dq, dk,
# dv, with both sides reading the same forward output and log-sum-exp. The
# kernels read at most 1.9e-4 / 3.4e-3 (bf16) and 4.9e-5 / 5.6e-4 (fp16) in
# the readings of `__main__` on an H100; a plain version that drops one key
# per row at least 5.9e-2 / 3.5e-1.
F32_GRAD_TOL = 1e-4
HALF_GRAD_LIMITS = {torch.bfloat16: (1e-3, 1.2e-2), torch.float16: (2e-4, 2e-3)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


SHAPES = [
    (2, 3, 100, 77, 72, True),     # ragged q and kv tails, unaligned D
    (1, 2, 130, 4200, 64, False),  # Nk > 4096 (the blocked TPU kernel's range)
    (2, 1, 70, 300, 512, True),    # D = 512: the wgmma kernel
    (1, 1, 6360, 6360, 512, True),  # the VAE mid row (not a multiple of 64)
    (2, 2, 130, 333, 256, True),   # D = 256: the narrower wgmma instance
    (1, 1, 50, 90, 200, False),    # padded to 256
    (1, 1, 40, 70, 300, True),     # padded to 512
    (1, 1, 33, 65, 132, True),     # D % 8 != 0 on the wgmma kernel
    (4, 2, 15, 15, 24, False),     # temporal length
    (1, 2, 33, 40, 20, True),      # D % 8 != 0: element-wise loads
]


def rel_errors(got, want):
    """Relative to the reference's norm and largest entry (absolute where
    the reference is all zero)."""
    d = (got.float() - want.float())
    want = want.float()
    norm, top = want.norm().item() or 1.0, want.abs().max().item() or 1.0
    return {"rel_l2": d.norm().item() / norm,
            "rel_max": d.abs().max().item() / top}


def inputs(dtype, B, H, Nq, Nk, D, masked):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .cuda().to(dtype)
               for s in ((B, H, Nq, D), (B, H, Nk, D), (B, H, Nk, D)))
    mask = None
    if masked:
        lens = torch.from_numpy(rng.integers(1, Nk + 1, size=B))
        mask = (torch.arange(Nk)[None] < lens[:, None]).cuda()
        mask[-1] = False  # one fully masked batch row
    return q, k, v, mask


def run_case(dtype, B, H, Nq, Nk, D, masked):
    """Kernel and plain outputs, and the kernel variants that launched."""
    q, k, v, mask = inputs(dtype, B, H, Nq, Nk, D, masked)
    fa.reset_launches()
    got = fa.flash_attention(q, k, v, kv_mask=mask)
    launched = dict(fa.LAUNCHES)
    want = fa.flash_attention_plain(q, k, v, kv_mask=mask)
    return got, want, launched


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,Nq,Nk,D,masked", SHAPES)
def test_kernel_matches_plain(card, dtype, B, H, Nq, Nk, D, masked):
    got, want, launched = run_case(dtype, B, H, Nq, Nk, D, masked)
    assert launched == {**{key: 0 for key in launched},
                        fa.kernel_variant(dtype, Nq, Nk, D): 1}
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        err = rel_errors(got, want)
        lim_l2, lim_max = HALF_LIMITS[dtype]
        assert err["rel_l2"] <= lim_l2 and err["rel_max"] <= lim_max, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,Nq,Nk,D,masked", [
    (2, 1, 70, 300, 512, True), (1, 2, 6360, 200, 512, False),
    (2, 2, 130, 333, 256, True)])
def test_wide_forward_log_sum_exp(card, dtype, B, H, Nq, Nk, D, masked):
    """The wgmma kernel's lse output against the plain version's."""
    q, k, v, mask = inputs(dtype, B, H, Nq, Nk, D, masked)
    assert fa.kernel_variant(dtype, Nq, Nk, D) == "wgmma"
    out, lse = fa._launch(q, k, v, None, mask, save_lse=True)
    want, want_lse = fa.flash_attention_plain(q, k, v, None, mask,
                                              return_lse=True)
    torch.testing.assert_close(lse, want_lse, atol=F32_GRAD_TOL, rtol=1e-5)
    err = rel_errors(out, want)
    lim_l2, lim_max = HALF_LIMITS[dtype]
    assert err["rel_l2"] <= lim_l2 and err["rel_max"] <= lim_max, err


def check_forward(dtype, B, H, Nq, Nk, D, masked):
    """The forward kernel the shape takes, output and log-sum-exp, against
    plain; with `masked` the last batch row is fully masked."""
    q, k, v, mask = inputs(dtype, B, H, Nq, Nk, D, masked)
    fa.reset_launches()
    out, lse = fa._launch(q, k, v, None, mask, save_lse=True)
    assert fa.LAUNCHES[fa.kernel_variant(dtype, Nq, Nk, D)] == 1
    want, want_lse = fa.flash_attention_plain(q, k, v, None, mask,
                                              return_lse=True)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(lse, want_lse, atol=F32_GRAD_TOL, rtol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        err = rel_errors(out, want)
        lim_l2, lim_max = HALF_LIMITS[dtype]
        assert err["rel_l2"] <= lim_l2 and err["rel_max"] <= lim_max, err


# rows and keys around the short-row kernel's 16, the 64-row warpgroups and
# key tiles, the narrow kernel's 128-row blocks, and the spatial row
EDGE_N = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1590]


@pytest.mark.cuda
@pytest.mark.parametrize("Nk", EDGE_N)
@pytest.mark.parametrize("Nq", EDGE_N)
def test_forward_edges(card, Nq, Nk):
    """bf16 at D = 72 under a ragged key mask with a fully masked batch
    row, whichever of the short and narrow kernels the shape takes."""
    check_forward(torch.bfloat16, 2, 2, Nq, Nk, 72, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 72, 80, 128])
@pytest.mark.parametrize("Nq,Nk", [(15, 15), (16, 17), (129, 65), (1590, 127)])
def test_forward_head_widths(card, dtype, D, Nq, Nk):
    check_forward(dtype, 2, 2, Nq, Nk, D, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Nq,Nk,D", [(15, 15, 72), (100, 77, 72),
                                     (33, 40, 20), (70, 300, 512)])
def test_forward_log_sum_exp_of_every_variant(card, dtype, Nq, Nk, D):
    check_forward(dtype, 3, 2, Nq, Nk, D, True)


@pytest.mark.cuda
def test_dispatch_never_sends_cuda_to_plain(card, monkeypatch):
    from videosys_tpu_torch.ops.attention import scaled_dot_product_attention

    q = torch.randn(1, 2, 16, 72, device="cuda", dtype=torch.bfloat16)
    monkeypatch.delenv("VIDEOSYS_FORCE_FLASH", raising=False)
    fa.reset_launches()
    scaled_dot_product_attention(q, q, q)
    assert fa.LAUNCHES["short"] == 1
    with pytest.raises(ValueError):
        scaled_dot_product_attention(q, q, q, force_flash=False)
    monkeypatch.setenv("VIDEOSYS_FORCE_FLASH", "0")
    with pytest.raises(ValueError):
        scaled_dot_product_attention(q, q, q)
    with pytest.raises(ValueError):  # head_dim > 512: the kernel refuses
        scaled_dot_product_attention(*(torch.zeros(1, 1, 8, 600, device="cuda",
                                                   dtype=torch.bfloat16),) * 3,
                                     force_flash=True)
    assert fa.LAUNCHES["short"] == 1


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(card):
    q = torch.zeros(1, 1, 8, 600, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 8, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


BWD_SHAPES = [
    (2, 3, 100, 150, 72, True),    # ragged tails, a fully masked batch row
    (3, 4, 405, 405, 72, False),   # 240p spatial row
    (40, 2, 15, 15, 72, False),    # temporal length
    (2, 4, 405, 8, 72, True),      # cross attention to 8 text tokens
    (1, 2, 300, 200, 128, True),   # the widest head the backward takes
    (1, 2, 33, 40, 20, True),      # D % 8 != 0: element-wise loads
    (4, 1, 15, 15, 72, True),      # four packed short rows, one fully masked
    (2, 2, 100, 15, 72, True),     # key counts around the 16-key groups
    (2, 2, 100, 63, 72, True),     # and the 64-key blocks of a cluster
    (2, 2, 100, 64, 72, True),
    (2, 2, 100, 65, 72, True),
    (2, 1, 100, 405, 72, True),    # seven blocks to a cluster
    (1, 2, 70, 512, 64, True),     # a full cluster of eight
]


def run_bwd_case(dtype, variant, B, H, Nq, Nk, D, masked, drop_key=None):
    """(kernel grads, plain grads) of one backward variant; the forward
    kernel's output and log-sum-exp feed both. With `drop_key` the plain
    side loses one key per row (the fault the limits must catch). The blocked
    pair runs as `FlashAttentionFunction` runs it: dq (which writes di), then
    dk and dv from that di, held against rowsum(dO * O) at DI_TOL."""
    q, k, v, mask = inputs(dtype, B, H, Nq, Nk, D, masked)
    rng = np.random.default_rng(1)
    do = torch.from_numpy(rng.standard_normal(
        (B, H, Nq, D)).astype(np.float32)).cuda().to(dtype)
    if masked:
        # the first row attends to every key (a row with one key has no
        # gradient to measure against); the last is fully masked when there
        # is another beside it
        lens = torch.from_numpy(rng.integers(2, Nk + 1, size=B))
        lens[0] = Nk
        mask = (torch.arange(Nk)[None] < lens[:, None]).cuda()
        if B > 1:
            mask[-1] = False
    out, lse = fa._launch(q, k, v, None, mask, save_lse=True)
    want_lse = fa.flash_attention_plain(q, k, v, None, mask, return_lse=True)[1]
    torch.testing.assert_close(lse, want_lse, atol=F32_GRAD_TOL, rtol=1e-5)
    pmask = mask if drop_key is None else drop_key(mask, B, Nk, "cuda")
    if variant == "fused":
        got = fa.flash_bwd_fused(q, k, v, mask, do)
        want = fa.flash_attention_bwd_plain(q, k, v, pmask, do)
    else:
        dq, di = fa.flash_bwd_dq(q, k, v, mask, do, lse, out)
        dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, lse, di)
        got = (dq, dk, dv)
        want = fa.flash_attention_bwd_lse_plain(q, k, v, pmask, do, out, lse)
        want_di = (do.float() * out.float()).sum(-1)
        assert di.dtype == torch.float32 and di.shape == (B, H, Nq)
        assert (di - want_di).abs().max() <= DI_TOL * want_di.abs().max()
    return got, want, mask


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fused", "blocked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,Nq,Nk,D,masked", BWD_SHAPES)
def test_backward_kernels_match_plain(card, variant, dtype, B, H, Nq, Nk, D,
                                      masked):
    fa.reset_launches()
    got, want, mask = run_bwd_case(dtype, variant, B, H, Nq, Nk, D, masked)
    torch.cuda.synchronize()
    keys = fa.backward_launch_keys(variant, dtype, Nq, Nk)
    assert {k: n for k, n in fa.LAUNCHES.items() if n} == {
        fa.kernel_variant(dtype, Nq, Nk, D): 1, **{key: 1 for key in keys}}
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and g.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=F32_GRAD_TOL, rtol=F32_GRAD_TOL)
        else:
            err = rel_errors(g, w)
            lim_l2, lim_max = HALF_GRAD_LIMITS[dtype]
            assert err["rel_l2"] <= lim_l2 and err["rel_max"] <= lim_max, err
    if mask is not None:
        # masked keys of rows that attend to something: exactly zero dk, dv;
        # the fully masked batch row: no dq and no dk at all
        dead = ((~mask) & mask.any(1, keepdim=True))[:, None, :, None]
        assert not bool(got[1].masked_select(dead).any())
        assert not bool(got[2].masked_select(dead).any())
        if B > 1:
            assert not bool(got[0][-1].any()) and not bool(got[1][-1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_fused_backward_with_one_key(card, dtype):
    """One key: P is 1, so dq and dk are zero and dv is dO summed over the
    q rows."""
    q, k, v, _ = inputs(dtype, 2, 2, 100, 1, 72, False)
    do = torch.randn_like(q)
    dq, dk, dv = fa.flash_bwd_fused(q, k, v, None, do)
    assert not bool(dq.any()) and not bool(dk.any())
    err = rel_errors(dv, do.float().sum(2, keepdim=True))
    assert err["rel_l2"] <= (1e-5 if dtype == torch.float32 else 6.5e-3), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,H,Nq,Nk,D,masked", [
    (3, 4, 405, 405, 72, False), (2, 4, 405, 300, 72, True),
    (40, 2, 15, 15, 72, False), (4, 1, 15, 15, 72, True)])
def test_fused_backward_gives_the_same_bits_twice(card, dtype, B, H, Nq, Nk,
                                                  D, masked):
    """No sum of the fused backward depends on the order blocks finish in:
    the same inputs give bit-equal gradients."""
    q, k, v, mask = inputs(dtype, B, H, Nq, Nk, D, masked)
    do = torch.randn_like(q)
    first = fa.flash_bwd_fused(q, k, v, mask, do)
    for _ in range(3):
        again = fa.flash_bwd_fused(q, k, v, mask, do)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Nq,Nk,D", [
    (100, 2, 72), (70, 127, 72), (65, 128, 72), (129, 129, 72),
    (200, 255, 72), (64, 257, 64), (40, 300, 128), (300, 130, 32)])
def test_dkv_at_key_counts_off_the_block(card, dtype, Nq, Nk, D):
    """`flash_bwd_dkv` where the last block of 128 keys is ragged or one of
    its warpgroups has no key at all."""
    got, want, mask = run_bwd_case(dtype, "blocked", 2, 2, Nq, Nk, D, True)
    torch.cuda.synchronize()
    lim_l2, lim_max = HALF_GRAD_LIMITS[dtype]
    for g, w in zip(got[1:], want[1:]):
        err = rel_errors(g, w)
        assert err["rel_l2"] <= lim_l2 and err["rel_max"] <= lim_max, err
    dead = ((~mask) & mask.any(1, keepdim=True))[:, None, :, None]
    assert not bool(got[1].masked_select(dead).any())
    assert not bool(got[2].masked_select(dead).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_dkv_gives_the_same_bits_twice(card, dtype):
    q, k, v, mask = inputs(dtype, 2, 4, 700, 405, 72, True)
    do = torch.randn_like(q)
    out, lse = fa._launch(q, k, v, None, mask, save_lse=True)
    di = (do.float() * out.float()).sum(-1)
    first = fa.flash_bwd_dkv(q, k, v, mask, do, lse, di)
    for _ in range(3):
        again = fa.flash_bwd_dkv(q, k, v, mask, do, lse, di)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("Nq,Nk,D", [
    (1, 2, 72), (63, 65, 72), (64, 300, 72), (65, 2, 72), (127, 405, 72),
    (128, 65, 72), (129, 300, 64), (405, 405, 32), (1590, 65, 128),
    (200, 129, 80)])
def test_dq_at_row_counts_off_the_block(card, dtype, Nq, Nk, D):
    """`flash_bwd_dq` where the last block of 128 q rows is ragged or one
    of its warpgroups has no row at all; dq twice gives the same bits."""
    got, want, mask = run_bwd_case(dtype, "blocked", 2, 2, Nq, Nk, D, True)
    torch.cuda.synchronize()
    err = rel_errors(got[0], want[0])
    lim_l2, lim_max = HALF_GRAD_LIMITS[dtype]
    assert err["rel_l2"] <= lim_l2 and err["rel_max"] <= lim_max, err
    assert not bool(got[0][-1].any())  # the fully masked batch row
    q, k, v, _ = inputs(dtype, 2, 2, Nq, Nk, D, False)
    do = torch.randn_like(q)
    out, lse = fa._launch(q, k, v, None, mask, save_lse=True)
    first = fa.flash_bwd_dq(q, k, v, mask, do, lse, out)
    again = fa.flash_bwd_dq(q, k, v, mask, do, lse, out)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_launches_the_backward_kernels(card, dtype):
    """`flash_attention` on CUDA tensors that need gradients: the rule's
    backward kernels run, a strided dO is made contiguous, and the plain
    versions are never entered."""
    from videosys_tpu_torch.ops.attention import scaled_dot_product_attention

    for (B, H, N, D), variant in (((2, 4, 15, 72), "fused"),
                                  ((1, 2, 2200, 72), "blocked")):
        assert fa.backward_variant(B, H, N, N, D, dtype) == variant
        x = torch.randn(3, B, N, H, D, device="cuda", dtype=dtype)
        t = [a.clone().requires_grad_() for a in x]
        w = torch.randn(B, N, H, D, device="cuda", dtype=dtype)
        fa.reset_launches()
        out = scaled_dot_product_attention(*(a.transpose(1, 2) for a in t))
        (out.transpose(1, 2) * w).sum().backward()
        keys = fa.backward_launch_keys(variant, dtype, N, N)
        assert {k: n for k, n in fa.LAUNCHES.items() if n} == {
            fa.kernel_variant(dtype, N, N, D): 1, **{key: 1 for key in keys}}
        q, k, v = (a.detach().transpose(1, 2).contiguous() for a in t)
        want = fa.flash_attention_bwd_plain(q, k, v, None,
                                            w.transpose(1, 2).contiguous())
        for a, g in zip(t, want):
            err = rel_errors(a.grad.transpose(1, 2), g)
            assert err["rel_l2"] <= (1e-5 if dtype == torch.float32 else 6.5e-3)
        fa.reset_launches()
        with torch.no_grad():
            scaled_dot_product_attention(*(a.transpose(1, 2) for a in t))
        assert sum(fa.LAUNCHES.values()) == 1


@pytest.mark.cuda
def test_recompute_policies_on_the_card(card):
    """A tiny fp32 STDiT3 on the card: the three recompute policies give one
    loss and one set of gradients, every attention through the kernels (the
    forward twice where it is recomputed)."""
    from videosys_tpu_torch.models.transformers.stdit3 import STDiT3, STDiT3Config

    cfg = STDiT3Config(depth=2, hidden_size=32, num_heads=2,
                       caption_channels=16, model_max_length=8)
    torch.manual_seed(0)
    sd = STDiT3(cfg).state_dict()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 5, 8, 8, generator=gen).cuda()
    y = torch.randn(2, 8, 16, generator=gen).cuda()
    t = torch.tensor([500.0, 130.0], device="cuda")
    results = {}
    for policy in STDiT3.REMAT_POLICIES:
        model = STDiT3(cfg, remat=True, remat_policy=policy)
        model.load_state_dict(sd)
        model.cuda().train()
        fa.reset_launches()
        loss = model(x, t, y, height=64.0, width=64.0).square().mean()
        loss.backward()
        # per pair: spatial, temporal and two cross attentions
        n = cfg.depth * 4
        assert fa.LAUNCHES["f32"] == n * (1 if policy == "none" else 2)
        assert fa.LAUNCHES["bwd_fused_f32"] == n
        results[policy] = (loss.item(), {k: p.grad for k, p in
                                         model.named_parameters()
                                         if p.grad is not None})
    for policy in ("dots", "none"):
        assert results[policy][0] == pytest.approx(results["full"][0], rel=1e-6)
        for k, g in results["full"][1].items():
            torch.testing.assert_close(results[policy][1][k], g,
                                       atol=1e-6, rtol=1e-4)


@pytest.mark.cuda
def test_backward_rejects_what_it_cannot_take(card):
    q = torch.zeros(1, 1, 8, 136, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # head_dim > 128
        fa.flash_bwd_fused(q, q, q, None, q)
    q = torch.zeros(1, 1, 40000, 64, device="cuda")
    k = torch.zeros(1, 1, 8, 64, device="cuda")
    with pytest.raises(ValueError):  # row statistics beyond shared memory
        fa.flash_bwd_fused(q, k, k, None, q)
    assert fa.backward_variant(1, 1, 40000, 8, 64, torch.float32) == "blocked"
    q = torch.zeros(1, 1, 8, 64, device="cuda")
    with pytest.raises(ValueError):  # strided dO at the raw wrapper
        fa.flash_bwd_fused(q, q, q, None,
                           torch.zeros(1, 1, 64, 8, device="cuda").transpose(2, 3))
    q = torch.zeros(1, 1, 8, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 513, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # more keys than a cluster holds
        fa.flash_bwd_fused(q, k, k, None, q)


@pytest.mark.cuda
def test_python_mirrors_of_the_kernels_formulas(card):
    """The dispatch reads Python copies of the sources' shared-memory
    formulas and of the fused backward's choice of kernel."""
    assert fa._library("bwd").flash_bwd_fused_smem(405, 72) == \
        fa.fused_smem_bytes(405, 72)
    lib = fa._library("bwd_fused")
    for D in (8, 32, 33, 64, 72, 80, 81, 128):
        for i, which in enumerate(("stats", "cluster", "short")):
            assert lib.flash_bwd_fused_mma_smem(i, D) == \
                fa.fused_kernel_smem_bytes(which, D) <= fa.SMEM_PER_BLOCK
    kinds = {1: "cluster", 2: "short", -1: None}
    for Nq, Nk in ((405, 405), (15, 15), (16, 16), (17, 16), (16, 17),
                   (8160, 512), (64, 513)):
        assert kinds[lib.flash_bwd_fused_mma_kind(Nq, Nk, 72)] == \
            fa.fused_kind(Nq, Nk, torch.bfloat16)
    fwd = fa._library("fwd")
    variants = {0: "f32", 1: "short", 2: "narrow", 3: "wgmma"}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1),
                        (torch.float16, 2)):
        for Nq, Nk, D in ((15, 15, 72), (16, 16, 128), (17, 16, 72),
                          (16, 17, 72), (1590, 1590, 72), (15, 15, 129),
                          (6360, 6360, 512), (1, 1, 1)):
            assert variants[fwd.flash_fwd_variant(code, Nq, Nk, D)] == \
                fa.kernel_variant(dtype, Nq, Nk, D)
    for D in (8, 32, 33, 64, 72, 80, 81, 128):
        assert fwd.flash_fwd_smem(1, D) == fa.short_fwd_smem_bytes(D)
        assert fwd.flash_fwd_smem(2, D) == fa.narrow_smem_bytes(D)
        assert fa._library("bwd_dkv").flash_bwd_dkv_wgmma_smem(D) == \
            fa.dkv_smem_bytes(D)
        assert fa._library("bwd_dq").flash_bwd_dq_wgmma_smem(D) == \
            fa.dq_smem_bytes(D)
    for D in (129, 256, 257, 512):
        assert fwd.flash_fwd_smem(3, D) == fa.wide_smem_bytes(D)


if __name__ == "__main__":
    # The half-precision readings the limits above are set from, beside
    # those of a plain version that drops one key per row (on a card):
    #     PYTHONPATH=. python tests/test_torch_port_kernel.py
    from chip_smoke import drop_last_key

    for dtype in (torch.bfloat16, torch.float16):
        for case in SHAPES:
            got, want, _ = run_case(dtype, *case)
            q, k, v, mask = inputs(dtype, *case)
            fault = fa.flash_attention_plain(
                q, k, v, kv_mask=drop_last_key(mask, case[0], case[3], "cuda"))
            print(f"readings {dtype} {case} kernel {rel_errors(got, want)} "
                  f"one key dropped {rel_errors(fault, want)}", flush=True)

    def worst(got, want):
        errs = [rel_errors(g, w) for g, w in zip(got, want)]
        return {m: max(e[m] for e in errs) for m in errs[0]}

    for dtype in (torch.bfloat16, torch.float16):
        for variant in ("fused", "blocked"):
            for case in BWD_SHAPES:
                got, want, _ = run_bwd_case(dtype, variant, *case)
                _, fault, _ = run_bwd_case(dtype, variant, *case,
                                           drop_key=drop_last_key)
                print(f"bwd readings {dtype} {variant} {case} kernel "
                      f"{worst(got, want)} one key dropped {worst(fault, want)}",
                      flush=True)
