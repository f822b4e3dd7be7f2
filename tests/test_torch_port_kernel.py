"""The CUDA flash-attention kernel against its plain PyTorch version, on a
card. Skips without one. This file imports no JAX, so it also runs where
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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


SHAPES = [
    (2, 3, 100, 77, 72, True),     # ragged q and kv tails, unaligned D
    (1, 2, 130, 4200, 64, False),  # Nk > 4096 (the blocked TPU kernel's range)
    (2, 1, 70, 300, 512, True),    # D = 512 split over column blocks
    (4, 2, 15, 15, 24, False),     # temporal length
    (1, 2, 33, 40, 20, True),      # D % 8 != 0: element-wise loads
]


def rel_errors(got, want):
    d = (got.float() - want.float())
    want = want.float()
    return {"rel_l2": (d.norm() / want.norm()).item(),
            "rel_max": (d.abs().max() / want.abs().max()).item()}


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
                        fa.kernel_variant(dtype, D): 1}
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        err = rel_errors(got, want)
        lim_l2, lim_max = HALF_LIMITS[dtype]
        assert err["rel_l2"] <= lim_l2 and err["rel_max"] <= lim_max, err


@pytest.mark.cuda
def test_dispatch_never_sends_cuda_to_plain(card, monkeypatch):
    from videosys_tpu_torch.ops.attention import scaled_dot_product_attention

    q = torch.randn(1, 2, 16, 72, device="cuda", dtype=torch.bfloat16)
    monkeypatch.delenv("VIDEOSYS_FORCE_FLASH", raising=False)
    fa.reset_launches()
    scaled_dot_product_attention(q, q, q)
    assert fa.LAUNCHES["mma"] == 1
    with pytest.raises(ValueError):
        scaled_dot_product_attention(q, q, q, force_flash=False)
    monkeypatch.setenv("VIDEOSYS_FORCE_FLASH", "0")
    with pytest.raises(ValueError):
        scaled_dot_product_attention(q, q, q)
    with pytest.raises(ValueError):  # head_dim > 512: the kernel refuses
        scaled_dot_product_attention(*(torch.zeros(1, 1, 8, 600, device="cuda",
                                                   dtype=torch.bfloat16),) * 3,
                                     force_flash=True)
    assert fa.LAUNCHES["mma"] == 1


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(card):
    q = torch.zeros(1, 1, 8, 600, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 8, 64, device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


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
