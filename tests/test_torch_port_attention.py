"""Attention of the PyTorch port against the JAX package: the plain version
of the CUDA flash kernel and the CPU dispatch, against the Pallas kernel in
interpret mode and against `reference_attention`. The CUDA kernel itself is
checked against its plain version on a card (test_torch_port_kernel.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.ops.attention import reference_attention as jax_reference
from videosys_tpu.ops.flash_attention import flash_attention as jax_flash
from videosys_tpu_torch.ops import flash_attention as port_flash
from videosys_tpu_torch.ops.attention import (
    reference_attention,
    scaled_dot_product_attention,
)

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _inputs(B, H, Nq, Nk, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Nq, D), np.float32),
            rng.standard_normal((B, H, Nk, D), np.float32),
            rng.standard_normal((B, H, Nk, D), np.float32))


def _ragged_mask(B, Nk, seed=1):
    lens = np.random.default_rng(seed).integers(1, Nk + 1, size=B)
    lens[0] = max(1, Nk // 3)
    return np.arange(Nk)[None, :] < lens[:, None]


def _port(fn, q, k, v, mask, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    return fn(*t, kv_mask=m, **kw).float().numpy()


@pytest.mark.parametrize("B,H,Nq,Nk,D,masked", [
    (1, 2, 256, 256, 64, False),   # aligned
    (2, 4, 300, 300, 72, False),   # STDiT3 head_dim 72, unaligned sequence
    (1, 2, 128, 520, 64, False),   # cross-attention style, Nk != Nq
    (1, 1, 640, 96, 32, False),    # tiny kv
    (2, 2, 128, 300, 64, True),    # ragged text mask
    (3, 2, 15, 15, 72, True),      # temporal length, masked
])
def test_plain_and_dispatch_match_jax(B, H, Nq, Nk, D, masked):
    q, k, v = _inputs(B, H, Nq, Nk, D)
    mask = _ragged_mask(B, Nk) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want_flash = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), kv_mask=jm,
                                      interpret=True))
    want_ref = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), kv_mask=jm))
    plain = _port(port_flash.flash_attention_plain, q, k, v, mask)
    dispatch = _port(scaled_dot_product_attention, q, k, v, mask)
    forced = _port(scaled_dot_product_attention, q, k, v, mask,
                   force_flash=True)
    for got in (plain, dispatch, forced):
        np.testing.assert_allclose(got, want_flash, atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(got, want_ref, atol=F32_TOL, rtol=F32_TOL)


def test_blocked_length_matches_jax():
    """Nk > 4096: the JAX package's blocked kernel (the VAE mid attention's
    branch)."""
    q, k, v = _inputs(1, 1, 64, 4200, 32, seed=3)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), interpret=True))
    got = _port(port_flash.flash_attention, q, k, v, None)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_bf16_matches_jax():
    q, k, v = _inputs(1, 2, 256, 256, 72, seed=4)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_flash(*bf, interpret=True).astype(jnp.float32))
    for fn in (port_flash.flash_attention_plain, reference_attention):
        got = _port(fn, q, k, v, None, dtype=torch.bfloat16)
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


def test_fully_masked_row_averages_keys():
    """A row with every key masked takes the mean of v over its Nk keys, in
    the plain version as in the kernel."""
    q, k, v = _inputs(2, 1, 4, 7, 8, seed=5)
    mask = np.ones((2, 7), bool)
    mask[1] = False
    got = _port(port_flash.flash_attention_plain, q, k, v, mask)
    np.testing.assert_allclose(got[1, 0], np.broadcast_to(v[1, 0].mean(0), (4, 8)),
                               atol=1e-6)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("kernel launch on CPU tensors")

    monkeypatch.setattr(port_flash, "_launch", fail)
    q, k, v = _inputs(1, 1, 8, 8, 16)
    port_flash.reset_launches()
    _port(port_flash.flash_attention, q, k, v, None)
    _port(scaled_dot_product_attention, q, k, v, None, force_flash=True)
    assert not any(port_flash.LAUNCHES.values())


@pytest.mark.parametrize("force,env,want", [
    (None, None, "reference"), (True, None, "flash"), (False, None, "reference"),
    (None, "1", "flash"), (None, "0", "reference"), (False, "1", "reference"),
])
def test_cpu_dispatch_choice(monkeypatch, force, env, want):
    """On the CPU `force_flash`, else VIDEOSYS_FORCE_FLASH, picks between
    the kernel's plain version and `reference_attention`."""
    import videosys_tpu_torch.ops.attention as port_attention

    calls = []
    monkeypatch.setattr(port_attention, "flash_attention",
                        lambda *a, **k: calls.append("flash") or a[0])
    monkeypatch.setattr(port_attention, "reference_attention",
                        lambda *a, **k: calls.append("reference") or a[0])
    if env is None:
        monkeypatch.delenv("VIDEOSYS_FORCE_FLASH", raising=False)
    else:
        monkeypatch.setenv("VIDEOSYS_FORCE_FLASH", env)
    q, k, v = _inputs(1, 1, 4, 4, 8)
    _port(scaled_dot_product_attention, q, k, v, None, force_flash=force)
    assert calls == [want]


@pytest.mark.parametrize("dtype,D,want", [
    (torch.float32, 72, "f32"), (torch.float32, 512, "f32"),
    (torch.bfloat16, 72, "mma"), (torch.float16, 128, "mma"),
    (torch.bfloat16, 129, "wgmma"), (torch.bfloat16, 512, "wgmma"),
])
def test_kernel_variant(dtype, D, want):
    """Launch counts are keyed by the CUDA variant flash_fwd.cu launches."""
    assert port_flash.kernel_variant(dtype, D) == want
