"""Attention gradients of the PyTorch port against the JAX package: the same
numpy inputs go through `jax.grad` of the Pallas kernels in interpret mode
and through `FlashAttentionFunction` on CPU tensors (the backward kernels'
plain versions). Gradients agree to 1e-4, the tolerance of the JAX
package's own gradient tests; masked keys get exactly zero dk and dv. The
CUDA kernels themselves are held against the plain versions on a card
(test_torch_port_kernel.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosys_tpu.ops.flash_attention import (
    _flash_attention_fwd_impl,
    flash_attention as jax_flash,
)
from videosys_tpu_torch.ops import flash_attention as fa
from videosys_tpu_torch.ops.attention import scaled_dot_product_attention

GRAD_TOL = 1e-4


def _inputs(B, H, Nq, Nk, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, H, Nq, D), (B, H, Nk, D), (B, H, Nk, D), (B, H, Nq, D)))


def _jax_grads(q, k, v, ct, mask):
    jm = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return jnp.vdot(jax_flash(q, k, v, kv_mask=jm, interpret=True), ct)

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _port_grads(q, k, v, ct, mask, backward=None, fn=None):
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    if fn is None:
        out = fa.FlashAttentionFunction.apply(*t, m, None, backward)
    else:
        out = fn(*t, kv_mask=m)
    out.backward(torch.from_numpy(ct))
    return [x.grad.numpy() for x in t]


def _assert_masked_zero(grads, mask):
    dead = np.broadcast_to(~mask[:, None, :, None], grads[1].shape)
    assert np.all(grads[1][dead] == 0.0) and np.all(grads[2][dead] == 0.0)


@pytest.mark.parametrize("B,H,Nq,Nk,D,lens", [
    (1, 2, 128, 128, 32, None),       # aligned
    (2, 2, 150, 150, 24, None),       # ragged q, kv and head_dim tails
    (1, 4, 200, 40, 72, None),        # short kv, STDiT3's head_dim
    (3, 2, 15, 15, 72, None),         # temporal length
    (2, 2, 130, 96, 32, (50, 96)),    # ragged text mask
])
def test_single_pass_grads_match_jax(B, H, Nq, Nk, D, lens):
    """Shapes where the JAX package runs `_flash_bwd_kernel` and the port
    `flash_bwd_fused`'s plain version."""
    q, k, v, ct = _inputs(B, H, Nq, Nk, D, seed=Nq)
    mask = None if lens is None else np.arange(Nk)[None] < np.array(lens)[:, None]
    assert fa.backward_variant(B, H, Nq, Nk, D, torch.float32) == "fused"
    want = _jax_grads(q, k, v, ct, mask)
    got = _port_grads(q, k, v, ct, mask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)
    if mask is not None:
        _assert_masked_zero(got, mask)


@pytest.mark.parametrize("lens", [None, (3000, 4200)])
def test_blocked_grads_match_jax(lens):
    """Nk > 4096: the JAX package runs `_flash_bwd_dkv_kernel` and
    `_flash_bwd_dq_kernel` from the saved log-sum-exp; the port is asked for
    the same pair (its own rule would still take the fused kernel for so
    few q rows), and its rule's choice must agree too."""
    B, H, Nq, Nk, D = (1 if lens is None else 2), 1, 70, 4200, 24
    q, k, v, ct = _inputs(B, H, Nq, Nk, D, seed=11)
    mask = None if lens is None else np.arange(Nk)[None] < np.array(lens)[:, None]
    want = _jax_grads(q, k, v, ct, mask)
    for backward in ("blocked", None):
        got = _port_grads(q, k, v, ct, mask, backward)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)
        if mask is not None:
            _assert_masked_zero(got, mask)


def test_lse_matches_jax_forward():
    """The log-sum-exp the blocked backward reads, against the JAX forward's
    `save_lse` output (there [B*H, Nq padded, 8 equal lanes])."""
    B, H, Nq, Nk, D = 2, 2, 100, 4200, 16
    q, k, v, _ = _inputs(B, H, Nq, Nk, D, seed=5)
    mask = np.arange(Nk)[None] < np.array([1234, 4200])[:, None]
    _, lse = _flash_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        None, 256, 512, True, save_lse=True)
    want = np.asarray(lse)[:, :Nq, 0].reshape(B, H, Nq)
    out, got = fa.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), None,
        torch.from_numpy(mask), return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("backward", ["fused", "blocked"])
def test_gradcheck(backward):
    """The function's backward against finite differences, in fp64."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_()
               for s in ((2, 2, 5, 4), (2, 2, 7, 4), (2, 2, 7, 4)))
    mask = torch.from_numpy(np.arange(7)[None] < np.array([7, 3])[:, None])
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.FlashAttentionFunction.apply(a, b, c, mask, 0.7,
                                                        backward), (q, k, v))


@pytest.mark.parametrize("backward", ["fused", "blocked"])
def test_function_matches_autograd_of_plain(backward):
    """The plain backward versions against PyTorch's own gradient of the
    plain forward, a fully masked batch row included: it averages v over
    its Nk keys, so dv is uniform and dq, dk are zero there."""
    B, H, Nq, Nk, D = 2, 2, 37, 29, 16
    q, k, v, ct = _inputs(B, H, Nq, Nk, D, seed=7)
    mask = np.ones((B, Nk), bool)
    mask[1] = False
    want = _port_grads(q, k, v, ct, mask, fn=fa.flash_attention_plain)
    got = _port_grads(q, k, v, ct, mask, backward)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    assert np.all(got[0][1] == 0) and np.all(got[1][1] == 0)
    np.testing.assert_allclose(
        got[2][1], np.broadcast_to(ct[1].sum(1, keepdims=True) / Nk,
                                   got[2][1].shape), atol=1e-5)


def test_forced_flash_on_cpu_keeps_the_graph():
    """`scaled_dot_product_attention(force_flash=True)` on CPU tensors goes
    through `FlashAttentionFunction` (the plain versions), also for
    non-contiguous heads and a non-contiguous dO, and gives the gradients
    of `reference_attention`."""
    B, H, N, D = 2, 3, 20, 8
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, B, N, H, D)).astype(np.float32)
    w = rng.standard_normal((B, N, H, D)).astype(np.float32)

    def grads(force):
        t = [torch.from_numpy(a).requires_grad_() for a in x]
        o = scaled_dot_product_attention(*(a.transpose(1, 2) for a in t),
                                         force_flash=force)
        assert o.grad_fn is not None
        # the product with a transposed weight hands backward a strided dO
        (o.transpose(1, 2) * torch.from_numpy(w)).sum().backward()
        return [a.grad.numpy() for a in t]

    for g, r in zip(grads(True), grads(False)):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5)


def test_no_grad_inputs_take_the_forward_alone(monkeypatch):
    """Without an input that needs a gradient, or under no_grad,
    `flash_attention` does not enter the autograd function."""
    def fail(*a, **k):
        raise AssertionError("entered FlashAttentionFunction")

    q, k, v, _ = _inputs(1, 1, 8, 8, 16)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    want = fa.flash_attention_plain(*t)
    monkeypatch.setattr(fa.FlashAttentionFunction, "apply", fail)
    torch.testing.assert_close(fa.flash_attention(*t), want)
    t[0].requires_grad_()
    with torch.no_grad():
        torch.testing.assert_close(fa.flash_attention(*t), want)
    with pytest.raises(AssertionError):
        fa.flash_attention(*t)


@pytest.mark.parametrize("shape,dtype,want", [
    ((30, 16, 405, 405, 72), torch.bfloat16, "blocked"),  # 240p spatial
    ((60, 16, 144, 144, 72), torch.bfloat16, "blocked"),  # 144p spatial
    ((810, 16, 15, 15, 72), torch.bfloat16, "fused"),     # temporal
    ((30, 16, 405, 8, 72), torch.bfloat16, "fused"),      # cross, 8 tokens
    ((30, 16, 405, 300, 72), torch.bfloat16, "blocked"),  # cross, 300
    ((30, 16, 512, 512, 72), torch.bfloat16, "blocked"),  # a full cluster
    ((30, 16, 1590, 1590, 72), torch.bfloat16, "blocked"),  # 480p video
    ((1, 16, 8160, 8160, 72), torch.bfloat16, "blocked"),  # 1080p image
    ((16, 16, 8160, 8160, 72), torch.float32, "fused"),   # a block per SM
    ((1, 1, 40000, 64, 72), torch.float32, "blocked"),    # statistics > 227 KB
])
def test_backward_variant(shape, dtype, want):
    assert fa.backward_variant(*shape, dtype) == want
    keys = fa.backward_launch_keys(want, dtype, shape[2], shape[3])
    assert all(key in fa.LAUNCHES for key in keys)
    assert len(keys) == (1 if want == "fused" else 2)
