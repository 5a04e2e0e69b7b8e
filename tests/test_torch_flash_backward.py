"""Flash attention's logsumexp and backward on the CPU: the plain versions
of the two kernels (``sdpa_lse_plain``, ``sdpa_backward_plain``) and
``FlashSDPA`` (which takes them on the CPU) against the JAX reference,
``psg_tpu/ops/xla_ref.py::sdpa_xla`` and its ``jax.vjp``.

Inputs are made from a seed with numpy and handed to both packages.  fp32
comparisons are at rtol/atol 2e-5: only summation order differs (and P is
rebuilt from the logsumexp, exp((s - c) - lse), where the reference divides
by the row sum).  bf16 gradients are held to jax.vjp of sdpa_xla in bf16 at
rtol/atol 2e-2 (BF16_TOL).  The kernels themselves are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.ops.xla_ref import sdpa_xla

from psg_tpu_torch.ops import flash_attention

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
# bf16: the backward's Delta = rowsum(dO * O) comes from the stored bf16
# output, where jax.vjp takes rowsum(dP * P) in fp32, and each gradient is
# rounded to bf16 once; they differ by a few bf16 ulps of the gradient (at
# most 0.016 at magnitudes up to 5 at these shapes).  The card tests' bf16
# bound (tests/test_torch_cuda.py TOL).
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

SHAPES = [
    (2, 2, 29, 37, 40),   # the SD UNet's head dim, odd Lq and Lk
    (2, 3, 33, 17, 16),   # hd 16 (the VAE's 54^2 site, narrow)
    (3, 2, 9, 70, 6),     # odd everything (tiny configs), Lk over one key tile
]
# key masks: none; the last sample's prompt a third of the keys; every key
# of the first sample masked (its scores are all -1e9: qk * scale is
# absorbed and the softmax is uniform) and all but one of the last's
MASKS = ("none", "third", "dead sample")


def _inputs(b, h, lq, lk, d, mask, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    bias = None
    if mask != "none":
        keep = np.ones((b, lk), bool)
        keep[-1, max(1, lk // 3):] = False
        if mask == "dead sample":
            keep[0] = False
            keep[-1] = False
            keep[-1, lk // 2] = True
        bias = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    g = rng.randn(b, lq, h, d).astype(np.float32)   # [B, Lq, H, D]: the heads' merge
    return q, k, v, bias, g


def _jax_bias(bias):
    return None if bias is None else jnp.asarray(bias)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,h,lq,lk,d", SHAPES)
@pytest.mark.parametrize("mask", MASKS)
def test_sdpa_lse_plain_matches_xla_and_logsumexp(b, h, lq, lk, d, mask):
    """The output equals sdpa_xla's; the logsumexp plus the sample's
    largest key bias equals jax.nn.logsumexp of sdpa_xla's fp32 scores."""
    q, k, v, bias, _ = _inputs(b, h, lq, lk, d, mask)
    scale = d ** -0.5
    ref = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=_jax_bias(bias))
    scores = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k)) * scale
    if bias is not None:
        scores = scores + jnp.asarray(bias)
    ref_lse = jax.nn.logsumexp(scores, axis=-1)
    out, lse = flash_attention.sdpa_lse_plain(_t(q), _t(k), _t(v), bias=_t(bias), scale=scale)
    assert lse.shape == (b, h, lq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    c = 0.0 if bias is None else bias.max(axis=-1)   # [B, 1, 1]
    np.testing.assert_allclose(lse.numpy() + c, np.asarray(ref_lse), **TOL)


@pytest.mark.parametrize("impl", ["sdpa_backward_plain", "FlashSDPA"])
@pytest.mark.parametrize("b,h,lq,lk,d", SHAPES)
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("grad_layout", ["contiguous", "heads merged"])
def test_flash_backward_matches_jax_vjp(impl, b, h, lq, lk, d, mask, grad_layout):
    """dq, dk and dv of the plain backward (from the plain forward's output
    and logsumexp), and of FlashSDPA on the CPU, against jax.vjp of
    sdpa_xla; the incoming gradient contiguous or as the heads' merge hands
    it back (a non-contiguous [B, H, Lq, D] view of [B, Lq, H, D])."""
    q, k, v, bias, g = _inputs(b, h, lq, lk, d, mask, seed=1)
    scale = d ** -0.5
    g_heads = np.ascontiguousarray(g.transpose(0, 2, 1, 3))
    _, vjp = jax.vjp(lambda q, k, v: sdpa_xla(q, k, v, bias=_jax_bias(bias)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g_heads))]

    gy = _t(g).transpose(1, 2) if grad_layout == "heads merged" else _t(g_heads)
    assert gy.is_contiguous() == (grad_layout == "contiguous")
    if impl == "sdpa_backward_plain":
        o, lse = flash_attention.sdpa_lse_plain(_t(q), _t(k), _t(v), bias=_t(bias),
                                                scale=scale)
        got = flash_attention.sdpa_backward_plain(_t(q), _t(k), _t(v), o, gy, lse, _t(bias),
                                                  scale)
    else:
        xs = [_t(a).requires_grad_(True) for a in (q, k, v)]
        out = flash_attention.flash_sdpa_autograd(*xs, bias=_t(bias))
        out.backward(gy)
        got = [x.grad for x in xs]
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        np.testing.assert_allclose(a.numpy(), r, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("impl", ["sdpa_backward_plain", "FlashSDPA"])
@pytest.mark.parametrize("b,h,lq,lk,d", SHAPES)
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("grad_layout", ["contiguous", "heads merged"])
def test_flash_backward_bf16_matches_jax_vjp(impl, b, h, lq, lk, d, mask, grad_layout):
    """The same in bf16: dq, dk and dv of the plain backward (from the
    plain forward's bf16 output and fp32 logsumexp), and of FlashSDPA on
    the CPU, against jax.vjp of sdpa_xla on the same bf16 inputs, within
    BF16_TOL."""
    q, k, v, bias, g = _inputs(b, h, lq, lk, d, mask, seed=1)
    scale = d ** -0.5
    g_heads = np.ascontiguousarray(g.transpose(0, 2, 1, 3))
    _, vjp = jax.vjp(lambda q, k, v: sdpa_xla(q, k, v, bias=_jax_bias(bias)),
                     *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    ref = [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g_heads, jnp.bfloat16))]

    def bf(a):
        return _t(a).to(torch.bfloat16)

    gy = bf(g).transpose(1, 2) if grad_layout == "heads merged" else bf(g_heads)
    assert gy.is_contiguous() == (grad_layout == "contiguous")
    if impl == "sdpa_backward_plain":
        o, lse = flash_attention.sdpa_lse_plain(bf(q), bf(k), bf(v), bias=_t(bias),
                                                scale=scale)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        got = flash_attention.sdpa_backward_plain(bf(q), bf(k), bf(v), o, gy, lse,
                                                  _t(bias), scale)
    else:
        xs = [bf(a).requires_grad_(True) for a in (q, k, v)]
        out = flash_attention.flash_sdpa_autograd(*xs, bias=_t(bias))
        out.backward(gy)
        got = [x.grad for x in xs]
    for name, a, r in zip("qkv", got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape, name
        np.testing.assert_allclose(a.float().numpy(), r, err_msg=f"d{name}", **BF16_TOL)
