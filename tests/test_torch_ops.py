"""psg_tpu_torch kernel layer on the CPU: each kernel's plain version against
its JAX counterpart (the Pallas kernels run in interpret mode, as
tests/test_ops.py and tests/test_spatial_xattn.py run them).

Inputs are made from a seed with numpy and handed to both packages; all
comparisons are fp32.  The kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.models.unet import text_bias_from_mask as jax_text_bias
from psg_tpu.nn.attention import spatial_cross_attention as jax_spatial
from psg_tpu.nn.attention import spatial_cross_attention_init as jax_spatial_init
from psg_tpu.nn.layers import group_norm as jax_group_norm
from psg_tpu.nn.layers import largest_group_count as jax_largest_group_count
from psg_tpu.nn.layers import linear as jax_linear
from psg_tpu.ops.fused_norm import fused_group_norm_silu as jax_fused_gn
from psg_tpu.ops.spatial_xattn import fused_spatial_xattn as jax_fused_spatial
from psg_tpu.ops.xla_ref import sdpa_xla

from psg_tpu_torch import ops
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.unet import text_bias_from_mask
from psg_tpu_torch.nn.attention import spatial_cross_attention
from psg_tpu_torch.ops.flash_attention import flash_sdpa
from psg_tpu_torch.ops.fused_norm import fused_group_norm_silu
from psg_tpu_torch.ops.spatial_xattn import fused_spatial_xattn

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# sdpa / flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,lq,lk,d", [
    (2, 2, 49, 49, 8),      # UNet self-attention level (narrow)
    (1, 4, 16, 128, 160),   # UNet hd-160 cross-attention against 128 text keys
    (2, 2, 9, 40, 320),     # hd 320, ragged key count
    (1, 2, 33, 17, 6),      # odd everything
])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_plain_matches_xla(b, h, lq, lk, d, masked):
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    bias = None
    if masked:
        mask = np.ones((b, lk), np.int32)
        mask[:, lk // 2:] = 0
        bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    ref = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   bias=None if bias is None else jnp.asarray(bias))
    got = ops.sdpa(_t(q), _t(k), _t(v), bias=None if bias is None else _t(bias))
    # fp32 on both sides; only summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,h,lq,lk,d", [
    (2, 2, 32, 24, 16),     # hd 16 (the VAE's 54^2 site, narrow)
    (1, 3, 33, 17, 6),      # odd everything (tiny configs)
])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_sdpa_matches_pallas_interpret(b, h, lq, lk, d, masked):
    """The port's flash_sdpa against the TPU kernel itself, run in interpret
    mode as tests/test_ops.py runs it."""
    from jax.experimental.pallas import tpu as pltpu

    from psg_tpu.ops.flash_attention import flash_sdpa as jax_flash

    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (lq, lk, lk))
    bias = None
    if masked:
        mask = np.ones((b, lk), np.int32)
        mask[-1, lk // 3:] = 0
        bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        bias=None if bias is None else jnp.asarray(bias))
    got = flash_sdpa(_t(q), _t(k), _t(v), bias=None if bias is None else _t(bias))
    # fp32 on both sides; only summation order differs (the TPU kernel pads
    # the keys to 128 with -1e9 bias, whose exp() is exactly 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,l,h,d", [(2, 49, 4, 8), (1, 16, 2, 6)])
def test_sdpa_takes_head_views_of_one_projection(b, l, h, d):
    """q, k and v as transposed (non-contiguous) head views of one
    [B, L, 3C] tensor, as an in_proj gives them: the same values as on
    contiguous copies."""
    c = h * d
    qkv = _t(np.random.RandomState(3).randn(b, l, 3 * c).astype(np.float32))
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, l, h, d).transpose(1, 2)
               for i in range(3))
    assert not q.is_contiguous() and q.stride(-1) == 1
    got = ops.sdpa(q, k, v)
    ref = ops.sdpa(q.contiguous(), k.contiguous(), v.contiguous())
    assert got.shape == (b, h, l, d)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_sdpa_mixed_dtypes_promote_and_return_q_dtype():
    rng = np.random.RandomState(1)
    q = _t(rng.randn(1, 2, 8, 16).astype(np.float32)).bfloat16()
    k = _t(rng.randn(1, 2, 8, 16).astype(np.float32))
    out = ops.sdpa(q, k, k)
    ref = ops.sdpa(q.float(), k, k).bfloat16()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_sdpa_takes_clips_causal_padding_bias():
    """CLIP's causal + padding bias [B, 1, L, L] (psg_tpu/models/clip.py):
    ops.sdpa sends it to the plain version, as the reference's ops.sdpa
    sends it to sdpa_xla, and matches sdpa_xla; the flash kernel's wrapper
    still refuses it, as the TPU kernel does."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 4, 7, 8).astype(np.float32) for _ in range(3))
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    causal = np.tril(np.ones((7, 7), np.float32))
    bias = (np.where(causal[None, None] > 0, 0.0, -1e9)
            + np.where(mask[:, None, None, :] > 0, 0.0, -1e9)).astype(np.float32)
    assert bias.shape == (2, 1, 7, 7)
    ref = sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias))
    got = ops.sdpa(_t(q), _t(k), _t(v), bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError):
        flash_sdpa(_t(q), _t(k), _t(v), bias=_t(bias))


# ---------------------------------------------------------------------------
# GroupNorm + SiLU
# ---------------------------------------------------------------------------


def _gn_case(b, s, c, mean=0.3, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, s, c) * 2 + mean).astype(np.float32)
    scale = np.linspace(0.5, 1.5, c).astype(np.float32)
    bias = np.linspace(-0.2, 0.2, c).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("b,s,c,g", [(2, 64, 32, 8), (1, 729, 320, 32),
                                     (2, 49, 48, 16)])
def test_group_norm_silu_matches_pallas_interpret(b, s, c, g):
    from jax.experimental.pallas import tpu as pltpu

    x, scale, bias = _gn_case(b, s, c)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_fused_gn({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                           jnp.asarray(x), g)
    got = fused_group_norm_silu({"scale": _t(scale), "bias": _t(bias)}, _t(x), g)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mean", [0.3, 1000.0])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_silu_matches_two_pass_reference(mean, silu):
    """Against the JAX package's two-pass oracle, including a large-mean input
    (where an E[x^2] - mean^2 variance loses the variance to cancellation)."""
    x, scale, bias = _gn_case(2, 9 * 9, 16, mean=mean)
    x = x.reshape(2, 9, 9, 16)  # 4-D channels-last input
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    ref = jax_group_norm(p, jnp.asarray(x), 8)
    if silu:
        ref = jax.nn.silu(ref)
    got = fused_group_norm_silu({"scale": _t(scale), "bias": _t(bias)}, _t(x), 8,
                                silu=silu)
    assert got.shape == x.shape
    # at mean 1000 the inputs' own fp32 spacing (6e-5) is 3e-5 of one std,
    # and the two means (different summation orders) differ by about that:
    # 1e-3 still rejects the single-pass variance, which is off by 7e-2 here
    atol = 1e-3 if mean > 100 else 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=atol)


# ---------------------------------------------------------------------------
# fused spatial cross-attention
# ---------------------------------------------------------------------------

B, HW, C, S, TEXT_DIM, HEADS = 2, 21, 64, 12, 48, 8


@pytest.fixture(scope="module")
def spatial_setup():
    params = jax_spatial_init(jax.random.PRNGKey(0), C, TEXT_DIM)
    rng = np.random.RandomState(1)
    x = rng.randn(B, HW, HW, C).astype(np.float32)
    text = rng.randn(B, S, TEXT_DIM).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, 7:] = 0
    return _np_tree(params), x, text, mask


def _amplified(params):
    """Q projection x120: head logits span hundreds, so cold heads sit far
    below hot ones (the fp32 exp underflow range)."""
    p = jax.tree_util.tree_map(lambda a: a, params)
    p["q"] = {"w": params["q"]["w"] * 120.0, "b": params["q"]["b"]}
    return p


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cold", [False, True])
def test_fused_spatial_matches_pallas_interpret(spatial_setup, compat, masked, cold):
    params, x, text, mask = spatial_setup
    if cold:
        params = _amplified(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    b, h, w, c = x.shape
    xn = jax_group_norm(jp["norm"], jnp.asarray(x), jax_largest_group_count(c),
                        eps=1e-5)
    k = jax_linear(jp["k"], jnp.asarray(text))
    v = jax_linear(jp["v"], jnp.asarray(text))
    jbias = jax_text_bias(jnp.asarray(mask)) if masked else None
    ref = jax_fused_spatial(
        xn.reshape(b, h * w, c), jnp.asarray(x).reshape(b, h * w, c), k, v,
        jp["q"]["w"].reshape(c, c), jp["q"]["b"], jp["proj"]["w"].reshape(c, c),
        jp["proj"]["b"], num_heads=HEADS, text_bias=jbias, compat_reshape=compat,
        interpret=True)
    tbias = text_bias_from_mask(_t(mask)) if masked else None
    got = fused_spatial_xattn(
        _t(np.asarray(xn)).reshape(b, h * w, c), _t(x).reshape(b, h * w, c),
        _t(np.asarray(k)), _t(np.asarray(v)),
        _t(params["q"]["w"]).reshape(c, c), _t(params["q"]["b"]),
        _t(params["proj"]["w"]).reshape(c, c), _t(params["proj"]["b"]),
        num_heads=HEADS, text_bias=tbias, compat_reshape=compat)
    assert np.isfinite(got.numpy()).all()
    # cold-head logits reach the hundreds, so fp32 rounding of the scores
    # is amplified; the per-head max keeps every head finite either way
    tol = 2e-3 if cold else 2e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cold", [False, True])
def test_fused_spatial_bf16_matches_pallas_interpret(spatial_setup, compat, masked,
                                                     cold):
    """bf16 on both sides, with Wq and Wp cast to bf16 as
    psg_tpu/nn/attention.py:170 casts them: the plain version rounds q *
    scale, P and o where the TPU kernel rounds them."""
    params, x, text, mask = spatial_setup
    if cold:
        params = _amplified(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    b, h, w, c = x.shape
    bf = jnp.bfloat16
    xn = jax_group_norm(jp["norm"], jnp.asarray(x), jax_largest_group_count(c),
                        eps=1e-5).reshape(b, h * w, c).astype(bf)
    res = jnp.asarray(x).reshape(b, h * w, c).astype(bf)
    k = jax_linear(jp["k"], jnp.asarray(text))   # fp32, as the block gives them
    v = jax_linear(jp["v"], jnp.asarray(text))
    wq = jp["q"]["w"].reshape(c, c).astype(bf)
    wp = jp["proj"]["w"].reshape(c, c).astype(bf)
    jbias = jax_text_bias(jnp.asarray(mask)) if masked else None
    ref = jax_fused_spatial(xn, res, k, v, wq, jp["q"]["b"], wp, jp["proj"]["b"],
                            num_heads=HEADS, text_bias=jbias, compat_reshape=compat,
                            interpret=True)
    tbias = text_bias_from_mask(_t(mask)) if masked else None
    got = fused_spatial_xattn(
        _t(_bf16_np(xn)).bfloat16(), _t(_bf16_np(res)).bfloat16(),
        _t(np.asarray(k)), _t(np.asarray(v)), _t(_bf16_np(wq)).bfloat16(),
        _t(params["q"]["b"]), _t(_bf16_np(wp)).bfloat16(), _t(params["proj"]["b"]),
        num_heads=HEADS, text_bias=tbias, compat_reshape=compat)
    assert got.dtype == torch.bfloat16
    # two bf16 steps of the output (2^-7 relative each); both sides sum in
    # fp32 on the CPU, so their bf16 roundings of q * scale and P agree, and
    # the cold heads need no looser bound here (the card's kernel sums q in
    # another order: see tests/test_torch_cuda.py COLD_TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("cold", [False, True])
def test_spatial_masked_keys_are_exactly_zero_and_droppable(cold):
    """The premise of the kernel's skipping of masked keys, in the plain
    version at fp32: a key with bias -1e9 has probability exactly 0.0 (cold
    heads included), so a mask with holes in the middle gives the output of
    dropping those keys from K, V and the bias."""
    from psg_tpu_torch.ops import spatial_xattn as sx

    rng = np.random.RandomState(4)
    b, l, c, s = 2, 50, 32, 40
    xn, res = (_t(rng.randn(b, l, c).astype(np.float32)) for _ in range(2))
    kh, vh = (_t(rng.randn(b, HEADS, s, c // HEADS).astype(np.float32))
              for _ in range(2))
    wq = _t((rng.randn(c, c) * c ** -0.5 * (120.0 if cold else 1.0)).astype(np.float32))
    wp = _t((rng.randn(c, c) * c ** -0.5).astype(np.float32))
    bq, bp = (_t((rng.randn(c) * 0.1).astype(np.float32)) for _ in range(2))
    j = np.arange(s)
    keep = np.stack([(j % 3 != 1) & ((j < 10) | (j >= 25)),   # holes in the middle
                     (j >= 5) & (j < 30)])                      # holes at both ends
    bias = _t(np.where(keep, 0.0, -1e9).astype(np.float32))
    scale = (c // HEADS) ** -0.5
    p = sx.spatial_probs_plain(xn, kh, wq, bq, key_bias=bias, scale=scale)
    dead = torch.from_numpy(~keep)[:, None, None, :].expand_as(p)
    assert torch.all(p[dead] == 0.0)
    if cold:   # logits span hundreds within a row
        assert (p.amax(-1) > 0.99).float().mean() > 0.5
    got = sx.spatial_xattn_plain(xn, res, kh, vh, wq, bq, wp, bp, key_bias=bias,
                                 scale=scale)
    for i in range(b):
        kk = torch.from_numpy(keep[i])
        want = sx.spatial_xattn_plain(
            xn[i:i + 1], res[i:i + 1], kh[i:i + 1, :, kk], vh[i:i + 1, :, kk], wq, bq,
            wp, bp, key_bias=bias[i:i + 1, kk], scale=scale)
        torch.testing.assert_close(got[i:i + 1], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("compat", [False, True])
def test_spatial_block_matches_xla_path(spatial_setup, compat):
    """nn.attention.spatial_cross_attention: the port's dispatch (C = 64 ->
    fused op) against the JAX package's conv + sdpa path."""
    params, x, text, mask = spatial_setup
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = jax_spatial(jp, jnp.asarray(x), jnp.asarray(text), num_heads=HEADS,
                      text_bias=jax_text_bias(jnp.asarray(mask)),
                      compat_reshape=compat)
    got = spatial_cross_attention(bridge.from_jax(params), _t(x), _t(text),
                                  num_heads=HEADS,
                                  text_bias=text_bias_from_mask(_t(mask)),
                                  compat_reshape=compat)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the spatial block's gradient (SpatialXattn) against the TPU kernel's custom_vjp
# ---------------------------------------------------------------------------


def _spatial_grad_operands(cold, masked, seed=5):
    """fp32 operands of the fused block: B 2, L 81, C 64, S 12, 8 heads.
    ``cold``: head 0's query carries a large bias along key 0's head-0
    channels, so key 0's head-0 score sits about 170 above the other heads'
    scores (one-hot in fp32) and every other head is cold against it: a
    shared row max would underflow their exp() to 0 and NaN the
    gradient."""
    rng = np.random.RandomState(seed)
    b, l, c, s = 2, 81, 64, 12
    xn, res = (rng.randn(b, l, c).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, s, c).astype(np.float32) for _ in range(2))
    wq, wp = ((rng.randn(c, c) * c ** -0.5).astype(np.float32) for _ in range(2))
    bq, bp = ((rng.randn(c) * 0.1).astype(np.float32) for _ in range(2))
    if cold:
        bq[:8] = 20.0
        k[:, 0, :8] = 3.0
    mask = np.ones((b, s), np.int32)
    if masked:
        mask[1, 5:] = 0
    g = rng.randn(b, l, c).astype(np.float32)
    return [xn, res, k, v, wq, bq, wp, bp], mask, g


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cold", [False, True])
def test_spatial_gradients_match_custom_vjp(compat, masked, cold):
    """SpatialXattn (the plain forward on the CPU; the backward recomputes
    the fp32 body in chunks of rows) against jax.vjp of the TPU kernel's
    custom_vjp (_fused, interpret mode): every operand's gradient within
    1e-5 * max|g| + 1e-7, all finite; no [B, H, L, S] tensor is saved."""
    from psg_tpu_torch.ops import spatial_xattn as sx

    operands, mask, g = _spatial_grad_operands(cold, masked)
    jbias = jax_text_bias(jnp.asarray(mask)) if masked else None

    def jax_block(xn, res, k, v, wq, bq, wp, bp):
        return jax_fused_spatial(xn, res, k, v, wq, bq, wp, bp, num_heads=HEADS,
                                 text_bias=jbias, compat_reshape=compat, interpret=True)

    ref_out, vjp = jax.vjp(jax_block, *map(jnp.asarray, operands))
    ref = vjp(jnp.asarray(g))
    xs = [_t(a).requires_grad_(True) for a in operands]
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    b, l, c = operands[0].shape
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fused_spatial_xattn(*xs, num_heads=HEADS,
                                  text_bias=text_bias_from_mask(_t(mask)) if masked else None,
                                  compat_reshape=compat)
    assert type(out.grad_fn).__name__ == "SpatialXattnBackward"
    assert max(saved) < b * HEADS * l * operands[2].shape[1]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=2e-5,
                               atol=2e-5)
    got = torch.autograd.grad(out, xs, _t(g))
    names = ("xn", "residual", "k", "v", "wq", "bq", "wp", "bp")
    for name, gg, r in zip(names, got, ref):
        r = np.asarray(r)
        assert np.isfinite(gg.numpy()).all(), name
        bound = 1e-5 * np.abs(r).max() + 1e-7
        err = np.abs(gg.numpy() - r).max()
        assert err <= bound, f"{name}: max|dg| {err:.3g} > {bound:.3g}"
    # the chunked backward gives the one-chunk result
    old = sx.CHUNK_BYTES
    try:
        sx.CHUNK_BYTES = 2 * HEADS * 17 * operands[2].shape[1] * 4   # 17 rows a chunk
        assert sx.backward_rows(b, HEADS, operands[2].shape[1]) == 17
        out = fused_spatial_xattn(*xs, num_heads=HEADS,
                                  text_bias=text_bias_from_mask(_t(mask)) if masked else None,
                                  compat_reshape=compat)
        chunked = torch.autograd.grad(out, xs, _t(g))
    finally:
        sx.CHUNK_BYTES = old
    for name, a, r in zip(names, chunked, got):   # the sums over chunks differ in order
        err, bound = float((a - r).abs().max()), 1e-6 * float(r.abs().max()) + 1e-7
        assert err <= bound, f"{name} chunked: max|dg| {err:.3g} > {bound:.3g}"


def test_spatial_backward_is_not_autograd_of_the_bf16_plain_version():
    """bf16 operands: the Function's gradient is the fp32 body's, cast to
    each input's dtype, not the autograd of the plain version's bf16
    roundings (which would round the gradient at each rounding point)."""
    from psg_tpu_torch.ops import spatial_xattn as sx

    operands, mask, g = _spatial_grad_operands(False, True)
    xs = [_t(a) for a in operands]
    xs[0], xs[1], xs[4], xs[6] = (t.bfloat16() for t in (xs[0], xs[1], xs[4], xs[6]))
    bias = text_bias_from_mask(_t(mask))

    def grads(fn, inputs):
        inputs = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*inputs), inputs, _t(g).bfloat16())

    got = grads(lambda *a: fused_spatial_xattn(*a, num_heads=HEADS, text_bias=bias), xs)
    fp32 = grads(lambda *a: fused_spatial_xattn(*a, num_heads=HEADS, text_bias=bias),
                 [t.float() for t in xs])
    rounded = grads(lambda xn, res, k, v, wq, bq, wp, bp: sx.spatial_xattn_plain(
        xn, res, sx.split_heads(k, HEADS, False), sx.split_heads(v, HEADS, False), wq, bq,
        wp, bp, key_bias=bias.reshape(2, -1), scale=0.125 ** 0.5), xs)
    for a, f, r, x in zip(got, fp32, rounded, xs):
        assert a.dtype == x.dtype
        # the bf16 operands' values in fp32 give the same gradient, rounded once
        torch.testing.assert_close(a, f.to(x.dtype), rtol=0, atol=0)
    assert any(not torch.equal(a, r) for a, r in zip(got, rounded))


def test_decoder_residual_reaches_the_spatial_block_in_its_own_dtype(monkeypatch):
    """The decoder's fused sites hand the block its residual uncast: in bf16
    the residual is bf16 already (a convolution's output), so the block adds
    it in fp32 as the TPU kernel does and nothing is rounded on the way."""
    from psg_tpu_torch.models import vae as tvae
    from psg_tpu_torch.nn import attention

    seen = []
    real = attention.fused_spatial_xattn

    def spy(xn, residual, *a, **kw):
        seen.append((xn.dtype, residual.dtype))
        return real(xn, residual, *a, **kw)

    monkeypatch.setattr(attention, "fused_spatial_xattn", spy)
    params = tvae.vae_init(torch.Generator().manual_seed(0), 8, 16, 0.25)
    rng = np.random.RandomState(6)
    latent = _t(rng.randn(1, 9, 9, 8).astype(np.float32))
    text = _t(rng.randn(1, 5, 16).astype(np.float32))
    with torch.no_grad():
        img = tvae.vae_decode(params, latent, text, dtype=torch.bfloat16, image_size=64)
    assert img.dtype == torch.bfloat16 and torch.isfinite(img.float()).all()
    assert seen and all(d == (torch.bfloat16, torch.bfloat16) for d in seen)


def test_launch_counters_untouched_on_cpu():
    """Plain versions on the CPU are not kernel launches, forward or
    backward (FlashSDPA on the CPU takes the plain backward)."""
    from psg_tpu_torch.ops import flash_attention

    ops.reset_launch_counts()
    x = torch.randn(1, 4, 8)
    ops.group_norm_silu({"scale": torch.ones(8), "bias": torch.zeros(8)}, x, 4)
    ops.sdpa(torch.randn(1, 2, 4, 8), torch.randn(1, 2, 4, 8), torch.randn(1, 2, 4, 8))
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    flash_attention.flash_sdpa_autograd(q, q, q).sum().backward()
    assert q.grad is not None
    assert ops.launch_counts() == {"group_norm_silu": 0, "flash_attention": 0,
                                   "spatial_xattn": 0, "flash_attention_bwd": 0}
