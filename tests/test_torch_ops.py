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


def test_sdpa_mixed_dtypes_promote_and_return_q_dtype():
    rng = np.random.RandomState(1)
    q = _t(rng.randn(1, 2, 8, 16).astype(np.float32)).bfloat16()
    k = _t(rng.randn(1, 2, 8, 16).astype(np.float32))
    out = ops.sdpa(q, k, k)
    ref = ops.sdpa(q.float(), k, k).bfloat16()
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def test_flash_rejects_non_key_bias():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(NotImplementedError):
        flash_sdpa(q, q, q, bias=torch.zeros(1, 2, 8, 8))


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


def test_launch_counters_untouched_on_cpu():
    """Plain versions on the CPU are not kernel launches."""
    ops.reset_launch_counts()
    x = torch.randn(1, 4, 8)
    ops.group_norm_silu({"scale": torch.ones(8), "bias": torch.zeros(8)}, x, 4)
    ops.sdpa(torch.randn(1, 2, 4, 8), torch.randn(1, 2, 4, 8), torch.randn(1, 2, 4, 8))
    assert ops.launch_counts() == {"group_norm_silu": 0, "flash_attention": 0,
                                   "spatial_xattn": 0}
