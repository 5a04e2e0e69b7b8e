"""psg_tpu_torch's hand-written kernels on the card, each against its plain
PyTorch version on the same CUDA inputs.

Marked ``cuda``: every test takes the ``card`` fixture, which skips when
there is no CUDA device and otherwise builds the three kernel libraries
once.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: fp32 differs from the plain version only in summation order and
the fast ``__expf``; bf16 outputs may also round one bf16 step apart, and the
attention kernel keeps its probabilities in fp32 where the plain version
rounds them to bf16 before the product with V.
"""

import numpy as np
import pytest
import torch

from psg_tpu_torch import ops
from psg_tpu_torch.ops import cuda_build, flash_attention, fused_norm, spatial_xattn

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and run the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all(k for k in ops.KERNELS)
    return torch.device("cuda")


def _randn(shape, seed, dev, dtype=torch.float32, scale=1.0, shift=0.0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(dev).to(dtype)


def _close(got, ref, dtype):
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c,g,shift", [
    (8, 729, 320, 32, 0.3),     # UNet 27^2
    (8, 16, 2560, 32, 0.0),     # UNet 4^2 decoder input
    (4, 46225, 64, 32, 0.5),    # VAE 215^2 x 64
    (4, 46225, 32, 8, 0.0),     # VAE final norm
    (2, 81, 16, 16, 1000.0),    # large mean: two-pass statistics
    (1, 5, 24, 8, 0.0),         # fewer rows than one chunk
])
def test_group_norm_silu_kernel(card, dtype, b, s, c, g, shift):
    x = _randn((b, s, c), 0, card, dtype, scale=2.0, shift=shift)
    p = {"scale": _randn((c,), 1, card, scale=0.3, shift=1.0),
         "bias": _randn((c,), 2, card, scale=0.1)}
    for silu in (True, False):
        got = fused_norm.fused_group_norm_silu(p, x, g, silu=silu)
        ref = fused_norm.group_norm_silu_plain(p, x, g, silu=silu)
        assert got.dtype == dtype and got.shape == x.shape
        # at mean 1000 fp32 inputs are spaced 6e-5 apart, 3e-5 of one std
        tol = dict(rtol=1e-4, atol=1e-3) if shift > 100 and dtype == torch.float32 \
            else TOL[dtype]
        torch.testing.assert_close(got.float(), ref.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,masked", [
    (4, 12, 128, 128, 64, True),    # BERT-base
    (8, 4, 196, 196, 160, False),   # UNet 14^2 self-attention
    (8, 4, 49, 128, 320, True),     # UNet 7^2 cross-attention, hd 320
    (8, 4, 16, 16, 320, False),     # UNet 4^2 self-attention
    (4, 8, 2916, 128, 16, True),    # VAE 54^2 site
    (2, 4, 33, 17, 6, True),        # ragged everything (tiny configs)
    (1, 2, 5, 3, 4, False),
])
def test_flash_attention_kernel(card, dtype, b, h, lq, lk, d, masked):
    q = _randn((b, h, lq, d), 0, card, dtype)
    k = _randn((b, h, lk, d), 1, card, dtype)
    v = _randn((b, h, lk, d), 2, card, dtype)
    bias = None
    if masked:
        keep = torch.arange(lk, device=card)[None, :] < torch.tensor(
            [lk, max(1, lk // 3)] * b, device=card)[:b, None]
        bias = torch.where(keep, 0.0, -1e9).float()[:, None, None, :]
    got = flash_attention.flash_sdpa(q, k, v, bias=bias)
    ref = flash_attention.sdpa_plain(q, k, v, bias=bias, scale=d ** -0.5)
    assert got.dtype == dtype
    _close(got, ref, dtype)


def _spatial_operands(dev, dtype, b, l, c, s, seed=0, cold=False):
    xn = _randn((b, l, c), seed, dev, dtype)
    res = _randn((b, l, c), seed + 1, dev, dtype)
    k = _randn((b, s, c), seed + 2, dev)
    v = _randn((b, s, c), seed + 3, dev)
    wq = _randn((c, c), seed + 4, dev, scale=c ** -0.5 * (120.0 if cold else 1.0))
    wp = _randn((c, c), seed + 5, dev, scale=c ** -0.5)
    bq, bp = _randn((c,), seed + 6, dev, scale=0.1), _randn((c,), seed + 7, dev, scale=0.1)
    mask = torch.ones(b, s, device=dev)
    mask[-1, s // 3:] = 0
    bias = torch.where(mask > 0, 0.0, -1e9).float()[:, None, None, :]
    return xn, res, k, v, wq, bq, wp, bp, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c,s,cold,compat", [
    (4, 108, 64, 128, False, False),   # VAE 108^2 site
    (4, 215, 32, 128, True, False),    # VAE 215^2 site, cold heads
    (2, 21, 64, 12, True, True),       # compat_reshape
    (2, 9, 8, 7, False, False),        # tiny config: head dim 1
    (1, 5, 16, 256, False, True),      # most keys the kernel takes
])
def test_spatial_xattn_kernel(card, dtype, b, hw, c, s, cold, compat):
    xn, res, k, v, wq, bq, wp, bp, bias = _spatial_operands(card, dtype, b, hw * hw, c,
                                                            s, cold=cold)
    got = spatial_xattn.fused_spatial_xattn(xn, res, k, v, wq, bq, wp, bp, num_heads=8,
                                            text_bias=bias, compat_reshape=compat)
    scale = (c // 8) ** -0.5
    kh = spatial_xattn.split_heads(k, 8, compat).contiguous()
    vh = spatial_xattn.split_heads(v, 8, compat).contiguous()
    ref = spatial_xattn.spatial_xattn_plain(xn, res, kh, vh, wq, bq, wp, bp,
                                            key_bias=bias.reshape(b, s), scale=scale)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    if cold and dtype == torch.float32:
        # cold-head logits reach the hundreds: fp32 rounding of the scores
        # and __expf's error grow with them
        torch.testing.assert_close(got, ref, rtol=2e-3, atol=2e-3)
    else:
        _close(got, ref, dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.zeros(2, 8, 64, device=card)
    p = {"scale": torch.ones(64, device=card), "bias": torch.zeros(64, device=card)}
    with pytest.raises(ValueError):
        fused_norm.fused_group_norm_silu(p, x, 64)                 # > 32 groups
    with pytest.raises(ValueError):
        fused_norm.fused_group_norm_silu(p, x.transpose(0, 1), 8)  # not contiguous
    with pytest.raises(TypeError):
        fused_norm.fused_group_norm_silu(p, x.half(), 8)
    q = torch.zeros(1, 2, 8, 16, device=card)
    with pytest.raises(NotImplementedError):
        flash_attention.flash_sdpa(q, q, q, bias=torch.zeros(1, 2, 8, 8, device=card))
    big = torch.zeros(1, 1, 8, 1024, device=card)
    with pytest.raises(ValueError):
        flash_attention.flash_sdpa(big, big, big)                  # shared memory
    with pytest.raises(TypeError):
        flash_attention.flash_sdpa(q, q.bfloat16(), q)
    for c in (24, 72):                                             # not built
        ops_ = _spatial_operands(card, torch.float32, 1, 16, c, 8)
        with pytest.raises(ValueError):
            spatial_xattn.fused_spatial_xattn(*ops_[:8], num_heads=8)
    ops_ = _spatial_operands(card, torch.float32, 1, 16, 32, 300)
    with pytest.raises(ValueError):
        spatial_xattn.fused_spatial_xattn(*ops_[:8], num_heads=8)  # S > 256


def test_each_wrapper_call_counts_one_launch(card):
    ops.reset_launch_counts()
    x = torch.randn(2, 16, 32, device=card)
    ops.group_norm_silu({"scale": torch.ones(32, device=card),
                         "bias": torch.zeros(32, device=card)}, x, 8)
    q = torch.randn(2, 4, 16, 8, device=card)
    ops.sdpa(q, q, q)
    ops.sdpa(q, q, q)
    operands = _spatial_operands(card, torch.float32, 1, 16, 32, 8)
    spatial_xattn.fused_spatial_xattn(*operands[:8], num_heads=8)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"group_norm_silu": 1, "flash_attention": 2,
                                   "spatial_xattn": 1}
