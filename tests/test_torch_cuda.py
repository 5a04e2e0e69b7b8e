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
    # the VAE encoder, batch 1 (image+text, retrieval) and 4 (batched
    # retrieval, restarts); 107^2 x 32 has one channel a group and takes the
    # cluster path in bf16 (732 KB a sample), the split path in fp32
    (1, 11449, 32, 32, 0.3), (4, 11449, 32, 32, 0.0),
    (1, 2809, 64, 32, 0.3), (4, 2809, 64, 32, 0.0),
    (1, 729, 128, 32, 0.3), (4, 729, 128, 32, 0.0),
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


# The GN kernel takes one launch (a thread-block cluster per sample) while a
# sample's rows split 8 ways leave at most 128 KB a CTA: S <= 816 at C = 640
# in bf16, S <= 408 in fp32.  These are the largest sample on that path and
# the smallest past it.
GN_BOUNDARY = {torch.bfloat16: (816, 817), torch.float32: (408, 409)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("shift", [0.3, 1000.0])
def test_group_norm_silu_paths_deterministic(card, dtype, side, shift):
    s = GN_BOUNDARY[dtype][side]
    test_group_norm_silu_kernel(card, dtype, 2, s, 640, 32, shift)
    x = _randn((2, s, 640), 4, card, dtype, scale=2.0, shift=shift)
    p = {"scale": _randn((640,), 5, card, scale=0.3, shift=1.0),
         "bias": _randn((640,), 6, card, scale=0.1)}
    first = fused_norm.fused_group_norm_silu(p, x, 32)
    for _ in range(3):   # no atomics: repeat runs are bit-equal
        assert torch.equal(fused_norm.fused_group_norm_silu(p, x, 32), first)


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


# bf16 flash attention at the 12 main-path shapes of chip_smoke.py phase 2
@pytest.mark.parametrize("b,h,lq,lk,d,masked", [
    (4, 12, 128, 128, 64, True),    # BERT-base
    (1, 12, 128, 128, 64, True),    # BERT-base, one prompt
    (8, 4, 196, 196, 160, False),   # UNet 14^2 self-attention
    (8, 4, 196, 128, 160, True),    # UNet 14^2 cross-attention
    (8, 4, 49, 49, 320, False),     # UNet 7^2 self-attention
    (8, 4, 49, 128, 320, True),     # UNet 7^2 cross-attention
    (8, 4, 16, 16, 320, False),     # UNet 4^2 self-attention
    (8, 4, 16, 128, 320, True),     # UNet 4^2 cross-attention
    (4, 8, 729, 128, 64, True),     # VAE 27^2, C 512
    (4, 8, 729, 128, 32, True),     # VAE 27^2, C 256
    (4, 8, 2916, 128, 16, True),    # VAE 54^2, C 128
    (32, 12, 50, 50, 64, False),    # CLIP ViT-B/32 vision (stage 3), no bias
])
def test_flash_attention_main_path_bf16(card, b, h, lq, lk, d, masked):
    test_flash_attention_kernel(card, torch.bfloat16, b, h, lq, lk, d, masked)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [4, 6, 16, 160, 320])
def test_flash_attention_head_dims(card, dtype, d):
    test_flash_attention_kernel(card, dtype, 2, 3, 37, 70, d, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,l,d", [(2, 4, 196, 160), (2, 4, 49, 320), (2, 3, 21, 6)])
def test_flash_attention_strided_operands(card, dtype, b, h, l, d):
    """q, k and v as head views of one in_proj-shaped [B, L, 3C] tensor: the
    kernel reads them in place, writes [B, L, H, D] memory, and gives the
    bits it gives on contiguous copies."""
    c = h * d
    qkv = _randn((b, l, 3 * c), 3, card, dtype)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, l, h, d).transpose(1, 2)
               for i in range(3))
    assert not q.is_contiguous() and q.stride(-1) == 1
    ops.reset_launch_counts()
    got = ops.sdpa(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 1
    assert got.shape == (b, h, l, d) and got.transpose(1, 2).is_contiguous()
    merged = got.transpose(1, 2).reshape(b, l, c)
    assert merged.data_ptr() == got.data_ptr()   # merging heads is a view
    ref = flash_attention.flash_sdpa(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, ref)
    _close(got, flash_attention.sdpa_plain(q, k, v, scale=d ** -0.5), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_all_keys_masked_but_one(card, dtype):
    b, h, lq, lk, d = 3, 4, 40, 150, 64
    q = _randn((b, h, lq, d), 0, card, dtype)
    k = _randn((b, h, lk, d), 1, card, dtype)
    v = _randn((b, h, lk, d), 2, card, dtype)
    kept = torch.tensor([0, 77, lk - 1], device=card)
    keep = torch.arange(lk, device=card)[None, :] == kept[:, None]
    bias = torch.where(keep, 0.0, -1e9).float()[:, None, None, :]
    got = flash_attention.flash_sdpa(q, k, v, bias=bias)
    _close(got, flash_attention.sdpa_plain(q, k, v, bias=bias, scale=d ** -0.5), dtype)
    want = v[torch.arange(b, device=card), :, kept][:, :, None, :].expand_as(got)
    _close(got, want, dtype)


# live keys of each sample, by mask kind (a key is masked with bias -1e9)
PROMPT_KEYS = (13, 12, 9, 9)   # chip_smoke.py's PROMPTS under the committed vocab


def _live_keys(kind, b, s, dev):
    """[B, S] bool, or None for no text bias."""
    j = torch.arange(s, device=dev)[None, :]
    if kind == "unmasked":
        return None
    if kind == "third":      # the last sample's prompt is a third of the text length
        n = [s] * (b - 1) + [max(1, s // 3)]
    elif kind == "prompt":   # prompt lengths 9-17 of 128
        n = [(9, 12, 13, 17)[i % 4] for i in range(b)]
    elif kind == "counts":   # live-key counts off the 16-key step, and past 128
        n = [(1, 7, 17, 130)[i % 4] for i in range(b)]
    elif kind == "none":     # the first sample has every key masked
        n = [0] + [max(1, s // 3)] * (b - 1)
    elif kind == "holes":    # holes in the middle, not only padding at the end
        keep = (j % 3 != 1) & ((j < s // 4) | (j >= s // 2))
        return keep.expand(b, s).clone()
    else:
        raise ValueError(kind)
    return j < torch.tensor(n, device=dev)[:, None]


def _spatial_operands(dev, dtype, b, l, c, s, seed=0, cold=False, mask="third"):
    xn = _randn((b, l, c), seed, dev, dtype)
    res = _randn((b, l, c), seed + 1, dev, dtype)
    k = _randn((b, s, c), seed + 2, dev)
    v = _randn((b, s, c), seed + 3, dev)
    wq = _randn((c, c), seed + 4, dev, scale=c ** -0.5 * (120.0 if cold else 1.0))
    wp = _randn((c, c), seed + 5, dev, scale=c ** -0.5)
    bq, bp = _randn((c,), seed + 6, dev, scale=0.1), _randn((c,), seed + 7, dev, scale=0.1)
    keep = _live_keys(mask, b, s, dev)
    bias = None if keep is None else torch.where(keep, 0.0, -1e9).float()[:, None, None, :]
    return xn, res, k, v, wq, bq, wp, bp, bias


# cold-head logits reach the hundreds.  fp32: rounding of the scores and
# __expf's error grow with them.  bf16: kernel and plain version round q *
# scale to bf16 at the same point, but sum q in other orders, so a q element
# can land one bf16 step apart, which moves one head's score by about 0.25
# and that pixel's output by up to about 0.1 (chip_smoke.py: COLD_TOL).
COLD_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
            torch.bfloat16: dict(rtol=2e-2, atol=1e-1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,c,s,cold,compat,mask", [
    (4, 108, 64, 128, False, False, "third"),    # VAE 108^2 site
    (4, 215, 32, 128, True, False, "third"),     # VAE 215^2 site, cold heads
    (4, 108, 64, 128, False, False, "prompt"),   # VAE 108^2 site, prompt masks
    (4, 215, 32, 128, False, False, "prompt"),   # VAE 215^2 site, prompt masks
    (4, 45, 32, 128, True, False, "prompt"),     # cold heads over few live keys
    (2, 21, 64, 12, True, True, "third"),        # compat_reshape
    (2, 9, 8, 7, False, False, "third"),         # tiny config: head dim 1
    (1, 5, 16, 256, False, True, "third"),       # most keys the kernel takes
    (2, 40, 32, 256, False, False, "unmasked"),  # 256 live keys: two softmax passes
    (1, 9, 64, 256, True, False, "unmasked"),    # ... at C = 64: fewer warps fit
    (4, 33, 16, 200, False, False, "counts"),    # 1, 7, 17 and 130 live keys
    (3, 30, 32, 128, False, False, "none"),      # a sample with every key masked
    (2, 30, 64, 128, False, False, "holes"),     # holes in the middle of the mask
    (2, 30, 64, 128, False, False, "unmasked"),  # text_bias=None
    (2, 17, 8, 40, False, True, "holes"),        # every width, compat_reshape
    (2, 17, 16, 40, False, True, "holes"),
    (2, 17, 32, 40, True, True, "holes"),
    (2, 17, 64, 40, False, True, "holes"),
])
def test_spatial_xattn_kernel(card, dtype, b, hw, c, s, cold, compat, mask):
    xn, res, k, v, wq, bq, wp, bp, bias = _spatial_operands(
        card, dtype, b, hw * hw, c, s, cold=cold, mask=mask)
    got = spatial_xattn.fused_spatial_xattn(xn, res, k, v, wq, bq, wp, bp, num_heads=8,
                                            text_bias=bias, compat_reshape=compat)
    scale = (c // 8) ** -0.5
    kh = spatial_xattn.split_heads(k, 8, compat)
    vh = spatial_xattn.split_heads(v, 8, compat)
    ref = spatial_xattn.spatial_xattn_plain(
        xn, res, kh, vh, wq, bq, wp, bp,
        key_bias=None if bias is None else bias.reshape(b, s), scale=scale)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(),
                               **(COLD_TOL if cold else TOL)[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_xattn_repeat_calls_bit_equal(card, dtype):
    operands = _spatial_operands(card, dtype, 4, 215 * 215, 32, 128, cold=True,
                                 mask="prompt")
    first = spatial_xattn.fused_spatial_xattn(*operands[:8], num_heads=8,
                                              text_bias=operands[8])
    for _ in range(3):   # no atomics, a fixed launch shape: the same bits
        assert torch.equal(spatial_xattn.fused_spatial_xattn(
            *operands[:8], num_heads=8, text_bias=operands[8]), first)


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
    for dt in (torch.float32, torch.bfloat16):                   # strided last dim
        sq = torch.zeros(1, 2, 16, 16, device=card, dtype=dt)
        with pytest.raises(ValueError):
            flash_attention.flash_sdpa(sq.transpose(-1, -2), sq, sq)
        with pytest.raises(ValueError):
            flash_attention.flash_sdpa(sq, sq, sq.transpose(-1, -2))
    wide = torch.zeros(1, 1, 8, 336, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention.flash_sdpa(wide, wide, wide)               # bf16 D > 320
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
    qg = q.clone().requires_grad_(True)
    ops.sdpa(qg, q, q).sum().backward()   # one forward and one backward launch
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"group_norm_silu": 1, "flash_attention": 3,
                                   "spatial_xattn": 1, "flash_attention_bwd": 1}


# ---------------------------------------------------------------------------
# gradients: the kernels forward; FlashSDPA's backward kernel, the other two
# Functions' plain versions' autograd backward
# ---------------------------------------------------------------------------

def _grads(fn, inputs, gy):
    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*inputs)
    out.backward(gy)
    return [out.detach()] + [t.grad for t in inputs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", [(32, 729, 320), (32, 196, 640), (32, 16, 2560)])
def test_group_norm_silu_gradients(card, dtype, b, s, c):
    """GroupNormSiLU on the kernel against autograd of the plain version at
    the UNet's training shapes (batch 32): outputs within the kernel's
    tolerance; gradients from the same plain recomputation, so the same
    tolerance holds with room."""
    x = _randn((b, s, c), 0, card, dtype, scale=2.0, shift=0.3)
    scale, bias = _randn((c,), 1, card, scale=0.3, shift=1.0), _randn((c,), 2, card, scale=0.1)
    gy = _randn((b, s, c), 3, card, dtype)
    ops.reset_launch_counts()
    got = _grads(lambda x, s_, b_: ops.group_norm_silu({"scale": s_, "bias": b_}, x, 32),
                 (x, scale, bias), gy)
    assert ops.launch_counts()["group_norm_silu"] == 1
    ref = _grads(lambda x, s_, b_: fused_norm.group_norm_silu_plain(
        {"scale": s_, "bias": b_}, x, 32), (x, scale, bias), gy)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.isfinite(g.float()).all()
        _close(g, r, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,masked", [
    (32, 4, 196, 196, 160, False),   # UNet 14^2 self-attention
    (32, 4, 196, 128, 160, True),    # ... cross-attention on the text keys
    (32, 4, 49, 128, 320, True),     # UNet 7^2 cross-attention
    (32, 12, 50, 50, 64, False),     # CLIP ViT-B/32 vision (stage 3), no bias
])
def test_flash_attention_gradients(card, dtype, b, h, lq, lk, d, masked):
    """FlashSDPA on the kernel (output a view of [B,Lq,H,D] memory) against
    autograd of sdpa_plain, with the incoming gradient as the heads' merge
    hands it back (non-contiguous); q, k, v get gradients, the bias none."""
    q = _randn((b, h, lq, d), 0, card, dtype)
    k, v = _randn((b, h, lk, d), 1, card, dtype), _randn((b, h, lk, d), 2, card, dtype)
    bias = None
    if masked:
        keep = torch.ones(b, lk, device=card, dtype=torch.bool)
        keep[-1, lk // 3:] = False
        bias = torch.where(keep, 0.0, -1e9).float()[:, None, None, :]
    gy = _randn((b, lq, h, d), 3, card, dtype).transpose(1, 2)
    got = _grads(lambda q, k, v: ops.sdpa(q, k, v, bias=bias), (q, k, v), gy)
    ref = _grads(lambda q, k, v: flash_attention.sdpa_plain(q, k, v, bias=bias,
                                                            scale=d ** -0.5), (q, k, v), gy)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape and torch.isfinite(g.float()).all()
        _close(g, r, dtype)


def test_unet_gradient_reaches_every_parameter(card):
    """A tiny UNet on the card (fp32, TF32 off), through both kernels: every
    parameter gets a finite, non-zero gradient, within 1e-3 * max|g| + 1e-6
    of the same UNet's on the CPU (plain versions; cuDNN and CPU
    convolutions sum in other orders)."""
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.models.unet import UNetSpec, unet_apply, unet_init

    spec = UNetSpec(latent_dim=4, text_dim=16, time_emb_dim=16, channels=(16, 24, 32, 32),
                    spatial=(9, 5, 3, 2), attn_dropout=0.0)
    params = unet_init(torch.Generator().manual_seed(0), spec)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 9, 9, 4).astype(np.float32))
    t = torch.tensor([3, 700])
    text = torch.from_numpy(rng.randn(2, 6, 16).astype(np.float32))
    mask = torch.tensor([[1, 1, 1, 1, 1, 1], [1, 1, 0, 0, 0, 0]])
    w = torch.from_numpy(rng.randn(2, 9, 9, 4).astype(np.float32))

    def grads(dev):
        p = tree.map(lambda a: a.to(dev).requires_grad_(True), params)
        out = unet_apply(p, x.to(dev), t.to(dev), text.to(dev), spec, text_mask=mask.to(dev))
        g = torch.autograd.grad((out * w.to(dev)).sum(), tree.leaves(p))
        return [a.cpu() for a in g]

    ops.reset_launch_counts()
    got = grads(card)
    counts = ops.launch_counts()
    assert counts["group_norm_silu"] > 0 and counts["flash_attention"] > 0
    for (path, _), g, r in zip(tree.items(params), got, grads("cpu")):
        assert torch.isfinite(g).all() and g.abs().max() > 0, path
        torch.testing.assert_close(g, r, rtol=0, atol=1e-3 * float(r.abs().max()) + 1e-6,
                                   msg=path)


def spatial_fp32_grads(inputs, gy, *, key_bias, batch_chunk=None):
    """Output and gradients of the spatial block's fp32 body by plain
    autograd, unchunked in rows; over ``batch_chunk`` samples at a time
    (the samples are independent; Wq, bq, Wp and bp sum over them), each
    gradient cast to its input's dtype."""
    b = inputs[0].shape[0]
    step = batch_chunk or b
    outs, per_sample, shared = [], [[] for _ in range(4)], None
    for lo in range(0, b, step):
        # the shared weights as fp32 leaves: their sums over the slices stay
        # fp32 until the one cast at the end (the body upcasts them anyway)
        xs = [t[lo:lo + step] if i < 4 else t.float() for i, t in enumerate(inputs)]
        xs = [t.detach().clone().requires_grad_(True) for t in xs]
        out = spatial_xattn.spatial_xattn_fp32(
            *xs, num_heads=8, key_bias=None if key_bias is None else key_bias[lo:lo + step],
            scale=(inputs[0].shape[-1] // 8) ** -0.5)
        g = torch.autograd.grad(out, xs, gy[lo:lo + step].float())
        outs.append(out.detach())
        for i in range(4):
            per_sample[i].append(g[i])
        shared = list(g[4:]) if shared is None else [a + c for a, c in zip(shared, g[4:])]
    grads = [torch.cat(p) for p in per_sample] + shared
    return torch.cat(outs), [g.to(t.dtype) for g, t in zip(grads, inputs)]


# The training gradient cases' tolerance (atol + rtol |ref|), plus a term for the sums
# over batch x 46225 rows that give k, v, Wq, bq, Wp and bp: the Function
# sums them over chunks of rows and the reference in one pass, and their
# fp32 summation noise scales with the largest element, not with each one
# (measured on an H100: both within 5e-6 max|g| of a float64 reference, and
# bit-equal where the backward takes one chunk).
SPATIAL_GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4, max_rtol=1e-5),
                    torch.bfloat16: dict(rtol=2e-2, atol=2e-2, max_rtol=1e-4)}


def _assert_spatial_grad_close(g, r, dtype, name=""):
    tol = SPATIAL_GRAD_TOL[dtype]
    g, r = g.float(), r.float()
    bound = tol["atol"] + tol["rtol"] * r.abs() + tol["max_rtol"] * r.abs().max()
    err = (g - r).abs()
    assert bool((err <= bound).all()), \
        f"{name}: max|dg| {float(err.max()):.3g}, worst err/bound {float((err / bound).max()):.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,cold,mask", [
    (64, False, "prompt"),   # the decoder's 215^2 C64 site, prompt masks
    (64, True, "third"),     # ... cold heads
    (32, False, "prompt"),   # the 215^2 C32 site, prompt masks
    (32, True, "third"),     # ... cold heads
])
def test_spatial_xattn_gradients(card, dtype, c, cold, mask):
    """SpatialXattn on the kernel (the forward) against autograd of the fp32
    body at the decoder's 215^2 sites (batch 8): the output within the
    kernel's tolerance of the plain version; every operand's gradient
    within 0.02 + 0.02 |ref| + 1e-4 max|ref| (bf16) or 1e-4 + 1e-4 |ref| +
    1e-5 max|ref| (fp32) of the body's, finite, in its input's dtype; one
    launch, in the forward."""
    inputs = _spatial_operands(card, dtype, 8, 215 * 215, c, 128, cold=cold, mask=mask)
    operands, bias = list(inputs[:8]), inputs[8]
    # Wq and Wp in the activations' dtype, as the decoder hands them over
    operands[4], operands[6] = operands[4].to(dtype), operands[6].to(dtype)
    gy = _randn((8, 215 * 215, c), 9, card, dtype)
    ops.reset_launch_counts()
    xs = [t.detach().clone().requires_grad_(True) for t in operands]
    out = spatial_xattn.fused_spatial_xattn(*xs, num_heads=8, text_bias=bias)
    assert type(out.grad_fn).__name__ == "SpatialXattnBackward"
    got = torch.autograd.grad(out, xs, gy)
    assert ops.launch_counts()["spatial_xattn"] == 1
    plain = spatial_xattn.spatial_xattn_plain(
        operands[0], operands[1], spatial_xattn.split_heads(operands[2], 8, False),
        spatial_xattn.split_heads(operands[3], 8, False), *operands[4:],
        key_bias=bias.reshape(8, -1), scale=(c // 8) ** -0.5)
    torch.testing.assert_close(out.detach().float(), plain.float(),
                               **(COLD_TOL if cold else TOL)[dtype])
    _, ref = spatial_fp32_grads(operands, gy, key_bias=bias.reshape(8, -1))
    for name, g, r, x in zip(("xn", "residual", "k", "v", "wq", "bq", "wp", "bp"), got, ref,
                             operands):
        assert g.dtype == x.dtype and torch.isfinite(g.float()).all(), name
        _assert_spatial_grad_close(g, r, dtype, name)


def test_spatial_xattn_backward_chunks_rows(card):
    """At the 215^2 C32 site at batch 32 the backward's fp32 scores exceed
    one chunk: the Function runs in several chunks of rows and still gives
    the body's gradients."""
    b, s = 32, 128
    rows = spatial_xattn.backward_rows(b, 8, s)
    assert rows * b * 8 * s * 4 <= spatial_xattn.CHUNK_BYTES and 215 * 215 > 2 * rows
    inputs = _spatial_operands(card, torch.bfloat16, b, 215 * 215, 32, s, mask="prompt")
    operands, bias = list(inputs[:8]), inputs[8]
    operands[4], operands[6] = operands[4].bfloat16(), operands[6].bfloat16()
    gy = _randn((b, 215 * 215, 32), 9, card, torch.bfloat16)
    xs = [t.detach().clone().requires_grad_(True) for t in operands]
    torch.cuda.reset_peak_memory_stats()
    got = torch.autograd.grad(spatial_xattn.fused_spatial_xattn(
        *xs, num_heads=8, text_bias=bias), xs, gy)
    # the transients of one chunk, not the whole [B, H, L, S] body (6 GB a tensor)
    assert torch.cuda.max_memory_allocated() < 12e9
    _, ref = spatial_fp32_grads(operands, gy, key_bias=bias.reshape(b, -1), batch_chunk=4)
    for g, r in zip(got, ref):
        _assert_spatial_grad_close(g, r, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spatial_xattn_one_chunk_backward_is_the_fp32_body(card, dtype):
    """Where the backward takes one chunk (batch 4 at the 215^2 C32 site) it
    is the fp32 body's autograd, bit for bit, cold heads included."""
    assert spatial_xattn.backward_rows(4, 8, 128) >= 215 * 215
    inputs = _spatial_operands(card, dtype, 4, 215 * 215, 32, 128, cold=True, mask="prompt")
    operands, bias = list(inputs[:8]), inputs[8]
    operands[4], operands[6] = operands[4].to(dtype), operands[6].to(dtype)
    gy = _randn((4, 215 * 215, 32), 9, card, dtype)
    xs = [t.detach().clone().requires_grad_(True) for t in operands]
    got = torch.autograd.grad(spatial_xattn.fused_spatial_xattn(
        *xs, num_heads=8, text_bias=bias), xs, gy)
    _, ref = spatial_fp32_grads(operands, gy, key_bias=bias.reshape(4, -1))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_stage1_gradient_reaches_every_leaf(card, tmp_path):
    """A tiny stage-1 trainer on the card (fp32, TF32 off), through all three
    kernels: every VAE and text leaf gets a finite gradient, within 1e-3 *
    max|g| + 1e-6 of the same trainer's on the CPU (plain versions), and
    non-zero wherever the CPU's is; BERT's pooler, which the loss does not
    reach, gets zeros on both."""
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.core.config import Config
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.train.stage1_vae import VAETrainer

    csv, images = write_sprite_corpus(tmp_path / "corpus", n=6, seed=0, size=64)
    cfg = Config()
    cfg.experiment_dir = str(tmp_path / "exp")
    cfg.model.bert_model, cfg.model.vae_width_scale = "tiny-test", 0.25
    cfg.model.text_embedding_dim = 48
    cfg.data.csv_path, cfg.data.image_dir = str(csv), str(images)
    cfg.data.image_size, cfg.data.batch_size, cfg.data.text_len = 64, 2, 32
    cpu = VAETrainer(cfg, experiment_name="cpu", device="cpu")
    gpu = VAETrainer(cfg, experiment_name="card", device="cuda")
    gpu.state = gpu._fresh_state(bridge.fit(gpu.state.params, cpu.state.params), step=0,
                                 rng=gpu.state.rng)
    gpu.vgg_params = bridge.fit(gpu.vgg_params, cpu.vgg_params)
    batch = next(iter(cpu.train_loader))
    noise = torch.from_numpy(np.random.RandomState(0).randn(
        2, cpu.latent_size, cpu.latent_size, 8).astype(np.float32))
    ops.reset_launch_counts()
    _, got = gpu._grads(gpu._batch(batch), 0.005, draws={"rep_noise": noise})
    counts = ops.launch_counts()
    assert min(counts.values()) > 0, counts
    _, ref = cpu._grads(cpu._batch(batch), 0.005, draws={"rep_noise": noise})
    for (path, g), r in zip(tree.items(got), tree.leaves(ref)):
        g = g.cpu()
        assert torch.isfinite(g).all(), path
        if path.startswith("text.bert.pooler"):
            assert not g.abs().max() and not r.abs().max(), path
        elif float(r.abs().max()) > 1e-6:   # not a conv bias a GroupNorm cancels
            assert g.abs().max() > 0, path
        torch.testing.assert_close(g, r, rtol=0, atol=1e-3 * float(r.abs().max()) + 1e-6,
                                   msg=path)


# the SD-1.5 UNet's shapes (--use-diffusers stage 2): flash at head dim 40
# over the 27^2 level, GN+SiLU on the up path's uneven concatenations (30 and
# 60 channels a group; 27^2 x 960 is over a cluster's 1 MB in bf16)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,masked", [
    (8, 8, 729, 729, 40, False),    # SD 27^2 self-attention
    (8, 8, 729, 128, 40, True),     # SD 27^2 cross-attention on the text keys
    (8, 8, 196, 196, 80, False),    # SD 14^2 self-attention
    (8, 8, 16, 16, 160, False),     # SD mid block
])
def test_flash_attention_sd_shapes(card, dtype, b, h, lq, lk, d, masked):
    test_flash_attention_kernel(card, dtype, b, h, lq, lk, d, masked)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", [(8, 729, 960), (8, 196, 960), (8, 196, 1920),
                                   (8, 49, 1920), (8, 16, 2560)])
def test_group_norm_silu_sd_shapes(card, dtype, b, s, c):
    test_group_norm_silu_kernel(card, dtype, b, s, c, 32, 0.3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,c", [(32, 729, 960), (32, 196, 1920)])
def test_group_norm_silu_sd_gradients(card, dtype, b, s, c):
    test_group_norm_silu_gradients(card, dtype, b, s, c)


def test_sd_wrapper_gradient_reaches_every_trainable_leaf(card):
    """The tiny SD wrapper (with the text projection) on the card in fp32,
    through both kernels' Functions: every leaf gets a finite gradient
    within 1e-3 * max|g| + 1e-6 of the CPU's (plain versions), non-zero
    wherever the CPU's is."""
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.models.sd_unet import SDUNetSpec, sd_wrapper_apply, sd_wrapper_init

    spec = SDUNetSpec.tiny_test(text_dim=20)
    params = sd_wrapper_init(torch.Generator().manual_seed(0), spec, 12, latent_dim=8)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 27, 27, 8).astype(np.float32))
    t = torch.tensor([3, 700])
    text = torch.from_numpy(rng.randn(2, 6, 12).astype(np.float32))
    bias = torch.tensor([[0.0] * 6, [0.0] * 2 + [-1e9] * 4])[:, None, None, :]
    w = torch.from_numpy(rng.randn(2, 27, 27, 8).astype(np.float32))

    def grads(dev):
        p = tree.map(lambda a: a.to(dev).requires_grad_(True), params)
        out = sd_wrapper_apply(p, x.to(dev), t.to(dev), text.to(dev), spec,
                               text_bias=bias.to(dev))
        return [g.cpu() for g in torch.autograd.grad((out * w.to(dev)).sum(), tree.leaves(p))]

    ops.reset_launch_counts()
    got = grads(card)
    counts = ops.launch_counts()
    assert counts["group_norm_silu"] == 45 and counts["flash_attention"] == 32, counts
    # every attention call's q, k and v need a gradient (the projections train)
    assert counts["flash_attention_bwd"] == 32, counts
    for (path, _), g, r in zip(tree.items(params), got, grads("cpu")):
        assert torch.isfinite(g).all(), path
        if float(r.abs().max()) > 1e-6:
            assert g.abs().max() > 0, path
        torch.testing.assert_close(g, r, rtol=0, atol=1e-3 * float(r.abs().max()) + 1e-6,
                                   msg=path)


# ---------------------------------------------------------------------------
# flash attention's backward kernel (csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------


def _flash_operands(card, dtype, b, h, lq, lk, d, mask):
    """q, k, v, the key bias ([B,1,1,Lk] or None) and an incoming gradient
    as the heads' merge hands it back (a [B,H,Lq,D] view of [B,Lq,H,D])."""
    q = _randn((b, h, lq, d), 0, card, dtype)
    k, v = _randn((b, h, lk, d), 1, card, dtype), _randn((b, h, lk, d), 2, card, dtype)
    bias = None
    if mask != "none":
        keep = torch.ones(b, lk, device=card, dtype=torch.bool)
        keep[-1, max(1, lk // 3):] = False
        if mask == "dead sample":   # every key of sample 0, all but one of the last
            keep[0] = False
            keep[-1] = False
            keep[-1, lk // 2] = True
        bias = torch.where(keep, 0.0, -1e9).float()[:, None, None, :]
    gy = _randn((b, lq, h, d), 3, card, dtype).transpose(1, 2)
    return q, k, v, bias, gy


def _kernel_backward(q, k, v, bias, gy):
    """The forward kernel's output and logsumexp, then the backward kernel."""
    b, lk, d = q.shape[0], k.shape[2], q.shape[-1]
    key_bias = flash_attention._key_bias(bias, b, lk)
    o, lse = flash_attention._launch(q, k, v, key_bias, d ** -0.5, lse=True)
    return o, lse, flash_attention._launch_bwd(q, k, v, o, gy, lse, key_bias, d ** -0.5)


FLASH_GRAD_SHAPES = [
    (8, 8, 729, 729, 40, "none"),     # SD 27^2 self-attention
    (32, 8, 729, 729, 40, "none"),
    (8, 8, 729, 128, 40, "third"),    # SD 27^2 cross-attention on the text keys
    (32, 8, 729, 128, 40, "third"),
    (8, 8, 196, 196, 80, "none"),     # SD 14^2
    (32, 8, 196, 196, 80, "none"),
    (8, 8, 49, 49, 160, "none"),      # SD 7^2
    (32, 8, 49, 49, 160, "none"),
    (32, 4, 196, 196, 160, "none"),   # the UNet's GRAD_FLASH shapes (chip_smoke.py)
    (32, 4, 196, 128, 160, "third"),
    (32, 4, 49, 49, 320, "none"),
    (32, 4, 16, 128, 320, "third"),
    (32, 12, 128, 128, 64, "third"),  # BERT-base (fp32 under bf16 training)
    (32, 12, 50, 50, 64, "none"),     # CLIP ViT-B/32 vision
    (2, 3, 33, 17, 6, "third"),       # ragged everything (tiny configs)
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d,mask", FLASH_GRAD_SHAPES)
def test_flash_attention_backward_kernel(card, dtype, b, h, lq, lk, d, mask):
    """The backward kernel against sdpa_backward_plain on the same output
    and logsumexp, and against autograd of sdpa_plain, within the kernels'
    tolerance; the forward's logsumexp against sdpa_lse_plain's."""
    q, k, v, bias, gy = _flash_operands(card, dtype, b, h, lq, lk, d, mask)
    o, lse, got = _kernel_backward(q, k, v, bias, gy)
    ref_o, ref_lse = flash_attention.sdpa_lse_plain(q, k, v, bias=bias, scale=d ** -0.5)
    _close(o, ref_o, dtype)
    torch.testing.assert_close(lse, ref_lse, **TOL[torch.float32])
    plain = flash_attention.sdpa_backward_plain(q, k, v, o, gy, lse, bias, d ** -0.5)
    auto = _grads(lambda q, k, v: flash_attention.sdpa_plain(q, k, v, bias=bias,
                                                             scale=d ** -0.5), (q, k, v), gy)
    for g, p, a, t in zip(got, plain, auto[1:], (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape and torch.isfinite(g.float()).all()
        _close(g, p, dtype)
        _close(g, a, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,lq,lk,d", [(4, 8, 729, 128, 40), (3, 4, 40, 150, 64),
                                         (2, 3, 70, 300, 48), (2, 4, 16, 128, 320)])
def test_flash_attention_backward_masks(card, dtype, b, h, lq, lk, d):
    """A sample with every key masked (uniform softmax: its scores are all
    -1e9) and one with all keys but one masked: through FlashSDPA on the
    card (one launch each way) against autograd of sdpa_plain, with a
    strided incoming gradient; a second backward gives the same bits."""
    q, k, v, bias, gy = _flash_operands(card, dtype, b, h, lq, lk, d, "dead sample")
    assert not gy.is_contiguous()
    ops.reset_launch_counts()
    got = _grads(lambda q, k, v: ops.sdpa(q, k, v, bias=bias), (q, k, v), gy)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1, counts
    again = _grads(lambda q, k, v: ops.sdpa(q, k, v, bias=bias), (q, k, v), gy)
    ref = _grads(lambda q, k, v: flash_attention.sdpa_plain(q, k, v, bias=bias,
                                                            scale=d ** -0.5), (q, k, v), gy)
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, a)
        _close(g, r, dtype)
    # the dead sample's output is the mean of its values
    _close(got[0][0], v[0].float().mean(dim=1, keepdim=True).expand(h, lq, d), dtype)


def test_flash_attention_backward_launches_no_plain_version(card, monkeypatch):
    """FlashSDPA's backward on the card launches the backward kernel and
    calls none of the plain versions, in bf16 and fp32; an operand the
    kernel does not take raises."""
    calls = []
    for name in ("sdpa_plain", "sdpa_lse_plain", "sdpa_backward_plain", "_plain"):
        real = getattr(flash_attention, name)
        monkeypatch.setattr(flash_attention, name,
                            lambda *a, _r=real, _n=name, **kw: calls.append(_n) or _r(*a, **kw))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias, gy = _flash_operands(card, dtype, 2, 4, 49, 77, 64, "third")
        xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
        ops.reset_launch_counts()
        ops.sdpa(*xs, bias=bias).backward(gy)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention_bwd"] == 1
        assert all(x.grad is not None for x in xs)
    assert calls == []
    q, k, v, bias, gy = _flash_operands(card, torch.bfloat16, 1, 2, 8, 8, 16, "none")
    o, lse = flash_attention._launch(q, k, v, None, 0.25, lse=True)
    with pytest.raises(TypeError):                                  # dO in another dtype
        flash_attention._launch_bwd(q, k, v, o, gy.float(), lse, None, 0.25)
    with pytest.raises(ValueError):                                 # lse on the CPU
        flash_attention._launch_bwd(q, k, v, o, gy, lse.cpu(), None, 0.25)


def test_memory_and_timing_utils_on_the_card(card):
    """``StepTimer`` reads CUDA events; ``step_memory_analysis`` reads the
    peak-allocated counter (a [B, 1024] fp32 step peaks above its argument);
    ``find_max_batch_size`` finds the largest batch under a budget."""
    from psg_tpu_torch.utils.memory import find_max_batch_size, step_memory_analysis
    from psg_tpu_torch.utils.profiling import StepTimer, device_memory_stats

    timer = StepTimer()
    a = torch.randn(512, 512, device=card)
    for _ in range(3):
        with timer.measure():
            a = a @ a / 512
    s = timer.summary()
    assert timer.cuda and s["n"] == 3 and s["mean_s"] > 0

    def step(x):
        return (x * 2.0).sum()

    m = step_memory_analysis(step, torch.zeros(64, 1024, device=card))
    assert m["argument_size_bytes"] == 64 * 1024 * 4 and m["peak_bytes"] >= 64 * 1024 * 4
    stats = device_memory_stats()
    assert stats["bytes_limit"] > stats["peak_bytes_in_use"] > 0
    budget = torch.cuda.memory_allocated() + 40 * 4096 * 4 * 2
    best = find_max_batch_size(lambda b: (torch.zeros(b, 4096, device=card),), step,
                               limit=256, hbm_bytes=budget, safety=1.0)
    assert 1 <= best < 256


def test_one_rank_nccl_mesh_step_equals_the_step_without(card, tmp_path):
    """A one-rank NCCL group and a (1, 1) mesh: the tiny stage-2 trainer's
    step on the card (fp32, cuDNN deterministic) with min-SNR weights,
    cond-dropout and attention dropout, its validation and its checkpoint
    equal the same trainer's without a mesh: loss within rel 1e-5,
    gradients within 1e-4 * max|g| + 1e-7, params and EMA within 1e-6 (the
    CPU mesh tests' bounds, tests/test_torch_parallel.py); the mesh's
    gradient all-reduce went through NCCL."""
    import socket

    import torch.distributed as dist

    import torch_mesh_worker as W
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.parallel import initialize_distributed, make_mesh

    write_sprite_corpus(tmp_path / "corpus", n=12, seed=0, size=64)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda", timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        runs = {}
        for name, mesh in (("plain", None), ("mesh", make_mesh(data=1, model=1))):
            t = W.stage2_trainer(tmp_path, f"exp_{name}", mesh, device="cuda")
            runs[name] = W.stage2_step(t, W.global_batch(t.tokenizer))
            if mesh is not None:
                assert t.mesh_run.reducer.bucket_bytes_total == 4 * sum(
                    x.numel() for x in runs[name]["params"].values())
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    got, ref = runs["mesh"], runs["plain"]
    np.testing.assert_allclose([got["loss"], got["val"]], [ref["loss"], ref["val"]], rtol=1e-5)
    for path, r in ref["grads"].items():
        assert float((got["grads"][path] - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-7
    for k in ("params", "ema"):
        for path, r in ref[k].items():
            assert float((got[k][path] - r).abs().max()) <= 1e-6, (k, path)


def test_async_checkpoint_snapshot_on_the_card(card, tmp_path):
    """A state on the card (a channels-last conv kernel, a linear, bf16
    first moments, the generator) saved async and then updated in place at
    once, with no host sync between: the file equals a sync file of the
    state before the update.  The snapshot's host buffers are pinned, and
    the manager's second save reuses them (same memory) and equals a sync
    file of the updated state."""
    from psg_tpu_torch.core import checkpoint as ckpt
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.train.state import TrainState

    g = torch.Generator().manual_seed(0)
    params = {"conv": {"w": torch.randn(64, 32, 3, 3, generator=g).to(card).contiguous(
                  memory_format=torch.channels_last), "b": torch.randn(64, generator=g).to(card)},
              "dense": {"w": torch.randn(1024, 2048, generator=g).to(card)}}
    opt = {"count": 3, "mu": {p: torch.randn_like(t).bfloat16() for p, t in tree.items(params)},
           "nu": {p: torch.rand_like(t) for p, t in tree.items(params)}}
    state = TrainState(3, params, opt, torch.Generator(device=card).manual_seed(1))
    files = {}
    asyn = ckpt.CheckpointManager(tmp_path / "async", "s", 5, True)
    for round_ in (0, 1):
        ref = ckpt.CheckpointManager(tmp_path / f"sync{round_}", "s", 5, False)
        ref.save(state, state.step, 0.5 - round_ * 0.1, periodic=False)
        asyn.save(state, state.step, 0.5 - round_ * 0.1, periodic=False)
        for t in tree.leaves(params) + tree.leaves(opt["mu"]) + tree.leaves(opt["nu"]):
            t.mul_(1.5).add_(1.0)       # queued on the stream behind the copies
        opt["count"] += 1
        asyn.wait()
        assert asyn.best_path.read_bytes() == ref.best_path.read_bytes(), round_
        files[round_] = {k: b.data_ptr() for k, b in asyn._buffers.items()}
        assert all(b.is_pinned() for b in asyn._buffers.values())
    assert files[0] == files[1] and len(files[0]) == 3 + 3 + 3


def test_async_write_error_through_agree_on_nccl(card, tmp_path):
    """A one-rank NCCL group: ``train.common.agree`` (the barrier a mesh's
    checkpoint manager meets in ``wait()``) returns whether any rank came
    with ``failed``, through an all-reduce on the card; a manager on the
    group with async writes writes a state from the card, and a write that
    cannot land raises at ``wait()`` once."""
    import shutil
    import socket

    import torch.distributed as dist

    from psg_tpu_torch.core import checkpoint as ckpt
    from psg_tpu_torch.parallel import initialize_distributed
    from psg_tpu_torch.train.common import agree

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda", timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        assert agree(False) is False and agree(True) is True
        ok = ckpt.CheckpointManager(tmp_path / "ok", "s", 5, True, sync=agree)
        ok.save_best_light({"w": torch.arange(4096.0, device=card)}, 0, 1.0)
        ok.wait()
        raw = ckpt.read_checkpoint(ok.best_path)["params"]["w"]
        assert torch.equal(raw, torch.arange(4096.0).bfloat16())     # a light best is bf16
        bad = ckpt.CheckpointManager(tmp_path / "bad", "s", 5, True, sync=agree)
        shutil.rmtree(bad.dir)
        bad.dir.write_text("a file where the checkpoint directory was")
        bad.save_best_light({"w": torch.ones(4096, device=card)}, 0, 1.0)
        with pytest.raises(RuntimeError, match="async checkpoint write failed"):
            bad.wait()
        bad.wait()                          # raised once only
    finally:
        dist.destroy_process_group()
