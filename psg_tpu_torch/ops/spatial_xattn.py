"""The VAE decoder's fused pixel-query/text-key attention block: Hopper
kernel and plain version.

Port of ``psg_tpu/ops/spatial_xattn.py::fused_spatial_xattn`` (the TPU
kernel's ``pallas_call`` at line 117).  Everything after the GroupNorm in
one pass: ``q = xn Wq + bq``, per-head scores against the text keys plus the
key bias, a per-head-max fp32 softmax, ``o = p V``, ``out = o Wp + bp +
residual``.  The kernel is ``csrc/spatial_xattn.cu``; it holds Wq, Wp and
all heads' K/V in shared memory, which is why it takes C <= 64, 8 heads and
S <= 256.  It is built for the widths in ``CHANNELS`` only: the decoder's
C <= 64 sites at width scales 1, 1/2 and 1/4 (the 108^2 and 215^2 sites at
full width).

In bf16 the block rounds where the TPU kernel rounds
(``psg_tpu/ops/spatial_xattn.py:73-90``): Wq and Wp are bf16, and ``q *
scale``, the probabilities and the attention output are rounded to bf16
before their products; K, V, the biases, the scores and the softmax stay
fp32.  A key whose bias is <= -1e8 (the text mask's -1e9) has a probability
of exactly 0.0 in fp32 whenever its sample has a live key, so the kernel
skips it.

No gradient runs through the kernel: the decoder that calls it is frozen in
stage 2, and the CUDA path raises on an input that requires one (the stage-1
port brings its ``torch.autograd.Function``, whose backward differentiates
the plain version as ``psg_tpu/ops/spatial_xattn.py::_fused_bwd`` does).
"""

from __future__ import annotations

import ctypes

import torch

from psg_tpu_torch.ops import cuda_build as cb

KERNEL = cb.KernelLibrary(
    "spatial_xattn", "spatial_xattn.cu",
    {"psg_spatial_xattn": (ctypes.c_int, [ctypes.c_void_p] * 10
                           + [ctypes.c_longlong] * 4
                           + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])})

CHANNELS = (8, 16, 32, 64)
HEADS = 8
MAX_KEYS = 256


def split_heads(t, num_heads: int, compat_reshape: bool):
    """[B, S, C] text projection -> [B, heads, S, C/heads].

    ``compat_reshape`` reproduces the reference's raw [B,S,C] -> [B,H,hd,S]
    reshape (a fixed permutation of keys and channels that checkpoints
    trained with the reference learned through)."""
    b, s, c = t.shape
    hd = c // num_heads
    if compat_reshape:
        return t.reshape(b, num_heads, hd, s).transpose(2, 3)
    return t.reshape(b, s, num_heads, hd).transpose(1, 2)


def _rounding(dtype):
    """Rounds a fp32 tensor where the TPU kernel rounds to its compute dtype:
    to bf16 for bf16 activations, nowhere for fp32."""
    if dtype == torch.bfloat16:
        return lambda t: t.to(torch.bfloat16).float()
    return lambda t: t


def spatial_probs_plain(xn, kh, wq, bq, *, key_bias=None, scale: float):
    """The block's attention probabilities [B, H, L, S] in plain PyTorch:
    fp32 scores of ``q * scale`` against K plus the key bias, softmax with the
    max subtracted per head.  bf16 ``xn`` rounds Wq and ``q * scale``."""
    b, l, c = xn.shape
    h = kh.shape[1]
    rnd = _rounding(xn.dtype)
    q = torch.matmul(xn.float(), rnd(wq.float())) + bq.float()
    qh = rnd(q * scale).reshape(b, l, h, c // h).transpose(1, 2)   # [B,H,L,hd]
    s = torch.matmul(qh, kh.float().transpose(-1, -2))             # [B,H,L,S]
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    # the max is per head: a global row max underflows a cold head's exp()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def spatial_xattn_plain(xn, residual, kh, vh, wq, bq, wp, bp, *, key_bias=None,
                        scale: float):
    """The kernel's function in plain PyTorch, on the kernel's operands:
    xn/residual [B, L, C]; kh/vh [B, H, S, hd]; key_bias [B, S] or None;
    wq/wp [C, C] ([in, out]).  fp32, with bf16's rounding points for bf16
    ``xn``; output in xn's dtype."""
    b, l, c = xn.shape
    rnd = _rounding(xn.dtype)
    p = rnd(spatial_probs_plain(xn, kh, wq, bq, key_bias=key_bias, scale=scale))
    o = torch.matmul(p, vh.float()).transpose(1, 2).reshape(b, l, c)
    out = torch.matmul(rnd(o), rnd(wp.float())) + bp.float() + residual.float()
    return out.to(xn.dtype)


def _aligned16(t):
    """``t``, or a copy of it whose data starts on a 16-byte boundary (the
    bf16 kernel moves activation rows in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(xn, residual, k, v, wq, bq, wp, bp, key_bias, scale: float,
            num_heads: int, compat_reshape: bool):
    b, l, c = xn.shape
    s = k.shape[1]
    if c not in CHANNELS or num_heads != HEADS or s > MAX_KEYS:
        raise ValueError(
            f"fused_spatial_xattn: kernel takes C in {CHANNELS}, {HEADS} heads "
            f"and S <= {MAX_KEYS}; got C={c}, heads={num_heads}, S={s}")
    cb.check_cuda_tensor("fused_spatial_xattn xn", xn, cb.DTYPE_CODES)
    cb.check_cuda_tensor("fused_spatial_xattn residual", residual, (xn.dtype,))
    if tuple(residual.shape) != (b, l, c):
        raise ValueError("fused_spatial_xattn: residual shape must equal xn's")
    f32 = (torch.float32,)
    for name, t, shape in (("k", k, (b, s, c)), ("v", v, (b, s, c)), ("bq", bq, (c,)),
                           ("bp", bp, (c,))):
        cb.check_cuda_tensor(f"fused_spatial_xattn {name}", t, f32)
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_spatial_xattn: {name} must be {shape}")
    for name, t in (("wq", wq), ("wp", wp)):   # any strides: a transposed view is read in place
        cb.check_cuda_tensor(f"fused_spatial_xattn {name}", t, (xn.dtype,),
                             contiguous=False)
        if tuple(t.shape) != (c, c):
            raise ValueError(f"fused_spatial_xattn: {name} must be [{c}, {c}]")
    if key_bias is not None:
        cb.check_cuda_tensor("fused_spatial_xattn key_bias", key_bias, f32)
    xn, residual = _aligned16(xn), _aligned16(residual)
    out = torch.empty_like(xn)
    rc = KERNEL.lib().psg_spatial_xattn(
        xn.data_ptr(), residual.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None,
        wq.data_ptr(), bq.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
        *wq.stride(), *wp.stride(), b, l, s, c, int(compat_reshape), float(scale),
        cb.DTYPE_CODES[xn.dtype], cb.stream_ptr())
    KERNEL.check(rc)
    return out


def fused_spatial_xattn(xn, residual, k, v, wq, bq, wp, bp, *, num_heads: int,
                        text_bias=None, scale=None, compat_reshape: bool = False):
    """GN-free body of the VAE spatial cross-attention block.

    xn/residual: [B, L, C] (x already GroupNorm'd, flattened spatial);
    k, v: [B, S, C] text projections; wq/wp: [C, C] 1x1-conv kernels as
    [in, out], taken in xn's dtype as the reference casts them; text_bias:
    [B, 1, 1, S] additive mask or None.  Returns [B, L, C] = proj(attn) +
    residual in xn's dtype.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
    raises."""
    b, _, c = xn.shape
    s = k.shape[1]
    if scale is None:
        scale = 1.0 / ((c // num_heads) ** 0.5)
    key_bias = None
    if text_bias is not None:
        key_bias = text_bias.reshape(b, s).float().contiguous()
    wq, wp = wq.to(xn.dtype), wp.to(xn.dtype)
    bq, bp = bq.float().contiguous(), bp.float().contiguous()
    k, v = k.float().contiguous(), v.float().contiguous()
    if xn.device.type == "cpu":
        return spatial_xattn_plain(
            xn, residual, split_heads(k, num_heads, compat_reshape),
            split_heads(v, num_heads, compat_reshape), wq, bq, wp, bp,
            key_bias=key_bias, scale=scale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xn, residual, k, v, wq, bq, wp, bp)):
        raise NotImplementedError(
            "fused_spatial_xattn: the kernel has no gradient yet; run the frozen "
            "decoder under torch.no_grad() (its autograd Function comes with stage 1)")
    return _launch(xn, residual, k, v, wq, bq, wp, bp, key_bias, scale, num_heads,
                   compat_reshape)
