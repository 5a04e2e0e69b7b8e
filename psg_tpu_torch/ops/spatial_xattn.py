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

Gradients: the TPU kernel's ``custom_vjp`` (``_fused_bwd``) differentiates
its fp32 reference body, recomputed.  ``SpatialXattn`` (a
``torch.autograd.Function``) does the same: the kernel runs forward, and the
backward recomputes the block from the saved operands with every operand
upcast to fp32 and nothing rounded between (the plain version on fp32
operands is that body), then takes its autograd gradient.  It is not the
gradient of the bf16 plain version, whose roundings would round the
gradient too.  Query rows are independent, so the backward runs in chunks
of rows whose fp32 ``[B, H, rows, S]`` scores stay within ``CHUNK_BYTES``:
the full-width decoder's 215^2 sites at batch 32 would otherwise hold
several 6 GB score, exponential and probability tensors at once.  Nothing
of size ``[B, H, L, S]`` is saved between forward and backward; the key
bias (a text mask) takes no gradient.
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
    ``xn``; output in xn's dtype.  On fp32 operands it rounds nowhere: it is
    then the TPU package's reference body ``_ref_impl``."""
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


CHUNK_BYTES = 1 << 30   # the backward's fp32 [B, H, rows, S] scores per chunk


def backward_rows(b: int, heads: int, s: int) -> int:
    """Query rows per chunk of the recomputed backward."""
    return max(1, CHUNK_BYTES // (b * heads * max(s, 1) * 4))


def _plain_forward(xn, residual, k, v, wq, bq, wp, bp, key_bias, scale: float,
                   num_heads: int, compat_reshape: bool):
    return spatial_xattn_plain(
        xn, residual, split_heads(k, num_heads, compat_reshape),
        split_heads(v, num_heads, compat_reshape), wq, bq, wp, bp,
        key_bias=key_bias, scale=scale)


def spatial_xattn_fp32(xn, residual, k, v, wq, bq, wp, bp, *, num_heads: int,
                       key_bias=None, scale: float, compat_reshape: bool = False):
    """The block's fp32 body (``psg_tpu/ops/spatial_xattn.py::_ref_impl``):
    every operand upcast to fp32, nothing rounded, fp32 output.  k/v are the
    [B, S, C] projections.  Its autograd gradient is the kernel's."""
    return _plain_forward(xn.float(), residual.float(), k.float(), v.float(), wq.float(),
                          bq.float(), wp.float(), bp.float(), key_bias, scale, num_heads,
                          compat_reshape)


class SpatialXattn(torch.autograd.Function):
    """``forward_impl(xn, residual, k, v, wq, bq, wp, bp, key_bias, scale,
    num_heads, compat_reshape)`` computes the output (the kernel's launch on
    the card); the backward differentiates the fp32 body, recomputed from
    the saved operands in chunks of query rows, and casts each gradient to
    its input's dtype."""

    @staticmethod
    def forward(ctx, xn, residual, k, v, wq, bq, wp, bp, key_bias, scale, num_heads,
                compat_reshape, forward_impl):
        ctx.save_for_backward(xn, k, v, wq, bq, wp, bp, key_bias)
        ctx.args = (scale, num_heads, compat_reshape, residual.dtype)
        return forward_impl(xn, residual, k, v, wq, bq, wp, bp, key_bias, scale,
                            num_heads, compat_reshape)

    @staticmethod
    def backward(ctx, grad_out):
        xn, k, v, wq, bq, wp, bp, key_bias = ctx.saved_tensors
        scale, num_heads, compat_reshape, res_dtype = ctx.args
        b, l, c = xn.shape
        rows = backward_rows(b, num_heads, k.shape[1])
        shared = [t.detach().float().requires_grad_(True) for t in (k, v, wq, bq, wp, bp)]
        sums = [torch.zeros_like(t) for t in shared]
        dxn = torch.empty_like(xn) if ctx.needs_input_grad[0] else None
        zero = torch.zeros((), device=xn.device)
        for lo in range(0, l, rows):
            with torch.enable_grad():
                xc = xn[:, lo:lo + rows].detach().float().requires_grad_(True)
                out = spatial_xattn_fp32(xc, zero, *shared, num_heads=num_heads,
                                         key_bias=key_bias, scale=scale,
                                         compat_reshape=compat_reshape)
                grads = torch.autograd.grad(out, [xc, *shared],
                                            grad_out[:, lo:lo + rows].float())
            if dxn is not None:
                dxn[:, lo:lo + rows] = grads[0]
            torch._foreach_add_(sums, list(grads[1:]))
        dk, dv, dwq, dbq, dwp, dbp = (g.to(t.dtype) for g, t in
                                      zip(sums, (k, v, wq, bq, wp, bp)))
        dres = grad_out.to(res_dtype) if ctx.needs_input_grad[1] else None
        return dxn, dres, dk, dv, dwq, dbq, dwp, dbp, None, None, None, None, None


def spatial_xattn_autograd(xn, residual, k, v, wq, bq, wp, bp, *, num_heads: int,
                           key_bias=None, scale: float, compat_reshape: bool = False,
                           forward_impl=_launch):
    """``SpatialXattn`` on the kernel's operands (k/v [B, S, C] fp32,
    key_bias [B, S] or None; ``forward_impl`` defaults to the kernel, the CPU
    path passes the plain version)."""
    return SpatialXattn.apply(xn, residual, k, v, wq, bq, wp, bp, key_bias, scale,
                              num_heads, compat_reshape, forward_impl)


def fused_spatial_xattn(xn, residual, k, v, wq, bq, wp, bp, *, num_heads: int,
                        text_bias=None, scale=None, compat_reshape: bool = False):
    """GN-free body of the VAE spatial cross-attention block.

    xn/residual: [B, L, C] (x already GroupNorm'd, flattened spatial);
    k, v: [B, S, C] text projections; wq/wp: [C, C] 1x1-conv kernels as
    [in, out], taken in xn's dtype as the reference casts them; text_bias:
    [B, 1, 1, S] additive mask or None.  Returns [B, L, C] = proj(attn) +
    residual in xn's dtype.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
    raises.  Where a gradient is asked for, both go through
    ``SpatialXattn``."""
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
    impl = _plain_forward if xn.device.type == "cpu" else _launch
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xn, residual, k, v, wq, bq, wp, bp)):
        return spatial_xattn_autograd(xn, residual, k, v, wq, bq, wp, bp,
                                      num_heads=num_heads, key_bias=key_bias, scale=scale,
                                      compat_reshape=compat_reshape, forward_impl=impl)
    return impl(xn, residual, k, v, wq, bq, wp, bp, key_bias, scale, num_heads,
                compat_reshape)
