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
"""

from __future__ import annotations

import ctypes

import torch

from psg_tpu_torch.ops import cuda_build as cb

KERNEL = cb.KernelLibrary(
    "spatial_xattn", "spatial_xattn.cu",
    {"psg_spatial_xattn": (ctypes.c_int, [ctypes.c_void_p] * 10
                           + [ctypes.c_int] * 4
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


def spatial_xattn_plain(xn, residual, kh, vh, wq, bq, wp, bp, *, key_bias=None,
                        scale: float):
    """The kernel's function in plain PyTorch, on the kernel's operands:
    xn/residual [B, L, C]; kh/vh [B, H, S, hd]; key_bias [B, S] or None;
    wq/wp [C, C] ([in, out]).  fp32 throughout, output in xn's dtype."""
    b, l, c = xn.shape
    h = kh.shape[1]
    q = torch.matmul(xn.float(), wq.float()) + bq.float()
    qh = (q * scale).reshape(b, l, h, c // h).transpose(1, 2)      # [B,H,L,hd]
    s = torch.matmul(qh, kh.float().transpose(-1, -2))             # [B,H,L,S]
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    # the max is per head: a global row max underflows a cold head's exp()
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vh.float()).transpose(1, 2).reshape(b, l, c)
    out = torch.matmul(o, wp.float()) + bp.float() + residual.float()
    return out.to(xn.dtype)


def _launch(xn, residual, kh, vh, wq, bq, wp, bp, key_bias, scale: float):
    b, l, c = xn.shape
    s = kh.shape[2]
    if c not in CHANNELS or kh.shape[1] != HEADS or s > MAX_KEYS:
        raise ValueError(
            f"fused_spatial_xattn: kernel takes C in {CHANNELS}, {HEADS} heads "
            f"and S <= {MAX_KEYS}; got C={c}, heads={kh.shape[1]}, S={s}")
    cb.check_cuda_tensor("fused_spatial_xattn xn", xn, cb.DTYPE_CODES)
    cb.check_cuda_tensor("fused_spatial_xattn residual", residual, (xn.dtype,))
    if tuple(residual.shape) != (b, l, c):
        raise ValueError("fused_spatial_xattn: residual shape must equal xn's")
    f32 = (torch.float32,)
    for name, t in (("k", kh), ("v", vh), ("wq", wq), ("bq", bq), ("wp", wp),
                    ("bp", bp)):
        cb.check_cuda_tensor(f"fused_spatial_xattn {name}", t, f32)
    if key_bias is not None:
        cb.check_cuda_tensor("fused_spatial_xattn key_bias", key_bias, f32)
    out = torch.empty_like(xn)
    rc = KERNEL.lib().psg_spatial_xattn(
        xn.data_ptr(), residual.data_ptr(), kh.data_ptr(), vh.data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None,
        wq.data_ptr(), bq.data_ptr(), wp.data_ptr(), bp.data_ptr(),
        out.data_ptr(), b, l, s, c, float(scale), cb.DTYPE_CODES[xn.dtype],
        cb.stream_ptr())
    KERNEL.check(rc)
    return out


def fused_spatial_xattn(xn, residual, k, v, wq, bq, wp, bp, *, num_heads: int,
                        text_bias=None, scale=None, compat_reshape: bool = False):
    """GN-free body of the VAE spatial cross-attention block.

    xn/residual: [B, L, C] (x already GroupNorm'd, flattened spatial);
    k, v: [B, S, C] text projections; wq/wp: [C, C] 1x1-conv kernels as
    [in, out]; text_bias: [B, 1, 1, S] additive mask or None.
    Returns [B, L, C] = proj(attn) + residual in xn's dtype.

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
    raises."""
    b, _, c = xn.shape
    s = k.shape[1]
    if scale is None:
        scale = 1.0 / ((c // num_heads) ** 0.5)
    kh = split_heads(k.float(), num_heads, compat_reshape).contiguous()
    vh = split_heads(v.float(), num_heads, compat_reshape).contiguous()
    key_bias = None
    if text_bias is not None:
        key_bias = text_bias.reshape(b, s).float().contiguous()
    operands = (xn, residual, kh, vh, wq.float().contiguous(),
                bq.float().contiguous(), wp.float().contiguous(),
                bp.float().contiguous())
    if xn.device.type == "cpu":
        return spatial_xattn_plain(*operands, key_bias=key_bias, scale=scale)
    return _launch(*operands, key_bias, scale)
