"""Short-KV scaled dot-product attention: Hopper kernel and plain version.

Port of ``psg_tpu/ops/flash_attention.py::flash_sdpa`` (the TPU kernel's
``pallas_call`` at line 92).  The kernel is ``csrc/flash_attention.cu``:
key tiles streamed through shared memory with an online softmax, any head
dim whose tiles fit a block's shared memory (the model uses 4..320), ragged
edges masked in the kernel.

Bias contract (as on the TPU): ``None`` or a per-key additive bias of shape
``[B, 1, 1, Lk]``; any other shape raises.
"""

from __future__ import annotations

import ctypes

import torch

from psg_tpu_torch.ops import cuda_build as cb

KERNEL = cb.KernelLibrary(
    "flash_attention", "flash_attention.cu",
    {"psg_flash_attention": (ctypes.c_int, [ctypes.c_void_p] * 5
                             + [ctypes.c_int] * 5
                             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
     "psg_flash_attention_smem_bytes": (ctypes.c_size_t, [ctypes.c_int])})

SMEM_LIMIT = 232448  # bytes a Hopper block may use


def _key_bias(bias, b: int, lk: int):
    """[B,1,1,Lk] additive bias -> [B, Lk] fp32; other shapes raise."""
    if bias is None:
        return None
    if bias.ndim != 4 or tuple(bias.shape) != (b, 1, 1, lk):
        raise NotImplementedError(
            f"flash_sdpa: bias must be None or [B,1,1,Lk]=({b},1,1,{lk}), "
            f"got {tuple(bias.shape)}")
    return bias.reshape(b, lk).float().contiguous()


def sdpa_plain(q, k, v, *, bias=None, scale=None):
    """softmax(q k^T * scale + bias) v with fp32 scores, softmax and
    accumulation; probabilities rounded to v's dtype before the product and
    the output in q's dtype, as ``psg_tpu/ops/xla_ref.py::sdpa_xla``."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    scores = scores - scores.amax(dim=-1, keepdim=True)
    probs = scores.exp()
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _launch(q, k, v, key_bias, scale: float):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        cb.check_cuda_tensor(f"flash_sdpa {name}", t, cb.DTYPE_CODES)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_sdpa: q, k and v must share one dtype")
    if tuple(k.shape) != (b, h, lk, d) or tuple(v.shape) != (b, h, lk, d):
        raise ValueError(f"flash_sdpa: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    lib = KERNEL.lib()
    smem = lib.psg_flash_attention_smem_bytes(d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"flash_sdpa: head dim {d} needs {smem} bytes of "
                         f"shared memory (> {SMEM_LIMIT})")
    if key_bias is not None:
        cb.check_cuda_tensor("flash_sdpa bias", key_bias)
    o = torch.empty_like(q)
    rc = lib.psg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None, o.data_ptr(),
        b, h, lq, lk, d, float(scale), cb.DTYPE_CODES[q.dtype], cb.stream_ptr())
    KERNEL.check(rc)
    return o


def flash_sdpa(q, k, v, *, bias=None, scale=None):
    """q: [B,H,Lq,D], k/v: [B,H,Lk,D] -> [B,H,Lq,D].

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
    raises."""
    b, _, _, d = q.shape
    key_bias = _key_bias(bias, b, k.shape[2])
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v, bias=bias, scale=scale)
    return _launch(q, k, v, key_bias, scale)
