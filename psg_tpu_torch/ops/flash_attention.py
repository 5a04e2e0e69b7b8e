"""Short-KV scaled dot-product attention: Hopper kernel and plain version.

Port of ``psg_tpu/ops/flash_attention.py::flash_sdpa`` (the TPU kernel's
``pallas_call`` at line 92).  The kernel is ``csrc/flash_attention.cu``: in
bf16, ``mma.sync`` tensor-core products over key tiles streamed through
shared memory with an online softmax, head dims up to 320; in fp32 (parity
runs), CUDA cores.  Ragged edges are masked in the kernel.

Operands are strided: q, k and v may be head views ``[B, H, L, D]`` of a
projection in any layout whose last dimension is contiguous, and the output
is written in ``[B, Lq, H, D]`` memory order and returned as its
``[B, H, Lq, D]`` view, so merging the heads back is a view too.

Bias contract (as on the TPU): ``None`` or a per-key additive bias of shape
``[B, 1, 1, Lk]``; any other shape raises (``ops.sdpa`` sends such a bias to
``sdpa_plain`` instead).

Gradients: the TPU kernel has no VJP, and neither has this kernel.  Where a
gradient is asked for, ``FlashSDPA`` (a ``torch.autograd.Function``)
launches the kernel forward and, in the backward, recomputes the plain
version from the saved q, k and v and takes its autograd gradient; the bias
(a text mask) takes none.  The gradient that arrives for the output may be
non-contiguous (the output is a view), which the recomputation takes as it
is.
"""

from __future__ import annotations

import ctypes

import torch

from psg_tpu_torch.ops import cuda_build as cb

KERNEL = cb.KernelLibrary(
    "flash_attention", "flash_attention.cu",
    {"psg_flash_attention": (ctypes.c_int, [ctypes.c_void_p] * 6
                             + [ctypes.c_int] * 5
                             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
     "psg_flash_attention_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 6)})

_Strides = ctypes.c_longlong * 12


def is_key_bias(bias, b: int, lk: int) -> bool:
    """Whether the kernel takes ``bias``: None or a [B, 1, 1, Lk] key bias."""
    return bias is None or (bias.ndim == 4 and tuple(bias.shape) == (b, 1, 1, lk))


def _key_bias(bias, b: int, lk: int):
    """[B,1,1,Lk] additive bias -> [B, Lk] fp32; other shapes raise."""
    if bias is None:
        return None
    if not is_key_bias(bias, b, lk):
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


def _check_operand(name: str, t: torch.Tensor) -> None:
    cb.check_cuda_tensor(f"flash_sdpa {name}", t, cb.DTYPE_CODES, contiguous=False)
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"flash_sdpa {name}: the last dimension must be contiguous, "
                         f"got strides {t.stride()}")


def _launch(q, k, v, key_bias, scale: float):
    b, h, lq, d = q.shape
    lk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_sdpa: q, k and v must share one dtype")
    if tuple(k.shape) != (b, h, lk, d) or tuple(v.shape) != (b, h, lk, d):
        raise ValueError(f"flash_sdpa: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    lib = KERNEL.lib()
    code = cb.DTYPE_CODES[q.dtype]
    smem = lib.psg_flash_attention_smem_bytes(b, h, lq, lk, d, code)
    if smem == 0 or smem > cb.SMEM_LIMIT:
        raise ValueError(f"flash_sdpa: head dim {d} does not fit the {q.dtype} "
                         f"kernel ({smem} bytes of shared memory; bf16 takes "
                         f"D <= 320)")
    if key_bias is not None:
        cb.check_cuda_tensor("flash_sdpa bias", key_bias)
    # [B, Lq, H, D] memory, returned as the [B, H, Lq, D] view
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = _Strides(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       *o.stride()[:3])
    rc = lib.psg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None, o.data_ptr(),
        strides, b, h, lq, lk, d, float(scale), code, cb.stream_ptr())
    KERNEL.check(rc)
    return o


class FlashSDPA(torch.autograd.Function):
    """``forward_impl(q, k, v, bias, scale)`` computes the output (the
    kernel's launch on the card); the backward differentiates ``sdpa_plain``,
    recomputed from the saved inputs, for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, forward_impl):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return forward_impl(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((q, k, v), ctx.needs_input_grad)]
            out = sdpa_plain(*inputs, bias=bias, scale=ctx.scale)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None)


def _kernel_forward(q, k, v, bias, scale):
    return _launch(q, k, v, _key_bias(bias, q.shape[0], k.shape[2]), scale)


def flash_sdpa_autograd(q, k, v, *, bias=None, scale=None, forward_impl=_kernel_forward):
    """``FlashSDPA`` (``forward_impl`` defaults to the kernel; the CPU tests
    pass the plain version)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return FlashSDPA.apply(q, k, v, bias, scale, forward_impl)


def flash_sdpa(q, k, v, *, bias=None, scale=None):
    """q: [B,H,Lq,D], k/v: [B,H,Lk,D] -> [B,H,Lq,D] (a view of [B,Lq,H,D]
    memory on the card).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
    raises, through ``FlashSDPA`` when a gradient is asked for."""
    b, _, _, d = q.shape
    key_bias = _key_bias(bias, b, k.shape[2])
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v, bias=bias, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_sdpa_autograd(q, k, v, bias=bias, scale=scale)
    return _launch(q, k, v, key_bias, scale)
