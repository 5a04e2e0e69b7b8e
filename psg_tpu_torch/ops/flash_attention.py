"""Scaled dot-product attention: Hopper kernels forward and backward, and
their plain versions.

Port of ``psg_tpu/ops/flash_attention.py::flash_sdpa`` (the TPU kernel's
``pallas_call`` at line 92).  The forward kernel is
``csrc/flash_attention.cu``: in bf16, ``wgmma`` warpgroup products over key
tiles streamed by TMA through shared memory under an online softmax, head
dims up to 320; in fp32, CUDA cores.  Ragged edges are masked in the
kernel.  When a gradient is wanted it also writes each row's logsumexp.

Operands are strided: q, k and v may be head views ``[B, H, L, D]`` of a
projection in any layout whose last dimension is contiguous, and the output
is written in ``[B, Lq, H, D]`` memory order and returned as its
``[B, H, Lq, D]`` view, so merging the heads back is a view too.

Bias contract (as on the TPU): ``None`` or a per-key additive bias of shape
``[B, 1, 1, Lk]``; any other shape raises (``ops.sdpa`` sends such a bias to
``sdpa_plain`` instead).

Gradients: the TPU kernel has no VJP (the JAX package differentiates its XLA
reference).  Here ``FlashSDPA`` (a ``torch.autograd.Function``) saves q, k,
v, the output and its logsumexp, and its backward launches
``csrc/flash_attention_bwd.cu`` (FlashAttention-2: Delta = rowsum(dO * O),
P rebuilt from the logsumexp, two deterministic passes for dQ and for
dK/dV) in bf16 and fp32; the bias (a text mask) takes no gradient.  On the
CPU it takes ``sdpa_backward_plain``, the same algorithm in tensor code.

The logsumexp is taken relative to each sample's largest key bias
(``bias_max``; 0 without a bias): ``lse = logsumexp(s) - c``.  Where every
key of a sample is masked at -1e9 the scores are all about -1e9, and a
plain logsumexp would round the log of the row sum away; relative to ``c``
it stays exact, and ``P = exp((s - c) - lse)`` is the softmax.
"""

from __future__ import annotations

import ctypes

import torch

from psg_tpu_torch.ops import cuda_build as cb
from psg_tpu_torch.utils.graphs import eager_between

KERNEL = cb.KernelLibrary(
    "flash_attention", "flash_attention.cu",
    {"psg_flash_attention": (ctypes.c_int, [ctypes.c_void_p] * 7
                             + [ctypes.c_int] * 5
                             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
     "psg_flash_attention_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 6)})

BWD_KERNEL = cb.KernelLibrary(
    "flash_attention_bwd", "flash_attention_bwd.cu",
    {"psg_flash_attention_bwd": (ctypes.c_int, [ctypes.c_void_p] * 12
                                 + [ctypes.c_int] * 5
                                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
     "psg_flash_attention_bwd_smem_bytes": (ctypes.c_size_t, [ctypes.c_int] * 3)})


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
    return _plain(q, k, v, bias, scale)[0]


def bias_max(bias):
    """Each sample's largest key bias, [B, 1, 1, 1] fp32, of a [B, 1, 1, Lk]
    bias (0 for None): what the logsumexp is taken relative to."""
    if bias is None:
        return 0.0
    return bias.float().amax(dim=-1, keepdim=True)


def _scores(q, k, bias, scale):
    """s = q k^T * scale, then + bias, in fp32 (the kernels round each)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    return s if bias is None else s + bias.float()


def _plain(q, k, v, bias, scale):
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = _scores(q, k, bias, scale)
    m = scores.amax(dim=-1, keepdim=True)
    probs = (scores - m).exp()
    total = probs.sum(dim=-1, keepdim=True)
    probs = probs / total
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype), m, total


def sdpa_lse_plain(q, k, v, *, bias=None, scale=None):
    """``(sdpa_plain(...), lse)`` with lse [B, H, Lq] fp32 each row's
    logsumexp of the scores less its sample's ``bias_max``: the forward
    kernel's two outputs."""
    out, m, total = _plain(q, k, v, bias, scale)
    lse = (m - bias_max(bias)) + total.log()
    return out, lse.squeeze(-1)


def sdpa_backward_plain(q, k, v, o, do, lse, bias, scale):
    """(dq, dk, dv) in q's dtype by the backward kernel's algorithm in fp32
    tensor code: Delta = rowsum(dO * O) from the stored output, P = exp((s
    - c) - lse) from scores recomputed as the forward computes them, P
    rounded to v's dtype for dV = P^T dO (as the forward rounds it for
    P V), dS = P * (dO V^T - Delta), dQ = dS K * scale, dK = dS^T Q *
    scale."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = ((_scores(q, k, bias, scale) - bias_max(bias)) - lse.float()[..., None]).exp()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_operand(name: str, t: torch.Tensor) -> None:
    cb.check_cuda_tensor(f"flash_sdpa {name}", t, cb.DTYPE_CODES, contiguous=False)
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"flash_sdpa {name}: the last dimension must be contiguous, "
                         f"got strides {t.stride()}")


def _launch(q, k, v, key_bias, scale: float, *, lse: bool = False):
    """The forward kernel: o ([B, H, Lq, D] view of [B, Lq, H, D] memory),
    and with ``lse`` also the [B, H, Lq] fp32 logsumexp."""
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
    out_lse = (torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
               if lse else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *o.stride()[:3])
    rc = lib.psg_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None, o.data_ptr(),
        out_lse.data_ptr() if lse else None,
        strides, b, h, lq, lk, d, float(scale), code, cb.stream_ptr())
    KERNEL.check(rc)
    return (o, out_lse) if lse else o


def _launch_bwd(q, k, v, o, do, lse, key_bias, scale: float):
    """The backward kernels (one counted launch): dq, dk, dv contiguous in
    q's dtype."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if do.stride(-1) != 1:
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("grad", do)):
        _check_operand(name, t)
        if t.dtype != q.dtype:
            raise TypeError(f"flash_sdpa backward: {name} is {t.dtype}, q {q.dtype}")
    cb.check_cuda_tensor("flash_sdpa lse", lse, (torch.float32,))
    lib = BWD_KERNEL.lib()
    code = cb.DTYPE_CODES[q.dtype]
    smem = lib.psg_flash_attention_bwd_smem_bytes(lk, d, code)
    if smem == 0 or smem > cb.SMEM_LIMIT:
        raise ValueError(f"flash_sdpa backward: head dim {d} does not fit the "
                         f"{q.dtype} kernel (D <= 320)")
    if key_bias is not None:
        cb.check_cuda_tensor("flash_sdpa bias", key_bias)
    dq, dk, dv = (torch.empty(t.shape, dtype=q.dtype, device=q.device) for t in (q, k, v))
    delta = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    ts = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(s for t in ts for s in t.stride()[:3]))
    rc = lib.psg_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.contiguous().data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), strides,
        b, h, lq, lk, d, float(scale), code, cb.stream_ptr())
    BWD_KERNEL.check(rc)
    return dq, dk, dv


def _forward_lse(q, k, v, bias, scale):
    """Output and logsumexp: the kernel on the card, the plain version on
    the CPU."""
    if q.device.type == "cpu":
        return sdpa_lse_plain(q, k, v, bias=bias, scale=scale)
    return _launch(q, k, v, _key_bias(bias, q.shape[0], k.shape[2]), scale, lse=True)


class FlashSDPA(torch.autograd.Function):
    """``forward_impl(q, k, v, bias, scale)`` gives the output and its
    logsumexp (the forward kernel on the card); the backward launches the
    backward kernel on the card and takes ``sdpa_backward_plain`` on the
    CPU, for q, k and v.  The backward is marked
    ``utils.graphs.eager_between``: a training graph captured in pieces
    (``models.unet``) makes it from the host at each replay."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, forward_impl):
        out, lse = forward_impl(q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, out, lse, bias)
        ctx.scale = scale
        return out

    @staticmethod
    @eager_between
    def backward(ctx, grad_out):
        q, k, v, out, lse, bias = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = sdpa_backward_plain(q, k, v, out, grad_out, lse, bias, ctx.scale)
        else:
            grads = _launch_bwd(q, k, v, out, grad_out, lse,
                                _key_bias(bias, q.shape[0], k.shape[2]), ctx.scale)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)


def flash_sdpa_autograd(q, k, v, *, bias=None, scale=None, forward_impl=_forward_lse):
    """``FlashSDPA`` (``forward_impl`` defaults to the kernel on the card and
    ``sdpa_lse_plain`` on the CPU)."""
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
