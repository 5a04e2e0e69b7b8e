"""Spans around the port's kernel families, and their roofline shares.

Each family has a counter module in ``benchmark/counters`` whose
``forward``/``backward`` give a call's operations and bytes from the shapes
kept here; a share is the least time of all its calls on the chip over the
device time launched inside their ranges.
"""

from __future__ import annotations

from benchmark.counters import attention, gn_silu
from benchmark.harness.peaks import least_seconds

_DT = {"torch.bfloat16": "bfloat16", "torch.float16": "float16", "torch.float32": "float32"}


def _dt(t) -> str:
    return _DT[str(t.dtype)]


def _attn_fwd(q, k, v, *, bias=None, scale=None):
    b, h, lq, d = q.shape
    return ("attn", attention.forward(b, h, lq, k.shape[2], d, _dt(q), bias is not None),
            _dt(q))


def _attn_bwd(ctx, grad_out):
    q, k, _v, _o, _lse, bias = ctx.saved_tensors
    b, h, lq, d = q.shape
    return ("attn", attention.backward(b, h, lq, k.shape[2], d, _dt(q), bias is not None),
            _dt(q))


def _gn_fwd(params, x, num_groups, **_kw):
    return ("gn", gn_silu.forward(x.numel(), x.shape[-1], _dt(x)), _dt(x))


def _gn_bwd(ctx, grad_out):
    x = ctx.saved_tensors[0]
    return ("gn", gn_silu.backward(x.numel(), x.shape[-1], _dt(x)), _dt(x))


def install(spans) -> None:
    """Ranges ``bench.attn.fwd``/``.bwd`` and ``bench.gn.fwd``/``.bwd``
    around the port's attention and GroupNorm+SiLU entry points and the
    backwards of their autograd Functions."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.ops.flash_attention import FlashSDPA
    from psg_tpu_torch.ops.fused_norm import GroupNormSiLU

    spans.wrap(ops, "sdpa", "attn.fwd", _attn_fwd)
    spans.wrap(ops, "group_norm_silu", "gn.fwd", _gn_fwd)
    spans.wrap(FlashSDPA, "backward", "attn.bwd", _attn_bwd, static=True)
    spans.wrap(GroupNormSiLU, "backward", "gn.bwd", _gn_bwd, static=True)


def roofline_share(spans, trace, family: str):
    """Percent: least time of the family's calls / device time inside their
    ranges; ``None`` where the traced window holds none."""
    if trace is None or spans is None:
        return None
    least = 0.0
    for part in ("fwd", "bwd"):
        for rec in spans.calls.get(f"{family}.{part}", ()):
            _, (ops, nbytes), dtype = rec
            least += least_seconds(ops, nbytes, dtype)
    device = sum(trace.device_s_in(f"bench.{family}.{part}") for part in ("fwd", "bwd"))
    if least <= 0.0 or device <= 0.0:
        return None
    return 100.0 * least / device
