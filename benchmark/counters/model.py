"""Model FLOPs from the plain reference, counted on the ``meta`` device.

``flops(fn)`` runs ``fn`` (a reference forward, or forward and backward,
over meta tensors) under ``torch.utils.flop_counter.FlopCounterMode`` and
returns the floating-point operations of its matrix products and
convolutions: no memory is touched and nothing runs on a device.
"""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def flops(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
