"""GroupNorm + SiLU over channels-last x: operations and bytes of one call.

Forward: x read once, y written once, scale and bias read (fp32); about 10
operations an element (statistics, normalize, affine, SiLU).  Backward: x
and dy read, dx written, scale and bias read and their gradients written;
about 20 operations an element.  The forward a backward recomputes is not
counted.  At any width this is bound by bytes.
"""

ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def forward(numel: int, channels: int, dtype: str):
    return 10.0 * numel, ELT[dtype] * 2 * numel + 8 * channels


def backward(numel: int, channels: int, dtype: str):
    return 20.0 * numel, ELT[dtype] * 3 * numel + 16 * channels
