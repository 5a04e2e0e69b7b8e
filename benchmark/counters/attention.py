"""Scaled dot-product attention: operations and bytes of one call.

Forward: S = QK^T and O = PV, 4·B·H·Lq·Lk·D operations; Q, K, V and the
key bias read once, O written once.  Backward: dV = P^T dO, dP = dO V^T,
dQ = dS K, dK = dS^T Q, 8·B·H·Lq·Lk·D; Q, K, V, O, dO, the row logsumexp
and the bias read once, dQ, dK, dV written once.  The scores a kernel
recomputes are not counted, nor the softmax's element-wise work.
"""

ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def forward(b, h, lq, lk, d, dtype: str, bias: bool):
    e = ELT[dtype]
    ops = 4.0 * b * h * lq * lk * d
    nbytes = e * (2 * b * h * lq * d + 2 * b * h * lk * d) + (4 * b * lk if bias else 0)
    return ops, nbytes


def backward(b, h, lq, lk, d, dtype: str, bias: bool):
    e = ELT[dtype]
    ops = 8.0 * b * h * lq * lk * d
    nbytes = (e * (3 * b * h * lq * d + 2 * b * h * lk * d)     # q, o, do; k, v
              + 4 * b * h * lq                                  # lse
              + (4 * b * lk if bias else 0)
              + e * (b * h * lq * d + 2 * b * h * lk * d))      # dq; dk, dv
    return ops, nbytes
