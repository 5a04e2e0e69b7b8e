#!/usr/bin/env python3
"""Write ``psg_tpu_torch/csrc/wgmma.cuh``: the Hopper warpgroup products the
flash attention kernel issues, one inline-PTX function per shape.

    python3 scripts/torch_gen_wgmma.py

``wgmma.mma_async`` lists every accumulator register in the instruction, so
each N needs its own asm statement; this script writes them out.  The header
is committed; ``tests/test_torch_wgmma_header.py`` holds it equal to
``render()``, so edit this script and run it, never the header.
"""

from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "psg_tpu_torch" / "csrc" / "wgmma.cuh"

# N of the P.V product: the head dims up to 160 in steps of 16
RS_TRANS_B = tuple(range(16, 161, 16))


def _regs(n_acc, first=0):
    return ", ".join(f"%{first + i}" for i in range(n_acc))


def _outs(n_acc):
    return ", ".join(f'"+f"(d[{i}])' for i in range(n_acc))


def ss(n):
    """D(64 x n) (+)= A(64 x 16, smem) * B(16 x n, smem), both K-major."""
    acc = n // 2
    return f"""
// D[64 x {n}] (+)= A * B, A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_m64n{n}(float (&d)[{acc}], uint64_t da,
                                                 uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(acc)}}}, %{acc}, %{acc + 1}, p, 1, 1, 0, 0;\\n}}\\n"
      : {_outs(acc)}
      : "l"(da), "l"(db), "r"(scale_d));
}}
"""


def rs_trans_b(n):
    """D(64 x n) (+)= A(64 x 16, registers) * B(16 x n, smem, N-major)."""
    acc = n // 2
    return f"""
// D[64 x {n}] (+)= A * B, A in registers (an m16k16 fragment a warp), B in
// shared memory N-major (transposed).
__device__ __forceinline__ void wgmma_rs_m64n{n}_tb(float (&d)[{acc}],
                                                    const uint32_t (&a)[4], uint64_t db,
                                                    int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{acc + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{_regs(acc)}}}, {{%{acc}, %{acc + 1}, %{acc + 2}, %{acc + 3}}}, %{acc + 4}, "
      "p, 1, 1, 1;\\n}}\\n"
      : {_outs(acc)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}}
"""


def render() -> str:
    """The header's text."""
    parts = ["""// Generated by scripts/torch_gen_wgmma.py; do not edit.
//
// Hopper warpgroup matrix products (wgmma.mma_async, bf16 in, fp32
// accumulate, sm_90a).  Four warps issue each together; warp w of the
// warpgroup holds rows 16w .. 16w + 15 of the 64-row accumulator, in the
// layout of an mma.sync m16n8 accumulator repeated over the N/8 column
// blocks: d[4j + e] is row 16w + g + 8 (e >> 1), column 8j + 2 tq + (e & 1),
// where lane = 4 g + tq.  Operands in shared memory are named by matrix
// descriptors (psg::wgmma_desc).  The caller brackets the products with
// wgmma_fence / wgmma_commit / wgmma_wait.
#pragma once

#include <cstdint>

namespace psg {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma_fence / wgmma_wait.
template <int N>
__device__ __forceinline__ void wgmma_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Matrix descriptor of a no-swizzle (interleaved) operand in shared memory:
// 8 x 16-byte core matrices, `lbo` bytes apart along K and `sbo` bytes
// apart along M or N.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
"""]
    parts.append(ss(64))
    for n in RS_TRANS_B:
        parts.append(rs_trans_b(n))
    parts.append("""
// wgmma_rs_tb<N>: the m64nNk16 register-A product above, by N.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t db, int scale_d);
""")
    for n in RS_TRANS_B:
        parts.append(f"""template <>
__device__ __forceinline__ void wgmma_rs_tb<{n}>(float (&d)[{n // 2}], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {{
  wgmma_rs_m64n{n}_tb(d, a, db, scale_d);
}}
""")
    parts.append("\n}  // namespace psg\n")
    return "".join(parts)


def main():
    OUT.write_text(render())


if __name__ == "__main__":
    main()
