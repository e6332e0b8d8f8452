// BRAMAC dummy-array MVM through chained MAC2s, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mac2_kernel.py::_kernel
// (pallas_call at mac2_kernel.py:88), entered through mac2_mvm_kernel.
//
//   out[r] = sum over column pairs k of MAC2(w[r,2k], w[r,2k+1], x[2k], x[2k+1])
//
// Each MAC2 runs Algorithm 1 as the 7-row dummy array does: the weights are
// sign-extended to 32-bit lanes (rows W1, W2) and summed (row W1+W2); each
// input is read as its `bits`-bit unsigned view; for input bit i from MSB to
// LSB the bit pair {I2[i], I1[i]} selects row 0..3 (zero, W1, W2, W1+W2), the
// signed MSB pass adds the Inverter row plus one (~psum + 1), and P shifts
// left after every pass but the LSB; P then adds into the Accumulator.  All
// of P, the Inverter and the accumulator are uint32, so every step wraps as
// the reference's int32 arithmetic does and no signed overflow or left shift
// of a negative value (undefined in C++17) occurs; the result is cast once.
//
// Bound on the H100: every weight byte is read once, so the least time is
// (R*C + C + 4R) bytes at 3.35 TB/s: 17.5 us for the granite-8b w_gate GEMV
// (R = 14336, C = 4096).  The emulation costs about 8 integer instructions
// per bit pass per (row, column pair) — select, add, shift — so at 8 bits
// some 2 G instructions for w_gate, against the card's ~16 T int32
// operations/s (132 SMs x 64 INT32 lanes x ~1.9 GHz): the kernel is bound by
// instruction issue, not by bytes.  Design:
//   * one warp per output row; its lanes take column pairs k, k+32, ..., so a
//     warp reads 64 contiguous weight bytes per step (coalesced), and the
//     lanes' uint32 accumulators meet through __shfl_xor_sync (integer
//     addition, so the sum is exact in any order);
//   * x is the CIM instruction's broadcast operand: each block stages it in
//     shared memory, 4096 column pairs at a time, as one select word per pair
//     (the 2-bit demux selects of every pass, interleaved), computed once per
//     block and read by all eight warps;
//   * `bits` and `signed` are template parameters, so the pass loop unrolls
//     and the MSB pass is resolved at compile time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkPairs = 4096;   // column pairs of x staged per step (8 KB)

template <int BITS, bool SIGNED>
__global__ void __launch_bounds__(kThreads)
mac2_mvm(const int8_t* __restrict__ w, const int8_t* __restrict__ x,
         int32_t* __restrict__ out, int R, int C) {
  __shared__ uint16_t sel_words[kChunkPairs];
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int pairs = C / 2;
  const uint32_t mask = (1u << BITS) - 1u;
  const int8_t* wrow = w + (size_t)min(row, R - 1) * C;
  uint32_t acc = 0u;                               // the Accumulator row
  for (int k0 = 0; k0 < pairs; k0 += kChunkPairs) {
    const int n = min(kChunkPairs, pairs - k0);
    __syncthreads();                               // last chunk consumed
    for (int k = threadIdx.x; k < n; k += kThreads) {
      // unsigned bits-bit views of the input pair, then pass i's select
      // {I2[i], I1[i]} in bits 2i+1..2i of the word
      const uint32_t u1 = (uint32_t)(int32_t)x[2 * (k0 + k)] & mask;
      const uint32_t u2 = (uint32_t)(int32_t)x[2 * (k0 + k) + 1] & mask;
      uint32_t s = 0u;
#pragma unroll
      for (int i = 0; i < BITS; ++i)
        s |= ((((u2 >> i) & 1u) << 1) | ((u1 >> i) & 1u)) << (2 * i);
      sel_words[k] = (uint16_t)s;
    }
    __syncthreads();
    if (row < R) {
      for (int k = lane; k < n; k += 32) {
        // weight copy with the sign-extension mux, then row 3 = W1 + W2
        const uint32_t w1 = (uint32_t)(int32_t)wrow[2 * (k0 + k)];
        const uint32_t w2 = (uint32_t)(int32_t)wrow[2 * (k0 + k) + 1];
        const uint32_t w12 = w1 + w2;
        const uint32_t s = sel_words[k];
        uint32_t p = 0u;                           // row P
#pragma unroll
        for (int i = BITS - 1; i >= 0; --i) {
          const uint32_t sel = (s >> (2 * i)) & 3u;          // 2-to-4 demux
          const uint32_t psum = sel == 0u ? 0u : sel == 1u ? w1
                              : sel == 2u ? w2 : w12;
          if (SIGNED && i == BITS - 1) {
            const uint32_t inv = ~psum;                       // Inverter row
            p = p + inv + 1u;
          } else {
            p = p + psum;
          }
          if (i != 0) p <<= 1;                                // shift write-back
        }
        acc += p;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < R && lane == 0) out[row] = (int32_t)acc;
}

template <int BITS>
void launch(bool sgn, dim3 grid, cudaStream_t st, const int8_t* w,
            const int8_t* x, int32_t* out, int R, int C) {
  if (sgn)
    mac2_mvm<BITS, true><<<grid, kThreads, 0, st>>>(w, x, out, R, C);
  else
    mac2_mvm<BITS, false><<<grid, kThreads, 0, st>>>(w, x, out, R, C);
}

}  // namespace

// w (R,C) int8 row-major; x (C,) int8; out (R,) int32.  R >= 1, C even,
// bits in {2, 4, 8}.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int mac2_mvm_launch(const void* w, const void* x, void* out, int R,
                               int C, int bits, int is_signed, void* stream) {
  if (R <= 0 || C < 0 || C % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((R + kWarps - 1) / kWarps);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* xp = static_cast<const int8_t*>(x);
  auto* op = static_cast<int32_t*>(out);
  const bool sgn = is_signed != 0;
  switch (bits) {
    case 2: launch<2>(sgn, grid, st, wp, xp, op, R, C); break;
    case 4: launch<4>(sgn, grid, st, wp, xp, op, R, C); break;
    case 8: launch<8>(sgn, grid, st, wp, xp, op, R, C); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
