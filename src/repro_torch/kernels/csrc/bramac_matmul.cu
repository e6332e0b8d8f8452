// BRAMAC radix-4 digit-pass quantized matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bramac_matmul.py::_kernel
// (pallas_call at bramac_matmul.py:126), entered through ops.quant_matmul.
//
//   out[m, n] = (float(acc[m, n]) * x_scale[m]) * w_scale[n]
//   acc[m, n] = sum_j 4^j * sum_k d_j(x[m, k]) * w[k, n]        (int32, exact)
//
// where d_j are the radix-4 digits of the activation masked to bits_a
// unsigned bits (the top digit signed in {-2..1} when `signed`): one
// bit-parallel integer pass per digit, shift-accumulated — BRAMAC's hybrid
// bit-serial x bit-parallel dataflow.  4-bit weights may arrive pair-packed
// along K (byte r: low nibble W[2r], high nibble W[2r+1], sign-extended).
//
// Bound on the H100: at decode (M = a few slots) every weight byte is read
// once and reused by only M rows, so the kernel is bound by weight bytes
// (granite-8b w_gate: 58.7 MB -> >= 17.5 us at 3.35 TB/s).  Design:
//   * each thread owns 4 adjacent output columns and reads the weights as
//     4-byte words, one K row per load, so a warp reads 128 contiguous bytes
//     per row; 4 rows are transposed in registers (__byte_perm) into 4-k
//     column words that feed __dp4a (4 int8 MACs per instruction);
//   * activation digits are made on the fly from one 4-byte activation word
//     with byte-wise SIMD masks (no digit tensor ever touches memory);
//   * one int32 accumulator per (row, column, digit); digits combine by
//     shifts at the end, so the integer result is exact in any order;
//   * the 8 warps of a block split K, and blocks split K again (split-K)
//     so that even N = 1024 at M = 4 fills the 132 SMs; partial sums meet
//     in an int32 buffer through atomicAdd (integer addition is
//     associative, so the result stays bit-exact), and a second kernel
//     applies the dequantizing epilogue.
// Later work: int8 tensor-core MMA per digit pass (wgmma s8) for the
// prefill shapes, and a persistent split-K without the int32 round trip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;   // 32 lanes x 4 columns
constexpr int kBM = 4;     // activation rows per block

__device__ __forceinline__ uint32_t load_word(const int8_t* base, int row,
                                              int col, int rows, int cols,
                                              bool vec) {
  // 4 consecutive int8 of row `row` from column `col`, zero outside.
  if (row >= rows) return 0u;
  const int8_t* p = base + (size_t)row * cols;
  if (vec && col + 3 < cols) return *reinterpret_cast<const uint32_t*>(p + col);
  uint32_t r = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < cols) r |= (uint32_t)(uint8_t)p[col + i] << (8 * i);
  return r;
}

__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  // per byte: 4-bit two's complement in the low nibble -> int8
  return v | ((v & 0x08080808u) * 0x1Eu);
}

template <int ND, bool SIGNED, bool PACKED>
__global__ void __launch_bounds__(kThreads)
bramac_accumulate(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  int* __restrict__ acc_out, int M, int K, int N,
                  uint32_t amask, int groups_per_split, bool xvec, bool wvec) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kBN + lane * 4;
  const int m0 = blockIdx.y * kBM;
  const int G = (K + 3) / 4;
  const int g_begin = blockIdx.z * groups_per_split;
  const int g_end = min(G, g_begin + groups_per_split);

  int acc[kBM][4][ND];
#pragma unroll
  for (int mi = 0; mi < kBM; ++mi)
#pragma unroll
    for (int ci = 0; ci < 4; ++ci)
#pragma unroll
      for (int j = 0; j < ND; ++j) acc[mi][ci][j] = 0;

  for (int g = g_begin + warp; g < g_end; g += kWarps) {
    const int k = g * 4;
    uint32_t r0, r1, r2, r3;   // weight rows k..k+3 at columns n..n+3
    if (PACKED) {
      const uint32_t p0 = load_word(w, k / 2, n, K / 2, N, wvec);
      const uint32_t p1 = load_word(w, k / 2 + 1, n, K / 2, N, wvec);
      r0 = sext_nibbles(p0 & 0x0F0F0F0Fu);
      r1 = sext_nibbles((p0 >> 4) & 0x0F0F0F0Fu);
      r2 = sext_nibbles(p1 & 0x0F0F0F0Fu);
      r3 = sext_nibbles((p1 >> 4) & 0x0F0F0F0Fu);
    } else {
      r0 = load_word(w, k, n, K, N, wvec);
      r1 = load_word(w, k + 1, n, K, N, wvec);
      r2 = load_word(w, k + 2, n, K, N, wvec);
      r3 = load_word(w, k + 3, n, K, N, wvec);
    }
    // 4x4 byte transpose: c[i] = column n+i at rows k..k+3
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
    const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
    const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
    const int c[4] = {(int)__byte_perm(t0, t1, 0x5410),
                      (int)__byte_perm(t0, t1, 0x7632),
                      (int)__byte_perm(t2, t3, 0x5410),
                      (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int mi = 0; mi < kBM; ++mi) {
      // unsigned bits_a-bit view of 4 activations, one per byte
      const uint32_t u = load_word(x, m0 + mi, k, M, K, xvec) & amask;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t d = (u >> (2 * j)) & 0x03030303u;          // digit j per byte
        if (SIGNED && j == ND - 1) d |= (d & 0x02020202u) * 0x7Eu;  // {2,3}->{-2,-1}
#pragma unroll
        for (int ci = 0; ci < 4; ++ci)
          acc[mi][ci][j] = __dp4a((int)d, c[ci], acc[mi][ci][j]);
      }
    }
  }

  __shared__ int red[kWarps][kBM][kBN];
#pragma unroll
  for (int mi = 0; mi < kBM; ++mi)
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
      int t = 0;
#pragma unroll
      for (int j = 0; j < ND; ++j) t += acc[mi][ci][j] * (1 << (2 * j));
      red[warp][mi][lane * 4 + ci] = t;
    }
  __syncthreads();
  for (int o = threadIdx.x; o < kBM * kBN; o += kThreads) {
    const int mi = o / kBN, col = o % kBN;
    int s = 0;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][mi][col];
    const int m = m0 + mi, nn = blockIdx.x * kBN + col;
    if (m < M && nn < N) atomicAdd(acc_out + (size_t)m * N + nn, s);
  }
}

template <bool BF16>
__global__ void bramac_epilogue(const int* __restrict__ acc,
                                const float* __restrict__ xs,
                                const float* __restrict__ ws, void* out,
                                int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  const float r = ((float)acc[i] * xs[m]) * ws[n];   // the TPU kernel's order
  if (BF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(r);
  else
    static_cast<float*>(out)[i] = r;
}

template <int ND, bool SIGNED, bool PACKED>
void launch_acc(dim3 grid, cudaStream_t st, const int8_t* x, const int8_t* w,
                int* acc, int M, int K, int N, uint32_t amask, int gps,
                bool xvec, bool wvec) {
  bramac_accumulate<ND, SIGNED, PACKED><<<grid, kThreads, 0, st>>>(
      x, w, acc, M, K, N, amask, gps, xvec, wvec);
}

template <int ND>
void dispatch_sp(bool sgn, bool packed, dim3 grid, cudaStream_t st,
                 const int8_t* x, const int8_t* w, int* acc, int M, int K,
                 int N, uint32_t amask, int gps, bool xvec, bool wvec) {
  if (sgn && packed) launch_acc<ND, true, true>(grid, st, x, w, acc, M, K, N, amask, gps, xvec, wvec);
  else if (sgn) launch_acc<ND, true, false>(grid, st, x, w, acc, M, K, N, amask, gps, xvec, wvec);
  else if (packed) launch_acc<ND, false, true>(grid, st, x, w, acc, M, K, N, amask, gps, xvec, wvec);
  else launch_acc<ND, false, false>(grid, st, x, w, acc, M, K, N, amask, gps, xvec, wvec);
}

}  // namespace

// x (M,K) int8; w (K,N) int8 or (K/2,N) pair-packed int8; xs (M,) f32;
// ws (N,) f32; acc (M,N) int32 scratch; out (M,N) f32 or bf16.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int bramac_matmul_launch(const void* x, const void* w,
                                    const void* xs, const void* ws, void* acc,
                                    void* out, int M, int K, int N, int bits_a,
                                    int is_signed, int w_packed, int out_bf16,
                                    int groups_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int G = (K + 3) / 4;
  const int splits = (G + groups_per_split - 1) / groups_per_split;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  const uint32_t byte_mask = (1u << bits_a) - 1u;
  const uint32_t amask = byte_mask * 0x01010101u;
  // 4-byte loads need every row start 4-byte aligned: the row length a
  // multiple of 4 and the base pointer aligned (a view may start anywhere)
  const bool xvec = (K % 4) == 0 && (reinterpret_cast<uintptr_t>(x) % 4) == 0;
  const bool wvec = (N % 4) == 0 && (reinterpret_cast<uintptr_t>(w) % 4) == 0;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* ap = static_cast<int*>(acc);
  const bool sgn = is_signed != 0, packed = w_packed != 0;
  switch ((bits_a + 1) / 2) {
    case 1: dispatch_sp<1>(sgn, packed, grid, st, xp, wp, ap, M, K, N, amask, groups_per_split, xvec, wvec); break;
    case 2: dispatch_sp<2>(sgn, packed, grid, st, xp, wp, ap, M, K, N, amask, groups_per_split, xvec, wvec); break;
    case 4: dispatch_sp<4>(sgn, packed, grid, st, xp, wp, ap, M, K, N, amask, groups_per_split, xvec, wvec); break;
    default: return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (out_bf16)
    bramac_epilogue<true><<<blocks, threads, 0, st>>>(
        ap, static_cast<const float*>(xs), static_cast<const float*>(ws), out, M, N);
  else
    bramac_epilogue<false><<<blocks, threads, 0, st>>>(
        ap, static_cast<const float*>(xs), static_cast<const float*>(ws), out, M, N);
  return (int)cudaGetLastError();
}
