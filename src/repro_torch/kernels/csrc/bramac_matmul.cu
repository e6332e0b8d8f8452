// BRAMAC radix-4 digit-pass quantized matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bramac_matmul.py::_kernel
// (pallas_call at bramac_matmul.py:126), entered through ops.quant_matmul.
//
//   out[m, n] = (float(acc[m, n]) * x_scale[m]) * w_scale[n]   (f32, bf16 or
//               int32; int32 is the f32 value converted toward zero, as the
//               TPU kernel's out_dtype=int32 casts it)
//   acc[m, n] = sum_j 4^j * sum_k d_j(x[m, k]) * w[k, n]        (int32, exact)
//
// where d_j are the radix-4 digits of the activation read as bits_a unsigned
// bits (the top digit signed in {-2..1} when `signed`): one bit-parallel
// integer pass per digit, shift-accumulated -- BRAMAC's hybrid bit-serial x
// bit-parallel dataflow.  4-bit weights may arrive pair-packed along K
// (byte r: low nibble W[2r], high nibble W[2r+1], sign-extended).
//
// Bounds on the H100 (3.35 TB/s, 1979 T int8 ops/s dense):
//   * decode (M = a few slots) is bound by weight bytes: every weight byte
//     is used by M rows only (granite-8b w_gate: 58.7 MB -> >= 17.5 us);
//   * prefill (M = 64) sits near the int8 crossover of ~590 operations per
//     weight byte: four digit passes do 4 * 2 * 64 = 512 per byte.
// Design:
//   * each digit pass is one int8 tensor-core MMA per (m16, n8) fragment
//     (mma.sync m16n8k32 s8 x s8 -> s32), so at M = 64 the passes run at
//     the tensor rate instead of dp4a's instruction rate;
//   * a block owns BM x 128 outputs (BM = 16 at decode, 64 above) and reads
//     its weight columns once per BM rows; each warp owns a disjoint 16 x 32
//     output tile (4 warps at BM = 16, 16 at BM = 64), so warps never reduce
//     through shared memory;
//   * the weight stream (128 K rows x 128 bytes per step) and the activation
//     slice go global -> shared through a 3-stage ring of 16-byte cp.async
//     copies, so the HBM stream keeps two steps in flight while the tensor
//     cores work on the third; rows are XOR-swizzled by 16-byte chunk so the
//     fragment reads are free of bank conflicts.  Chunks at a ragged edge or
//     off a 16-byte boundary are read byte by byte and zero-filled in the
//     same kernel;
//   * B fragments need no shared-memory transpose: column 4c + t of a warp's
//     32-column slab is column c of n8 subtile t, so one 4-byte read from
//     each of 4 K rows, transposed in registers (__byte_perm), gives a
//     thread its B registers for all 4 subtiles;
//   * the digits are made in registers from the A fragment's 4-byte words
//     with byte-wise masks; no digit tensor touches memory.  Each digit
//     keeps its own int32 accumulator and the digits fold by shifts at the
//     end (int32 wraps alike in any order, so the sum is exact);
//   * blocks split K (split-K) until about two waves of blocks cover the
//     132 SMs; partial sums meet in an int32 buffer through atomicAdd (plain
//     stores when K is not split), and a second kernel applies the
//     dequantizing epilogue.
// Later work: wgmma + TMA for M >= 128, one fused launch without the int32
// round trip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;          // output columns per block
constexpr int kBK = 128;          // K per pipeline step: four k32 MMA steps
constexpr int kChunks = 8;        // 16-byte chunks in a 128-byte row
constexpr int kStages = 3;        // depth of the cp.async ring
constexpr int kAccLd = kBN + 4;   // int32 row stride of the staging tile

template <int BM>
struct Tile {
  static constexpr int kWarpsM = BM / 16;            // one m16 row block each
  static constexpr int kThreads = 32 * kWarpsM * 4;   // 4 warps across N
  static constexpr int kStageBytes = kBK * kBN + BM * kBK;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kStaging = BM * kAccLd * 4;
  static constexpr int kSmem = kRing > kStaging ? kRing : kStaging;
  static_assert(kSmem > 48 * 1024 && kSmem <= 227 * 1024, "shared memory");
};

struct Args {
  const int8_t* x;   // (M, K)
  const int8_t* w;   // (K, N), or (K/2, N) pair-packed
  int* acc;          // (M, N) int32
  int M, K, N, k_per_split;
};

__device__ __forceinline__ uint32_t sext_nibbles(uint32_t v) {
  // per byte: 4-bit two's complement in the low nibble -> int8
  return v | ((v & 0x08080808u) * 0x1Eu);
}

// 16-byte chunk index swizzles of the 128-byte weight and activation rows.
// They spread the fragment reads of one warp instruction over all 32 banks
// (see lds_w and lds_x): a B read touches K rows 4*tig + i (packed: rows
// 2*tig + e) at 2 chunks, an A read rows g at 1 chunk.
template <bool PACKED>
__device__ __forceinline__ int wswz(int r) {
  return ((r >> (PACKED ? 1 : 2)) & 3) << 1;
}
__device__ __forceinline__ int xswz(int r) { return r & 7; }

__device__ __forceinline__ void load_chunk(int8_t* dst, const int8_t* base,
                                           int row, int col, int rows,
                                           int ld) {
  // 16 bytes of row `row` (of `rows`, each `ld` bytes) from column `col`;
  // bytes outside the matrix are zero
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row < rows) {
    const int8_t* p = base + (size_t)row * ld + col;
    if (col + 16 <= ld && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(p)
                   : "memory");
      return;
    }
    uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (col + i < ld) u[i >> 2] |= (uint32_t)(uint8_t)p[i] << (8 * (i & 3));
    v = make_uint4(u[0], u[1], u[2], u[3]);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

template <int BM, bool PACKED>
__device__ __forceinline__ void load_stage(int8_t* stage, const Args& a,
                                           int m0, int n0, int k0) {
  constexpr int kThreads = Tile<BM>::kThreads;
  constexpr int kWRows = PACKED ? kBK / 2 : kBK;
  int8_t* sw = stage;
  int8_t* sx = stage + kBK * kBN;
  for (int c = threadIdx.x; c < kWRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    load_chunk(sw + r * kBN + ((ch ^ wswz<PACKED>(r)) << 4), a.w,
               (PACKED ? k0 / 2 : k0) + r, n0 + ch * 16,
               PACKED ? a.K / 2 : a.K, a.N);
  }
  for (int c = threadIdx.x; c < BM * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    load_chunk(sx + r * kBK + ((ch ^ xswz(r)) << 4), a.x, m0 + r,
               k0 + ch * 16, a.M, a.K);
  }
}

template <bool PACKED>
__device__ __forceinline__ uint32_t lds_w(const int8_t* sw, int r, int col) {
  return *reinterpret_cast<const uint32_t*>(
      sw + r * kBN + (((col >> 4) ^ wswz<PACKED>(r)) << 4) + (col & 15));
}

__device__ __forceinline__ uint32_t lds_x(const int8_t* sx, int r, int col) {
  return *reinterpret_cast<const uint32_t*>(
      sx + r * kBK + (((col >> 4) ^ xswz(r)) << 4) + (col & 15));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int ND, bool SIGNED, bool PACKED>
__global__ void __launch_bounds__(Tile<BM>::kThreads, BM == 16 ? 4 : 1)
bramac_accumulate(const Args a) {
  using T = Tile<BM>;
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;       // MMA group, thread in group
  const int wm = warp >> 2, wn = warp & 3;       // warp's tile in the block
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  int acc[ND][4][4];                              // [digit][n8 subtile][reg]
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<BM, PACKED>(smem + s * T::kStageBytes, a, m0, n0,
                             k_begin + s * kBK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  for (int it = 0; it < steps; ++it) {
    // step `it` has landed (this thread's copies), and every thread is past
    // step it-1, whose stage the prefetch below overwrites
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    const int pre = it + kStages - 1;
    if (pre < steps)
      load_stage<BM, PACKED>(smem + (pre % kStages) * T::kStageBytes, a, m0,
                             n0, k_begin + pre * kBK);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const int8_t* sw = smem + (it % kStages) * T::kStageBytes;
    const int8_t* sx = sw + kBK * kBN;
    const int col = wn * 32 + 4 * g;   // this thread's 4 weight columns
    const int row = wm * 16 + g;       // and its A fragment's first row
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s) {   // the k32 MMA steps
      uint32_t b[2][4];                // [k half][n8 subtile]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r0, r1, r2, r3;       // K rows k..k+3 at columns col..col+3
        const int k = 32 * s + 16 * h + 4 * tig;
        if (PACKED) {
          const uint32_t p0 = lds_w<true>(sw, k / 2, col);
          const uint32_t p1 = lds_w<true>(sw, k / 2 + 1, col);
          r0 = sext_nibbles(p0 & 0x0F0F0F0Fu);
          r1 = sext_nibbles((p0 >> 4) & 0x0F0F0F0Fu);
          r2 = sext_nibbles(p1 & 0x0F0F0F0Fu);
          r3 = sext_nibbles((p1 >> 4) & 0x0F0F0F0Fu);
        } else {
          r0 = lds_w<false>(sw, k, col);
          r1 = lds_w<false>(sw, k + 1, col);
          r2 = lds_w<false>(sw, k + 2, col);
          r3 = lds_w<false>(sw, k + 3, col);
        }
        // 4x4 byte transpose: b[h][t] = column col+t (column g of subtile
        // t) at rows k..k+3
        const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
        const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
        const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
        const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
        b[h][0] = __byte_perm(t0, t1, 0x5410);
        b[h][1] = __byte_perm(t0, t1, 0x7632);
        b[h][2] = __byte_perm(t2, t3, 0x5410);
        b[h][3] = __byte_perm(t2, t3, 0x7632);
      }
      const int kc = 32 * s + 4 * tig;
      const uint32_t x4[4] = {lds_x(sx, row, kc), lds_x(sx, row + 8, kc),
                              lds_x(sx, row, kc + 16),
                              lds_x(sx, row + 8, kc + 16)};
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        // digit j of every byte: bits 2j, 2j+1 of the bits_a-bit view
        uint32_t d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          d[q] = (x4[q] >> (2 * j)) & 0x03030303u;
          if (SIGNED && j == ND - 1)
            d[q] |= (d[q] & 0x02020202u) * 0x7Eu;    // {2,3} -> {-2,-1}
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) mma_s8(acc[j][t], d, b[0][t], b[1][t]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // fold the digits, stage the block's int32 tile, then write it row-major
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t v = 0u;
#pragma unroll
      for (int j = 0; j < ND; ++j) v += (uint32_t)acc[j][t][i] << (2 * j);
      const int r = wm * 16 + g + 8 * (i >> 1);
      const int c = wn * 32 + 4 * (2 * tig + (i & 1)) + t;
      tile[r * kAccLd + c] = (int)v;
    }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * kBN; e += T::kThreads) {
    const int r = e / kBN, c = e % kBN;
    const int m = m0 + r, n = n0 + c;
    if (m >= a.M || n >= a.N) continue;
    int* dst = a.acc + (size_t)m * a.N + n;
    if (gridDim.z == 1)
      *dst = tile[r * kAccLd + c];
    else
      atomicAdd(dst, tile[r * kAccLd + c]);
  }
}

// Output kinds of the epilogue (the wrapper's out_kind argument).
constexpr int kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2;

template <int KIND>
__global__ void bramac_epilogue(const int* __restrict__ acc,
                                const float* __restrict__ xs,
                                const float* __restrict__ ws, void* out,
                                int M, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)M * N) return;
  const int m = (int)(i / N), n = (int)(i % N);
  const float r = ((float)acc[i] * xs[m]) * ws[n];   // the TPU kernel's order
  if (KIND == kOutBF16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(r);
  else if (KIND == kOutI32)
    // the TPU kernel's f32 result converted to int32 (toward zero): the
    // row-parallel matmul's unit-scale mode.  It is not the raw int32
    // accumulator: the f32 round trip rounds once |acc| > 2^24
    static_cast<int*>(out)[i] = __float2int_rz(r);
  else
    static_cast<float*>(out)[i] = r;
}

template <int BM, int ND, bool SIGNED, bool PACKED>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&bramac_accumulate<BM, ND, SIGNED, PACKED>);
}

template <int BM, int ND, bool SIGNED, bool PACKED>
cudaError_t launch_acc(dim3 grid, cudaStream_t st, const Args& a) {
  constexpr int kSmem = Tile<BM>::kSmem;   // above the default 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel_of<BM, ND, SIGNED, PACKED>(),
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  bramac_accumulate<BM, ND, SIGNED, PACKED>
      <<<grid, Tile<BM>::kThreads, kSmem, st>>>(a);
  return cudaGetLastError();
}

// Calls f.run<BM, ND, SIGNED, PACKED>() for the runtime choice;
// cudaErrorInvalidValue for a choice that has no instantiation.
template <int BM, int ND, typename F>
cudaError_t dispatch_sp(bool sgn, bool packed, const F& f) {
  if (sgn && packed) return f.template run<BM, ND, true, true>();
  if (sgn) return f.template run<BM, ND, true, false>();
  if (packed) return f.template run<BM, ND, false, true>();
  return f.template run<BM, ND, false, false>();
}

template <int BM, typename F>
cudaError_t dispatch_nd(int bits_a, bool sgn, bool packed, const F& f) {
  switch (bits_a) {
    case 2: return dispatch_sp<BM, 1>(sgn, packed, f);
    case 4: return dispatch_sp<BM, 2>(sgn, packed, f);
    case 8: return dispatch_sp<BM, 4>(sgn, packed, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t dispatch(int bm, int bits_a, bool sgn, bool packed, const F& f) {
  if (bm == 16) return dispatch_nd<16>(bits_a, sgn, packed, f);
  if (bm == 64) return dispatch_nd<64>(bits_a, sgn, packed, f);
  return cudaErrorInvalidValue;
}

struct Launch {
  dim3 grid;
  cudaStream_t st;
  Args a;
  template <int BM, int ND, bool SIGNED, bool PACKED>
  cudaError_t run() const { return launch_acc<BM, ND, SIGNED, PACKED>(grid, st, a); }
};

struct Info {
  int* out;
  template <int BM, int ND, bool SIGNED, bool PACKED>
  cudaError_t run() const {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, kernel_of<BM, ND, SIGNED, PACKED>());
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = Tile<BM>::kSmem;
    out[3] = Tile<BM>::kThreads;
    return cudaSuccess;
  }
};

}  // namespace

// x (M,K) int8; w (K,N) int8 or (K/2,N) pair-packed int8; xs (M,) f32;
// ws (N,) f32; acc (M,N) int32 scratch; out (M,N) f32, bf16 or int32 as
// out_kind says (0 f32, 1 bf16, 2 int32: the f32 result converted).  bm is the
// block's rows (16 or 64); K splits into ceil(K / k_per_split) ranges of
// k_per_split (a multiple of the 128-byte K step) each, the last one
// shorter.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int bramac_matmul_launch(const void* x, const void* w,
                                    const void* xs, const void* ws, void* acc,
                                    void* out, int M, int K, int N, int bits_a,
                                    int is_signed, int w_packed, int out_kind,
                                    int bm, int k_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k_per_split <= 0 || k_per_split % kBK) return (int)cudaErrorInvalidValue;
  if (out_kind < kOutF32 || out_kind > kOutI32) return (int)cudaErrorInvalidValue;
  const int splits = K > 0 ? (K + k_per_split - 1) / k_per_split : 1;
  cudaError_t err;
  if (splits > 1) {
    err = cudaMemsetAsync(acc, 0, (size_t)M * N * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
  }
  const Launch launch{dim3((N + kBN - 1) / kBN, (M + bm - 1) / bm, splits),
                      st,
                      Args{static_cast<const int8_t*>(x),
                           static_cast<const int8_t*>(w),
                           static_cast<int*>(acc), M, K, N, k_per_split}};
  err = dispatch(bm, bits_a, is_signed != 0, w_packed != 0, launch);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)M * N;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  const auto* ap = static_cast<const int*>(acc);
  const auto* xp = static_cast<const float*>(xs);
  const auto* wp = static_cast<const float*>(ws);
  switch (out_kind) {
    case kOutF32:
      bramac_epilogue<kOutF32><<<blocks, threads, 0, st>>>(ap, xp, wp, out, M, N);
      break;
    case kOutBF16:
      bramac_epilogue<kOutBF16><<<blocks, threads, 0, st>>>(ap, xp, wp, out, M, N);
      break;
    case kOutI32:
      bramac_epilogue<kOutI32><<<blocks, threads, 0, st>>>(ap, xp, wp, out, M, N);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The accumulate kernel's build for (bm, bits_a, signed, packed): out[0]
// registers per thread, out[1] local (spill) bytes per thread, out[2]
// dynamic shared memory bytes per block, out[3] threads per block.
extern "C" int bramac_matmul_info(int bm, int bits_a, int is_signed,
                                  int w_packed, void* out) {
  return (int)dispatch(bm, bits_a, is_signed != 0, w_packed != 0,
                       Info{static_cast<int*>(out)});
}
