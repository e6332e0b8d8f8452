// BRAMAC dummy-array MVM through chained MAC2s, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mac2_kernel.py::_kernel
// (pallas_call at mac2_kernel.py:88), entered through mac2_mvm_kernel.
//
//   out[r] = sum over column pairs k of MAC2(w[r,2k], w[r,2k+1], x[2k], x[2k+1])
//
// Algorithm 1 as linear algebra.  In pass i (MSB to LSB) the demux of a MAC2
// reads the dummy-array row {0, W1, W2, W1+W2} that input bits {I2[i], I1[i]}
// select: that row is w1*b1 + w2*b2 with b = (u >> i) & 1, u the unsigned
// `bits`-bit view of the input.  The signed MSB pass adds it through the
// Inverter row (~psum + 1, a negation), and P shifts left after every pass
// but the LSB, so a MAC2 is sum_i c_i 2^i (w1*b1_i + w2*b2_i) with c_i = -1
// for the signed MSB and +1 otherwise; the Accumulator row sums the pairs.
// Over a whole row that is
//
//   out[r] = sum_i c_i 2^i S_i[r]  (mod 2^32),   S_i = w @ plane_i(x),
//
// and this kernel computes it on the int8 tensor cores: each column of one
// mma.sync m16n8k32 s8 *is* one bit pass of Algorithm 1.  A is 16 weight rows
// x 32 columns read straight from the row-major w; B is 32 columns x the 8
// bit planes of x as s8 values 0 or 1 (planes at or past `bits` are zero);
// C holds S_i for 16 rows x 8 passes in s32.  The mma's int32 sums are exact
// while |S_i| < 2^31; the kernel folds them into its uint32 result after
// every chunk of at most 16384 columns, so |S_i| <= 2^21.  The fold weights
// each pass by 2^i, the MSB column negated as the Inverter row does, in
// uint32, and a quad of threads sums its passes with shuffles, so every
// step wraps as the reference's int32 lanes do.
//
// Bound on the H100: the MMAs do 2*8*R*C operations, which the tensor cores
// take in a few microseconds at most; every weight byte is read once, so the
// least time is (R*C + C + 4R) bytes at 3.35 TB/s: 17.5 us for the
// granite-8b w_gate GEMV (R = 14336, C = 4096).  The kernel is bound by HBM
// bytes, like every GEMV, and its design is about keeping HBM busy:
//   * each warp owns 16 rows and the block's K range; a thread loads 16
//     contiguous bytes of each of its two rows per 64-byte K window (a quad
//     reads 64 contiguous bytes of a row), eight windows per batch (512
//     bytes of each row), and the next batch is in flight while the MMAs
//     use this one: 8 KB per warp, about 100 KB per SM outstanding, in
//     registers (a shared-memory cp.async ring and row-contiguous staging
//     measured no faster).  A chunk past the range reloads the range's last
//     chunk instead of branching (a branch per load measured slower).
//     Inside a window the K order is permuted (column 16t + 8j + 4h + b is the MMA's
//     k = 16h + 4t + b of MMA j), which is free because the sum over K is
//     integer; A and B use the same order;
//   * x is the CIM instruction's broadcast operand: the block stages its K
//     range in shared memory, 16 KB at a time, and every thread makes its B
//     fragment (bit plane g of 16 bytes of x) with one shift and mask a word;
//   * a launch plan (kernels/mac2_kernel._plan) splits C into at most 8
//     ranges so that at least two blocks per SM are in flight at every
//     granite shape, with blocks of 64, 32 or 16 rows.  The blocks of one
//     row block's ranges form a thread block cluster, and their uint32 sums
//     meet in rank 0's shared memory by distributed shared memory atomics
//     (the same bits in any order): no memset of `out` and no global
//     atomics (a memset launch before each split GEMV measured slower);
//   * rows of C % 16 != 0 columns, or a w whose base is not 16-byte aligned,
//     take the byte-load instantiation (VEC = false); `bits` and `signed` are
//     template parameters.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 64;         // rows per block: 16, 32 or 64, one
constexpr int kMaxThreads = 2 * kMaxRows;   // m16 tile (a warp) each
constexpr int kWin = 64;             // K bytes per window: two k32 MMAs
constexpr int kBatch = 8;            // windows per load batch (512 B a row)
constexpr int kChunk = 16384;        // K bytes per x chunk in shared memory
constexpr int kMaxSplits = 8;        // blocks of a cluster: the portable size

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes at p with one load that skips L1 (the weights are read once)
__device__ __forceinline__ uint4 ldg16(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// 16 bytes of a row from byte k of the block's range (n bytes long).  VEC:
// rows and range are 16-byte aligned and n is a multiple of 16; a chunk at
// or past n reads the range's last chunk instead (valid memory, no branch),
// which adds nothing because x's bit planes are zero there.  Otherwise the
// bytes are read one by one and those at or past n are zero.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const int8_t* p, int k, int n) {
  if (VEC) return ldg16(p + min(k, n - 16));
  uint32_t u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k + i < n) u[i >> 2] |= (uint32_t)(uint8_t)p[k + i] << (8 * (i & 3));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// This thread's chunks of one batch: rows g and g+8, bytes [16t, 16t+16)
// of kBatch windows from k.
template <bool VEC>
__device__ __forceinline__ void load_batch(uint4 (&v)[kBatch][2],
                                           const int8_t* w0, const int8_t* w1,
                                           int k, int n, int t) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    v[u][0] = load16<VEC>(w0, k + u * kWin + 16 * t, n);
    v[u][1] = load16<VEC>(w1, k + u * kWin + 16 * t, n);
  }
}

// weight of pass i in the uint32 combine: 2^i, negated for the signed MSB
// (the Inverter row); zero for the planes past `bits`
template <int BITS, bool SIGNED>
__device__ __forceinline__ uint32_t pass_weight(int i) {
  if (i >= BITS) return 0u;
  const uint32_t p = 1u << i;
  return (SIGNED && i == BITS - 1) ? 0u - p : p;
}

template <int BITS, bool SIGNED, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
mac2_mvm(const int8_t* __restrict__ w, const int8_t* __restrict__ x,
         int32_t* __restrict__ out, int R, int C, int kps) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) int8_t xs[];   // a chunk of x, zero padded
  __shared__ unsigned int part[kMaxRows];        // rank 0: the cluster's sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;         // MMA group, thread in group
  const int S = gridDim.x, s = blockIdx.x;       // the cluster spans x: rank s
  const int rows = blockDim.x / 2;               // 16 a warp
  const int rb = blockIdx.y + gridDim.y * blockIdx.z;   // row block
  if (rb * rows >= R) return;                    // a whole cluster or none
  const int lr = warp * 16 + g;                  // this thread's rows lr, lr+8
  const int r0 = rb * rows + lr, r1 = r0 + 8;
  if (S > 1) {
    // rank 0's zeros go out before any block's sums (waited for at the end)
    if (s == 0 && threadIdx.x < rows) part[threadIdx.x] = 0u;
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  // rows past R read row R-1 (valid memory) and are never written
  const int8_t* w0 = w + (size_t)min(r0, R - 1) * C;
  const int8_t* w1 = w + (size_t)min(r1, R - 1) * C;
  const uint32_t m = g < BITS ? 0x01010101u : 0u;
  const uint32_t p0 = pass_weight<BITS, SIGNED>(2 * t);
  const uint32_t p1 = pass_weight<BITS, SIGNED>(2 * t + 1);
  uint32_t v0 = 0u, v1 = 0u;   // rows lr, lr + 8: sum_i c_i 2^i S_i, mod 2^32
  const int k_end = min(C, (s + 1) * kps);
  for (int k0 = s * kps; k0 < k_end; k0 += kChunk) {
    const int n = min(k_end - k0, kChunk);
    const int kpad = (n + kBatch * kWin - 1) / (kBatch * kWin) * (kBatch * kWin);
    uint4 cur[kBatch][2];
    load_batch<VEC>(cur, w0 + k0, w1 + k0, 0, n, t);   // in flight while x stages
    __syncthreads();                                   // the last chunk is used
    const int8_t* xb = x + k0;
    const bool xvec = VEC && (reinterpret_cast<uintptr_t>(xb) & 15) == 0;
    for (int i = threadIdx.x; i < kpad / 16; i += blockDim.x) {
      uint4 v;
      if (xvec)
        v = i * 16 < n ? *reinterpret_cast<const uint4*>(xb + i * 16)
                       : make_uint4(0u, 0u, 0u, 0u);
      else
        v = load16<false>(xb, i * 16, n);
      reinterpret_cast<uint4*>(xs)[i] = v;
    }
    __syncthreads();

    int c[4] = {0, 0, 0, 0};   // S_i: rows lr, lr+8 x planes 2t, 2t+1 (exact:
                               // |S_i| <= 128 * kChunk = 2^21)
    for (int k = 0; k < kpad; k += kBatch * kWin) {
      uint4 nxt[kBatch][2];
      const bool more = k + kBatch * kWin < kpad;
      if (more) load_batch<VEC>(nxt, w0 + k0, w1 + k0, k + kBatch * kWin, n, t);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        // B: bit plane g of x bytes [kw + 16t, kw + 16t + 16), as s8 0/1; the
        // padding past n is zero in x, so it adds nothing whatever w holds
        const int kw = k + u * kWin;
        const uint4 xv = *reinterpret_cast<const uint4*>(xs + kw + 16 * t);
        const uint32_t b0 = (xv.x >> g) & m, b1 = (xv.y >> g) & m;
        const uint32_t b2 = (xv.z >> g) & m, b3 = (xv.w >> g) & m;
        const uint4 a = cur[u][0], a8 = cur[u][1];     // rows lr and lr + 8
        mma_s8(c, a.x, a8.x, a.y, a8.y, b0, b1);       // MMA j = 0: bytes 0-7
        mma_s8(c, a.z, a8.z, a.w, a8.w, b2, b3);       // MMA j = 1: bytes 8-15
      }
      if (more) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          cur[u][0] = nxt[u][0];
          cur[u][1] = nxt[u][1];
        }
      }
    }
    // the shift-and-invert passes of Algorithm 1 as one weighted sum, uint32
    v0 += (uint32_t)c[0] * p0 + (uint32_t)c[1] * p1;
    v1 += (uint32_t)c[2] * p0 + (uint32_t)c[3] * p1;
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, o);
    v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  auto* o = reinterpret_cast<unsigned int*>(out);
  if (S == 1) {
    if (t == 0 && r0 < R) o[r0] = v0;
    if (t == 0 && r1 < R) o[r1] = v1;
    return;
  }
  // split K: the cluster's sums meet in rank 0's shared memory by uint32
  // atomicAdd (the same bits in any order), then rank 0 writes them
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  if (t == 0) {
    unsigned int* p = cluster.map_shared_rank(part, 0);
    atomicAdd(p + lr, v0);
    atomicAdd(p + lr + 8, v1);
  }
  cluster.sync();   // every block's sums are in; rank 0 alone reads them
  const int r = rb * rows + threadIdx.x;
  if (s == 0 && threadIdx.x < rows && r < R) o[r] = part[threadIdx.x];
}

template <int BITS, bool SIGNED, bool VEC>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&mac2_mvm<BITS, SIGNED, VEC>);
}

// Calls f.run<BITS, SIGNED, VEC>() for the runtime choice.
template <typename F>
cudaError_t dispatch(int bits, bool sgn, bool vec, const F& f) {
#define MAC2_CASE(B)                                              \
  case B:                                                         \
    if (sgn) return vec ? f.template run<B, true, true>()         \
                        : f.template run<B, true, false>();       \
    return vec ? f.template run<B, false, true>()                 \
               : f.template run<B, false, false>();
  switch (bits) {
    MAC2_CASE(2)
    MAC2_CASE(4)
    MAC2_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef MAC2_CASE
}

struct Launch {
  cudaLaunchConfig_t cfg;
  const int8_t* w;
  const int8_t* x;
  int32_t* out;
  int R, C, kps;
  template <int BITS, bool SIGNED, bool VEC>
  cudaError_t run() const {
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, mac2_mvm<BITS, SIGNED, VEC>, w, x, out, R, C, kps);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
};

struct Info {
  int* out;
  template <int BITS, bool SIGNED, bool VEC>
  cudaError_t run() const {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, kernel_of<BITS, SIGNED, VEC>());
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = kChunk;    // dynamic shared memory at the largest K range
    out[3] = kMaxThreads;
    return cudaSuccess;
  }
};

}  // namespace

// w (R,C) int8 row-major; x (C,) int8; out (R,) int32.  R >= 1, C even,
// bits in {2, 4, 8}.  Blocks of `rows` rows (16, 32 or 64); C splits into
// ceil(C / kps) <= 8 ranges of kps columns (a positive multiple of 64), the
// blocks of one row block's ranges forming a thread block cluster.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int mac2_mvm_launch(const void* w, const void* x, void* out, int R,
                               int C, int bits, int is_signed, int rows,
                               int kps, void* stream) {
  if (R <= 0 || C <= 0 || C % 2 || kps <= 0 || kps % kWin ||
      (rows != 16 && rows != 32 && rows != 64))
    return (int)cudaErrorInvalidValue;
  const int splits = (C + kps - 1) / kps;
  const int row_blocks = (R + rows - 1) / rows;
  if (splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  const bool vec = C % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int chunk = kps < kChunk ? kps : kChunk;
  Launch launch{{}, static_cast<const int8_t*>(w),
                static_cast<const int8_t*>(x), static_cast<int32_t*>(out), R,
                C, kps};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // row blocks past 65535 go on in z (one-block clusters: the plan splits
  // C only when the row blocks are few)
  launch.cfg.gridDim = dim3(splits, row_blocks < 65535 ? row_blocks : 65535,
                            (row_blocks + 65534) / 65535);
  launch.cfg.blockDim = dim3(2 * rows);
  launch.cfg.dynamicSmemBytes =
      (size_t)((chunk + kBatch * kWin - 1) / (kBatch * kWin) * (kBatch * kWin));
  launch.cfg.stream = static_cast<cudaStream_t>(stream);
  launch.cfg.attrs = attr;
  launch.cfg.numAttrs = 1;
  return (int)dispatch(bits, is_signed != 0, vec, launch);
}

// The build of the instantiation for (bits, signed, vec): out[0] registers
// per thread, out[1] local (spill) bytes per thread, out[2] the largest
// dynamic shared memory of a block, out[3] threads per block.
extern "C" int mac2_mvm_info(int bits, int is_signed, int vec, void* out) {
  return (int)dispatch(bits, is_signed != 0, vec != 0,
                       Info{static_cast<int*>(out)});
}
