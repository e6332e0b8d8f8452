// Paged-KV decode attention for Hopper (sm_90a): block-table walks, no gather.
//
// Both kernels compute Sq=1 GQA decode attention straight off the shared
// page pool (P, page_size, Hkv, hd), walking only the
// min(n_pages, ceil(len/ps)) pages a sequence owns, never max_seq rows.
// Both split that walk the same way: the grid is (S, Hkv, B) and the S <= 8
// blocks of one (sequence, KV head) form a thread block cluster, S and the
// pages per block chosen on the host from max_pages alone
// (kernels/paged_attention._split), so no length is read on the host.
// Block s owns a contiguous range of the table's pages; a block whose range
// lies past the walked pages reads no K or V but still arrives at every
// cluster barrier.
//
// paged_decode_kernel (fp) replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::_fp_kernel (pallas_call at :214):
// fp32 scores q.k / sqrt(hd), rows >= len masked to -1e30, online softmax
// (running max, normalizer, rescaled accumulator); a sequence with no pages
// emits zeros.  Bound on the H100: the live K and V bytes over 3.35 TB/s
// (about 0.6 us at the serve shape; a few FLOPs per byte).  What holds such
// a kernel at decode lengths is latency, so:
//   * the lengths, the block's table entries and q go out together, then
//     K and V of the block's live rows (rows past the length are masked to
//     -1e30 by the reference, i.e. weigh exactly 0, and are not read)
//     stream through a ring of kFpStages shared-memory tiles of `tile` rows
//     (16-byte cp.async copies where hd * itemsize is a multiple of 16 and
//     the pools are aligned, element loads otherwise), two tiles in flight
//     while one is computed; one ring serves a 2-page range and a 32-page
//     one alike;
//   * warp w serves query heads w, w + 4, ... of the group, a lane per
//     row of the tile: every score once (the row's 16-byte chunks read
//     from shared memory at an odd chunk stride, so the lanes' rows do not
//     conflict; q broadcast), exp(s - m) once per (head, row) in registers,
//     then p.V with the lane's 8-byte units of each V row; the tiles fold
//     into a running (m, l, acc) with the reference's rescale
//     (acc * corr + p.V).  One block barrier a tile, for the ring;
//   * the blocks meet once: each leaves m, l and its f32 acc in its shared
//     memory, and after one cluster barrier rank s combines a slice of the
//     (g, hd) outputs from all S partials through distributed shared memory
//     (M = max m_s, w_s = l_s > 0 ? exp(m_s - M) : 0, l and acc summed in
//     rank order, out = acc / (l > 0 ? l : 1)); a second barrier keeps every
//     block's shared memory alive until it has been read.  No atomics: the
//     same inputs give the same bits on every launch.
// Math follows the reference: expf (not __expf), division by sqrt(hd)
// (passed in as the reference's f32 constant), fp32 throughout, one
// rounding to the output dtype at the store.  Only the association of the
// fp32 sums differs.
//
// paged_decode_q_kernel (int8 KV) replaces
//   src/repro/kernels/paged_attention.py::_q_kernel (pallas_call at :258),
// which replays attention.decode_attention_q: scores
// ((float)(q_i8.k_i8) * qs) * ks / sqrt(hd), m = their global max,
// l = sum exp(s-m), u = max exp(s-m)*vs, pscale = max(u/l, 1e-6)/127, the
// probabilities requantized pq = clip(rint(exp(s-m)/l*vs/pscale), +-127),
// an int32 pq.v_i8 accumulation, out = acc*pscale.  The cache stays int8.
// Bound on the H100: the live K and V bytes (+ their f32 row scales),
// about 150 KB at the serve shape, i.e. 0.3 us at 3.35 TB/s; the arithmetic
// is a few operations per byte.  What holds such a kernel is latency: m is
// needed before l and u, and pscale before any pq, so the TPU kernel walks
// the pages three times.  Design:
//   * one walk over the cluster split above (kernels/paged_attention._plan_q
//     adds whether the scores go to a device scratch buffer);
//   * each block reads its K rows once (16-byte loads), computes every
//     score once as an exact int32 dot (__dp4a, the hd chunks of a row on
//     adjacent lanes, summed by shuffles) and keeps the scores and V row
//     scales in shared memory (in a global scratch slice that the wrapper
//     allocates when a long range does not fit).  q (by cp.async), the
//     table entries, the first pass of K with its row scales and four
//     passes of V words all go out before anything waits, so at the serve
//     shape a block's reads cost about two round trips;
//   * the global max, then l and u, meet across the cluster through
//     distributed shared memory (one warp per head reads the S blocks'
//     partials; every block sums them in the same order, so all use the same
//     l and pscale), and exp(s-m) and pq are each computed once per
//     (head, row), in parallel;
//   * V is read once, one 4-byte word of a row per thread, as an int32 PV
//     over (head, dim) spread over all threads; the int32 partials meet
//     exactly in shared memory, then in rank 0's by distributed shared
//     memory atomics (integer: any order gives the same sum), and rank 0
//     writes acc*pscale after the third and last cluster barrier.
// Scores, m and u are bit-identical to the reference's; only the association
// of l differs.  Math follows the reference: expf (not __expf), division by
// sqrt(hd) (passed in as the reference's f32 constant), rintf (half to even,
// as jnp.round).
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kQThreads = 256;             // 8 warps
constexpr int kQWarps = kQThreads / 32;
constexpr int kVDepth = 4;                 // passes of V words in flight

struct QArgs {
  const int8_t* q;       // (B, H, hd)
  const float* qs;       // (B, H)
  const int8_t* kp;      // (P, ps, Hkv, hd)
  const float* ksp;      // (P, ps, Hkv)
  const int8_t* vp;
  const float* vsp;
  const int* tables;     // (B, max_pages)
  const int* n_pages;    // (B,)
  const int* lengths;    // (B,)
  void* out;             // (B, H, hd) f32 or bf16
  float* scratch;        // scores past shared memory, or null
  int H, Hkv, hd, ps, max_pages, pps;
  int kvec, vvec;        // 16-byte K loads / 4-byte V loads allowed
  float div;
};

__device__ __forceinline__ int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// 16 bytes of a K row from byte c16, zero past hd
__device__ __forceinline__ uint4 k_chunk(const int8_t* row, int c16, int hd,
                                         bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + c16));
  uint32_t u[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && c16 + i < hd; ++i)
    u[i >> 2] |= (uint32_t)(uint8_t)row[c16 + i] << (8 * (i & 3));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// 4 bytes of a V row from byte d4, zero past hd
__device__ __forceinline__ uint32_t v_word(const int8_t* row, int d4, int hd,
                                           bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + d4));
  uint32_t u = 0u;
  for (int i = 0; i < 4 && d4 + i < hd; ++i)
    u |= (uint32_t)(uint8_t)row[d4 + i] << (8 * i);
  return u;
}

__device__ __forceinline__ int dp4a16(uint4 a, uint4 b, int c) {
  c = __dp4a((int)a.x, (int)b.x, c);
  c = __dp4a((int)a.y, (int)b.y, c);
  c = __dp4a((int)a.z, (int)b.z, c);
  return __dp4a((int)a.w, (int)b.w, c);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename TO, int GM>
__global__ void __launch_bounds__(kQThreads)
paged_decode_q_kernel(const QArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x, s = blockIdx.x;   // the cluster spans x: rank s
  const int h = blockIdx.y, b = blockIdx.z, g = a.H / a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = a.hd, ps = a.ps, rb = a.pps * ps;   // rows a block may own
  const int nc = (hd + 15) / 16, ncp = pow2_at_least(nc);
  const int nw = (hd + 3) / 4, nwp = pow2_at_least(nw);
  const int qld = ncp * 16;

  extern __shared__ __align__(16) unsigned char qsmem[];
  int8_t* q_s = reinterpret_cast<int8_t*>(qsmem);                 // (g, qld)
  float* qs_s = reinterpret_cast<float*>(qsmem + g * qld);          // (g,)
  float* m_blk = qs_s + g;       // this block's partials, read by the cluster
  float* l_blk = m_blk + g;
  float* u_blk = l_blk + g;
  float* ps_s = u_blk + g;       // pscale
  int* acc_s = reinterpret_cast<int*>(ps_s + g + ((-5 * g) & 3));  // (g, hd)
  float* sc = a.scratch          // (g, rb) scores, then exp(s-m), then pq
      ? a.scratch + (((size_t)b * a.Hkv + h) * S + s) * (size_t)(g + 1) * rb
      : reinterpret_cast<float*>(acc_s + g * hd);
  float* vs_s = sc + (size_t)g * rb;                                // (rb,)

  // q goes global -> shared first (16-byte cp.async where hd allows), so
  // its latency hides behind the loads below; the lengths and the table
  // entries of this block's first rows go out together: the entries are
  // read whatever the length (they are inside the table) and used only for
  // rows below it
  const int8_t* qg = a.q + ((size_t)b * a.H + (size_t)h * g) * hd;
  const bool qvec = hd % 16 == 0 && (reinterpret_cast<uintptr_t>(qg) & 15) == 0;
  if (qvec) {
    for (int i = tid; i < g * qld / 16; i += kQThreads) {
      const int gi = i / (qld / 16), c16 = 16 * (i % (qld / 16));
      int8_t* dst = q_s + gi * qld + c16;
      if (c16 < hd) {
        const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
                     "l"(qg + gi * hd + c16)
                     : "memory");
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int L = a.lengths[b], np = a.n_pages[b];
  const int j0 = s * a.pps;
  const int* trow = a.tables + (size_t)b * a.max_pages + j0;
  auto page_of = [&](int rl) {   // speculative: any page id inside the table
    return j0 + rl / ps < a.max_pages ? trow[rl / ps] : 0;
  };
  auto pool_row = [&](int pid, int rl) {   // (pid * ps + r) * Hkv + h
    return ((size_t)pid * ps + rl % ps) * a.Hkv + h;
  };

  // phase 1 mapping: ncp lanes per K row (chunk c), 256 / ncp rows a pass
  const int c = tid & (ncp - 1), rg1 = tid / ncp, rp1 = kQThreads / ncp;
  // PV mapping: one 4-byte V word (w4) of a row per thread, 256 / nwp rows
  // a pass, kVDepth passes of V words in flight
  const int w4 = tid & (nwp - 1), rg3 = tid / nwp, rp3 = kQThreads / nwp;
  const int pid_k = page_of(rg1);
  int pid_v[kVDepth];
#pragma unroll
  for (int i = 0; i < kVDepth; ++i) pid_v[i] = page_of(rg3 + i * rp3);

  const int n_eff = min(min(np, (L + ps - 1) / ps), a.max_pages);
  const int j1 = min(j0 + a.pps, n_eff);
  const int rows = j1 > j0 ? (j1 - j0) * ps : 0;
  const int passes1 = (rows + rp1 - 1) / rp1;
  auto load_k = [&](int rl, int pid, float& ks, float& vs) {
    if (rl >= rows) return make_uint4(0u, 0u, 0u, 0u);
    const size_t pr = pool_row(pid, rl);
    ks = a.ksp[pr];
    vs = a.vsp[pr];
    return c < nc ? k_chunk(a.kp + pr * hd, 16 * c, hd, a.kvec)
                  : make_uint4(0u, 0u, 0u, 0u);
  };
  auto load_v = [&](int rl, int pid) {
    return rl < rows && w4 < nw
        ? v_word(a.vp + pool_row(pid, rl) * hd, 4 * w4, hd, a.vvec) : 0u;
  };
  // every first load goes out before anything waits
  float ks_cur = 0.f, vs_cur = 0.f;
  uint4 k_cur = load_k(rg1, pid_k, ks_cur, vs_cur);
  uint32_t v_buf[kVDepth];
#pragma unroll
  for (int i = 0; i < kVDepth; ++i) v_buf[i] = load_v(rg3 + i * rp3, pid_v[i]);

  if (!qvec) {
    for (int i = tid; i < g * qld; i += kQThreads) {
      const int gi = i / qld, d = i % qld;
      q_s[i] = d < hd ? qg[gi * hd + d] : 0;
    }
  }
  for (int i = tid; i < g; i += kQThreads)
    qs_s[i] = a.qs[(size_t)b * a.H + (size_t)h * g + i];
  for (int i = tid; i < g * hd; i += kQThreads) acc_s[i] = 0;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // phase 1: every score once, as an exact int32 dot, masked past the length
  for (int p = 0; p < passes1; ++p) {
    const int rl = rg1 + p * rp1;
    float ks_nxt = 0.f, vs_nxt = 0.f;
    const uint4 k_nxt = p + 1 < passes1
        ? load_k(rl + rp1, page_of(rl + rp1), ks_nxt, vs_nxt)
        : make_uint4(0u, 0u, 0u, 0u);
    int part[GM];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      part[gi] = 0;
      if (gi < g)
        part[gi] = dp4a16(k_cur, *reinterpret_cast<const uint4*>(
                                     q_s + gi * qld + 16 * c), 0);
    }
    for (int o = ncp >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int gi = 0; gi < GM; ++gi)
        part[gi] += __shfl_xor_sync(0xffffffffu, part[gi], o);
    if (rl < rows) {
      const bool live = j0 * ps + rl < L;
#pragma unroll
      for (int gi = 0; gi < GM; ++gi)
        if (gi < g && (gi & (ncp - 1)) == c) {
          const float sv = (float)part[gi] * qs_s[gi] * ks_cur / a.div;
          sc[(size_t)gi * rb + rl] = live ? sv : -1e30f;
        }
      if (c == 0) vs_s[rl] = live ? vs_cur : 0.f;
    }
    k_cur = k_nxt;
    ks_cur = ks_nxt;
    vs_cur = vs_nxt;
  }
  __syncthreads();
  for (int gi = warp; gi < g; gi += kQWarps) {
    float mx = -INFINITY;
    for (int rl = lane; rl < rows; rl += 32) mx = fmaxf(mx, sc[(size_t)gi * rb + rl]);
    mx = warp_max(mx);
    if (lane == 0) m_blk[gi] = mx;
  }
  cluster.sync();   // 1: every block's max is out

  // phase 2: the global max, then exp(s-m) once per (head, row), l and u
  for (int gi = warp; gi < g; gi += kQWarps) {
    float m = lane < S ? *cluster.map_shared_rank(m_blk + gi, lane) : -INFINITY;
    m = warp_max(m);
    float l = 0.f, u = 0.f;
    for (int rl = lane; rl < rows; rl += 32) {
      const float e = expf(sc[(size_t)gi * rb + rl] - m);
      sc[(size_t)gi * rb + rl] = e;
      l += e;
      u = fmaxf(u, e * vs_s[rl]);
    }
    l = warp_sum(l);
    u = warp_max(u);
    if (lane == 0) {
      l_blk[gi] = l;
      u_blk[gi] = u;
    }
  }
  cluster.sync();   // 2: every block's l and u are out

  // phase 3: pscale, then pq once per (head, row)
  for (int gi = warp; gi < g; gi += kQWarps) {
    float l = lane < S ? *cluster.map_shared_rank(l_blk + gi, lane) : 0.f;
    float u = lane < S ? *cluster.map_shared_rank(u_blk + gi, lane) : 0.f;
    l = warp_sum(l);   // the same order in every block of the cluster
    u = warp_max(u);
    l = l > 0.f ? l : 1.f;   // no pages: zeros
    const float pscale = fmaxf(u / l, 1e-6f) / 127.0f;
    if (lane == 0) ps_s[gi] = pscale;
    for (int rl = lane; rl < rows; rl += 32) {
      const float pr = sc[(size_t)gi * rb + rl] / l * vs_s[rl];
      // pq replaces exp(s-m) in place, its bits stored as a float's
      sc[(size_t)gi * rb + rl] = __int_as_float(
          (int)fminf(fmaxf(rintf(pr / pscale), -127.f), 127.f));
    }
  }
  __syncthreads();

  // the int32 PV: V read once, a word of a row per thread
  int acc[GM][4];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[gi][e] = 0;
  for (int base = rg3; base < rows; base += kVDepth * rp3) {
    uint32_t v_nxt[kVDepth];
#pragma unroll
    for (int i = 0; i < kVDepth; ++i) {
      const int rn = base + (kVDepth + i) * rp3;
      v_nxt[i] = rn < rows ? load_v(rn, page_of(rn)) : 0u;
    }
#pragma unroll
    for (int i = 0; i < kVDepth; ++i) {
      const int rl = base + i * rp3;
      if (rl >= rows) break;
      int vb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vb[e] = (int)(int8_t)(v_buf[i] >> (8 * e));
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi >= g) break;
        const int pv = __float_as_int(sc[(size_t)gi * rb + rl]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][e] += pv * vb[e];
      }
    }
#pragma unroll
    for (int i = 0; i < kVDepth; ++i) v_buf[i] = v_nxt[i];
  }
  // the block's int32 partial in shared memory, then added exactly into
  // rank 0's by distributed shared memory atomics
  if (w4 < nw && rg3 < rows) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= g) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * w4 + e < hd) atomicAdd(acc_s + gi * hd + 4 * w4 + e, acc[gi][e]);
    }
  }
  if (s != 0 && rows > 0) {
    __syncthreads();
    int* acc0 = cluster.map_shared_rank(acc_s, 0);
    for (int i = tid; i < g * hd; i += kQThreads) atomicAdd(acc0 + i, acc_s[i]);
  }
  cluster.sync();   // 3: every partial is in rank 0; no block's shared
                    // memory is read after this, so the others may exit

  if (s == 0) {
    TO* out = static_cast<TO*>(a.out) + ((size_t)b * a.H + (size_t)h * g) * hd;
    for (int i = tid; i < g * hd; i += kQThreads)
      out[i] = from_f<TO>((float)acc_s[i] * ps_s[i / hd]);
  }
}

// Dynamic shared memory of a block: q, its scales, the partials and the
// int32 PV tile, then (without scratch) the scores and V row scales.
size_t q_smem_bytes(int g, int hd, int rb, bool scratch) {
  const int ncp = [&] { int p = 1; while (p < (hd + 15) / 16) p <<= 1; return p; }();
  size_t bytes = (size_t)g * ncp * 16 + 4 * (5 * g + ((-5 * g) & 3)) +
                 (size_t)4 * g * hd;
  if (!scratch) bytes += (size_t)4 * (g + 1) * rb;
  return bytes;
}

constexpr int kQSmemMax = 200 * 1024;   // the attribute set on the kernel

template <typename TO, int GM>
cudaError_t launch_q(const QArgs& a, int B, int S, size_t smem,
                     cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_q_kernel<TO, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kQSmemMax);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, a.Hkv, B);
  cfg.blockDim = dim3(kQThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = S;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, paged_decode_q_kernel<TO, GM>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

constexpr int kFpThreads = 128;            // 4 warps
constexpr int kFpWarps = kFpThreads / 32;
constexpr int kFpStages = 3;               // K/V tiles in the ring
constexpr int kFpHdMax = 256;
constexpr int kFpSmemMax = 200 * 1024;     // the attribute set on the kernel
constexpr int kFpQLoads = 8;               // q loads in flight per thread

struct FpArgs {
  const void* q;         // (B, H, hd) f32 | bf16
  const void* kp;        // (P, ps, Hkv, hd) f32 | bf16
  const void* vp;
  const int* tables;     // (B, max_pages)
  const int* n_pages;    // (B,)
  const int* lengths;    // (B,)
  void* out;             // (B, H, hd) in q's dtype
  int H, Hkv, hd, ps, max_pages, pps, tile;
  int kvec;              // 16-byte cp.async copies allowed
  float div;
};

// Byte offsets of a block's dynamic shared memory.  A K or V row holds nc
// 16-byte chunks of the KV dtype (hd rounded up) at a stride of nc | 1
// chunks: an odd stride puts the same chunk of 8 consecutive rows on 8
// different bank groups, so lanes reading one row each do not conflict.
struct FpSmem {
  size_t q;      // (g, nc * E) f32 queries, zero past hd
  size_t sc;     // (g, tile) f32 exp(s - m) of the tile's rows
  size_t stats;  // m, l, the combined l (16 each), the weights w (8 x 16)
  size_t acc;    // (g, hd) f32 partial accumulator, read by the cluster
  size_t tbl;    // (pps,) i32 table entries of the block's range
  size_t ring;   // kFpStages x {K, V} x (tile, (nc | 1) chunks)
  size_t total;
};

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) & ~(size_t)15; }

__host__ __device__ inline FpSmem fp_smem(int g, int hd, int isz, int tile,
                                          int pps) {
  const size_t nc = up16((size_t)hd * isz) / 16;
  FpSmem s;
  s.q = 0;
  s.sc = s.q + 4 * (size_t)g * nc * (16 / isz);
  s.stats = s.sc + 4 * (size_t)g * tile;
  s.acc = s.stats + 4 * (3 * 16 + 8 * 16);
  s.tbl = s.acc + up16(4 * (size_t)g * hd);
  s.ring = s.tbl + up16(4 * (size_t)pps);
  s.total = s.ring + (size_t)kFpStages * 2 * tile * (nc | 1) * 16;
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(src)
               : "memory");
}

// 16 (chunk) or 8 (PV unit) bytes of shared memory as floats
__device__ __forceinline__ void chunk_f(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void chunk_f(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unit_f(const float* p, float (&f)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void unit_f(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}

template <typename TQ, typename TKV, int GM>
__global__ void __launch_bounds__(kFpThreads)
paged_decode_kernel(const FpArgs a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int E = 16 / sizeof(TKV);      // elements of a 16-byte chunk
  constexpr int EU = 8 / sizeof(TKV);      // elements of an 8-byte PV unit
  constexpr int UL = kFpHdMax / (32 * EU); // PV units per lane at most
  constexpr int GW = GM / kFpWarps;        // heads per warp at most
  constexpr int RL = 2;                    // rows per lane at most (tile <= 64)
  const int S = gridDim.x, s = blockIdx.x;   // the cluster spans x: rank s
  const int h = blockIdx.y, b = blockIdx.z, g = a.H / a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hd = a.hd, ps = a.ps, T = a.tile;
  const int nc = (hd + E - 1) / E, ld = nc * E, lds = (nc | 1) * E;
  const int nu = (hd + EU - 1) / EU;         // PV units holding dims < hd
  const FpSmem lay = fp_smem(g, hd, sizeof(TKV), T, a.pps);
  extern __shared__ __align__(16) unsigned char fsmem[];
  float* q_s = reinterpret_cast<float*>(fsmem + lay.q);
  float* sc = reinterpret_cast<float*>(fsmem + lay.sc);
  float* m_s = reinterpret_cast<float*>(fsmem + lay.stats);
  float* l_s = m_s + 16;
  float* tot_s = l_s + 16;                   // combined l per head
  float* w_s = tot_s + 16;                   // (8, 16) combine weights
  float* acc_s = reinterpret_cast<float*>(fsmem + lay.acc);
  int* tbl_s = reinterpret_cast<int*>(fsmem + lay.tbl);
  TKV* ring = reinterpret_cast<TKV*>(fsmem + lay.ring);
  const size_t stage = (size_t)T * lds;      // elements of one K or V tile
  const TKV* kp = static_cast<const TKV*>(a.kp);
  const TKV* vp = static_cast<const TKV*>(a.vp);

  // first round trip: the length, n_pages, the block's table entries and
  // q all go out before anything waits
  const int L = a.lengths[b], np = a.n_pages[b];
  const int j0 = s * a.pps;
  const int* trow = a.tables + (size_t)b * a.max_pages + j0;
  for (int i = tid; i < a.pps; i += kFpThreads)
    tbl_s[i] = j0 + i < a.max_pages ? trow[i] : 0;
  const TQ* qg = static_cast<const TQ*>(a.q) + ((size_t)b * a.H + (size_t)h * g) * hd;
  for (int i0 = 0; i0 < g * ld; i0 += kFpQLoads * kFpThreads) {
    float qv[kFpQLoads];         // all loads of a batch before its stores
#pragma unroll
    for (int u = 0; u < kFpQLoads; ++u) {
      const int i = i0 + u * kFpThreads + tid, gi = i / ld, d = i - gi * ld;
      qv[u] = i < g * ld && d < hd ? to_f(qg[gi * hd + d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kFpQLoads; ++u) {
      const int i = i0 + u * kFpThreads + tid;
      if (i < g * ld) q_s[i] = qv[u];
    }
  }
  // the block's rows: the live rows (below the length) of its walked pages
  const int n_eff = min(min(np, (L + ps - 1) / ps), a.max_pages);
  const int j1 = min(j0 + a.pps, n_eff);
  const int rows = j1 > j0 ? min((j1 - j0) * ps, L - j0 * ps) : 0;
  const int ntiles = (rows + T - 1) / T;
  __syncthreads();

  // tile t of the block's rows -> ring stage t % kFpStages, one commit
  // group: cpr threads a row (adjacent 16-byte chunks, two rows' K or V
  // per warp instruction at hd 128 bf16), rows r1, r1 + rstep, ... of the
  // tile, their pages followed without a division per row
  int cpr = 1;
  while (cpr < nc && cpr < 32) cpr <<= 1;
  const int c0 = tid & (cpr - 1), r1 = tid / cpr, rstep = kFpThreads / cpr;
  auto issue = [&](int t) {
    if (t < ntiles) {
      TKV* ks = ring + (size_t)(t % kFpStages) * 2 * stage;
      TKV* vs = ks + stage;
      const int r0 = t * T, tr = min(T, rows - r0);
      int pg = (r0 + r1) / ps, rp = r0 + r1 - pg * ps;
      for (int r = r1; r < tr; r += rstep) {
        const size_t off = (((size_t)tbl_s[pg] * ps + rp) * a.Hkv + h) * hd;
        if (a.kvec) {
          for (int c = c0; c < nc; c += cpr) {
            cp_async16(ks + r * lds + c * E, kp + off + c * E);
            cp_async16(vs + r * lds + c * E, vp + off + c * E);
          }
        } else {
          for (int d = c0; d < ld; d += cpr) {
            ks[r * lds + d] = d < hd ? kp[off + d] : from_f<TKV>(0.f);
            vs[r * lds + d] = d < hd ? vp[off + d] : from_f<TKV>(0.f);
          }
        }
        for (rp += rstep; rp >= ps; rp -= ps) ++pg;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int t = 0; t < kFpStages - 1; ++t) issue(t);

  // warp w serves heads w, w + 4, ...: their running m and l (the same in
  // every lane) and the dims of PV units lane, lane + 32, ... of their acc
  float m_r[GW], l_r[GW], acc[GW][UL][EU];
#pragma unroll
  for (int k = 0; k < GW; ++k) {
    m_r[k] = -INFINITY;
    l_r[k] = 0.f;
#pragma unroll
    for (int j = 0; j < UL; ++j)
#pragma unroll
      for (int e = 0; e < EU; ++e) acc[k][j][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFpStages - 2) : "memory");
    __syncthreads();   // tile t is in; nobody reads tile t - 1's stage now
    issue(t + kFpStages - 1);
    const TKV* ks = ring + (size_t)(t % kFpStages) * 2 * stage;
    const TKV* vs = ks + stage;
    const int tr = min(T, rows - t * T);

    // every score once: a lane per row, its heads' dots over the row's
    // chunks (q broadcast from shared memory), two partial sums each
    float sr[GW][RL];
#pragma unroll
    for (int rr = 0; rr < RL; ++rr) {
      const int r = lane + 32 * rr;
      float pa[GW], pb[GW];
#pragma unroll
      for (int k = 0; k < GW; ++k) pa[k] = pb[k] = 0.f;
      if (32 * rr < tr && warp < g) {
        const TKV* krow = ks + (r < tr ? r : 0) * lds;
#pragma unroll 4
        for (int c = 0; c < nc; ++c) {
          float kf[E];
          chunk_f(krow + c * E, kf);
#pragma unroll
          for (int k = 0; k < GW; ++k) {
            const int gi = warp + kFpWarps * k;
            if (gi >= g) break;
            const float4* qc = reinterpret_cast<const float4*>(q_s + gi * ld + c * E);
#pragma unroll
            for (int e4 = 0; e4 < E / 4; ++e4) {
              const float4 q4 = qc[e4];
              float& p = (e4 & 1) ? pb[k] : pa[k];
              p = fmaf(q4.x, kf[4 * e4], p);
              p = fmaf(q4.y, kf[4 * e4 + 1], p);
              p = fmaf(q4.z, kf[4 * e4 + 2], p);
              p = fmaf(q4.w, kf[4 * e4 + 3], p);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < GW; ++k)
        sr[k][rr] = r < tr ? (pa[k] + pb[k]) / a.div : -INFINITY;
    }

    // exp(s - m) once per (head, row), then acc = acc * corr + p.V with V
    // read once per warp for all of its heads
#pragma unroll
    for (int k = 0; k < GW; ++k) {
      const int gi = warp + kFpWarps * k;
      if (gi >= g) break;
      float mx = fmaxf(sr[k][0], sr[k][1]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[k], mx);
      float sum = 0.f;
#pragma unroll
      for (int rr = 0; rr < RL; ++rr) {
        const float e = expf(sr[k][rr] - m_new);   // 0 past the tile
        if (lane + 32 * rr < T) sc[gi * T + lane + 32 * rr] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float corr = expf(m_r[k] - m_new);
      l_r[k] = l_r[k] * corr + sum;
      m_r[k] = m_new;
#pragma unroll
      for (int j = 0; j < UL; ++j)
#pragma unroll
        for (int e = 0; e < EU; ++e) acc[k][j][e] *= corr;
    }
    __syncwarp();
    float pv[GW][UL][EU];
#pragma unroll
    for (int k = 0; k < GW; ++k)
#pragma unroll
      for (int j = 0; j < UL; ++j)
#pragma unroll
        for (int e = 0; e < EU; ++e) pv[k][j][e] = 0.f;
    if (warp < g) {
#pragma unroll 4
      for (int r = 0; r < tr; ++r) {
        float vf[UL][EU];
#pragma unroll
        for (int j = 0; j < UL; ++j) {
          const int u = lane + 32 * j;
          if (u < nu) unit_f(vs + r * lds + u * EU, vf[j]);
        }
#pragma unroll
        for (int k = 0; k < GW; ++k) {
          const int gi = warp + kFpWarps * k;
          if (gi >= g) break;
          const float p = sc[gi * T + r];
#pragma unroll
          for (int j = 0; j < UL; ++j)
            if (lane + 32 * j < nu)
#pragma unroll
              for (int e = 0; e < EU; ++e) pv[k][j][e] = fmaf(p, vf[j][e], pv[k][j][e]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < GW; ++k)
#pragma unroll
      for (int j = 0; j < UL; ++j)
#pragma unroll
        for (int e = 0; e < EU; ++e) acc[k][j][e] += pv[k][j][e];
  }

  // the block's partial (m, l, acc) in its shared memory
#pragma unroll
  for (int k = 0; k < GW; ++k) {
    const int gi = warp + kFpWarps * k;
    if (gi >= g) break;
    if (lane == 0) {
      m_s[gi] = m_r[k];
      l_s[gi] = l_r[k];
    }
#pragma unroll
    for (int j = 0; j < UL; ++j)
#pragma unroll
      for (int e = 0; e < EU; ++e) {
        const int d = (lane + 32 * j) * EU + e;
        if (d < hd) acc_s[gi * hd + d] = acc[k][j][e];
      }
  }
  cluster.sync();   // 1: every block's partial is out

  // one thread per head: the S blocks' weights, and l
  if (tid < g) {
    float ms[8], ls[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      ms[r] = r < S ? *cluster.map_shared_rank(m_s + tid, r) : -INFINITY;
      ls[r] = r < S ? *cluster.map_shared_rank(l_s + tid, r) : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < 8; ++r) M = fmaxf(M, ms[r]);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float w = ls[r] > 0.f ? expf(ms[r] - M) : 0.f;
      w_s[r * 16 + tid] = w;
      l += w * ls[r];              // rank order
    }
    tot_s[tid] = l > 0.f ? l : 1.f;   // no pages: zeros
  }
  __syncthreads();
  // rank s writes its slice of the (g, hd) outputs, summing in rank order
  const int n_out = g * hd, per = (n_out + S - 1) / S;
  TQ* out = static_cast<TQ*>(a.out) + ((size_t)b * a.H + (size_t)h * g) * hd;
  for (int i = s * per + tid; i < min(n_out, (s + 1) * per); i += kFpThreads) {
    const int gi = i / hd;
    float part[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      part[r] = r < S ? *cluster.map_shared_rank(acc_s + i, r) : 0.f;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) v += w_s[r * 16 + gi] * part[r];
    out[i] = from_f<TQ>(v / tot_s[gi]);
  }
  cluster.sync();   // 2: no block leaves while its partial may be read
}

template <typename TQ, typename TKV, int GM>
cudaError_t launch_fp(const FpArgs& a, int B, int S, size_t smem,
                      cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, TKV, GM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kFpSmemMax);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, a.Hkv, B);
  cfg.blockDim = dim3(kFpThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = S;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, paged_decode_kernel<TQ, TKV, GM>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_fp_g(const FpArgs& a, int B, int S, size_t smem,
                        cudaStream_t st) {
  return a.H / a.Hkv <= 4 ? launch_fp<TQ, TKV, 4>(a, B, S, smem, st)
                          : launch_fp<TQ, TKV, 16>(a, B, S, smem, st);
}

template <typename TQ, typename TKV>
const void* fp_kernel(int g_large) {
  return g_large ? (const void*)paged_decode_kernel<TQ, TKV, 16>
                 : (const void*)paged_decode_kernel<TQ, TKV, 4>;
}

}  // namespace

// q (B,H,hd) f32|bf16; k/v pools (P,ps,Hkv,hd) f32|bf16; tables (B,max_pages)
// i32; n_pages, lengths (B,) i32; out (B,H,hd) in q's dtype.  H/Hkv <= 16,
// hd <= 256 (checked by the wrapper).  The S blocks of a cluster each own
// pps consecutive pages of the table (S <= 8, S * pps >= max_pages); K and
// V stream through the ring in tiles of `tile` rows.  Returns the launch's
// cudaError_t.
extern "C" int paged_decode_launch(const void* q, const void* k, const void* v,
                                   const void* tables, const void* n_pages,
                                   const void* lengths, void* out, int B, int H,
                                   int Hkv, int hd, int ps, int max_pages,
                                   int splits, int pps, int tile, int q_bf16,
                                   int kv_bf16, float div, void* stream) {
  if (splits < 1 || splits > 8 || pps < 1 || splits * pps < max_pages ||
      tile < 16 || tile > 64 || tile % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int isz = kv_bf16 ? 2 : 4;
  const size_t smem = fp_smem(H / Hkv, hd, isz, tile, pps).total;
  if (smem > (size_t)kFpSmemMax) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const FpArgs a{q, k, v, static_cast<const int*>(tables),
                 static_cast<const int*>(n_pages),
                 static_cast<const int*>(lengths), out, H, Hkv, hd, ps,
                 max_pages, pps, tile,
                 (hd * isz) % 16 == 0 && aligned(k) && aligned(v), div};
  cudaError_t err;
  if (q_bf16 && kv_bf16)
    err = launch_fp_g<__nv_bfloat16, __nv_bfloat16>(a, B, splits, smem, st);
  else if (q_bf16)
    err = launch_fp_g<__nv_bfloat16, float>(a, B, splits, smem, st);
  else if (kv_bf16)
    err = launch_fp_g<float, __nv_bfloat16>(a, B, splits, smem, st);
  else
    err = launch_fp_g<float, float>(a, B, splits, smem, st);
  return (int)err;
}

// q (B,H,hd) int8 + qs (B,H) f32; k/v pools (P,ps,Hkv,hd) int8 with
// (P,ps,Hkv) f32 row scales; out (B,H,hd) f32|bf16.  The S blocks of a
// cluster each own pps consecutive pages of the table (S <= 8, S * pps >=
// max_pages).  scratch: null, or (B, Hkv, S, g + 1, pps * ps) f32 for the
// scores and V row scales that do not fit in shared memory.
extern "C" int paged_decode_q_launch(const void* q, const void* qs,
                                     const void* k, const void* ks,
                                     const void* v, const void* vs,
                                     const void* tables, const void* n_pages,
                                     const void* lengths, void* out,
                                     void* scratch, int B, int H, int Hkv,
                                     int hd, int ps, int max_pages, int splits,
                                     int pps, int out_bf16, float div,
                                     void* stream) {
  if (splits < 1 || splits > 8 || pps < 1 || splits * pps < max_pages)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = H / Hkv;
  const size_t smem = q_smem_bytes(g, hd, pps * ps, scratch != nullptr);
  if (smem > (size_t)kQSmemMax) return (int)cudaErrorInvalidValue;
  auto aligned = [](const void* p, uintptr_t n) {
    return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
  };
  const QArgs a{static_cast<const int8_t*>(q), static_cast<const float*>(qs),
                static_cast<const int8_t*>(k), static_cast<const float*>(ks),
                static_cast<const int8_t*>(v), static_cast<const float*>(vs),
                static_cast<const int*>(tables), static_cast<const int*>(n_pages),
                static_cast<const int*>(lengths), out,
                static_cast<float*>(scratch), H, Hkv, hd, ps, max_pages, pps,
                hd % 16 == 0 && aligned(k, 16), hd % 4 == 0 && aligned(v, 4),
                div};
  cudaError_t err;
  if (out_bf16)
    err = g <= 4 ? launch_q<__nv_bfloat16, 4>(a, B, splits, smem, st)
                 : launch_q<__nv_bfloat16, 16>(a, B, splits, smem, st);
  else
    err = g <= 4 ? launch_q<float, 4>(a, B, splits, smem, st)
                 : launch_q<float, 16>(a, B, splits, smem, st);
  return (int)err;
}

// The int8 kernel's build for out dtype (f32/bf16) and group size class:
// out[0] registers per thread, out[1] local (spill) bytes per thread,
// out[2] the dynamic shared memory attribute, out[3] threads per block.
extern "C" int paged_decode_q_info(int out_bf16, int g_large, void* out) {
  cudaFuncAttributes attr;
  const void* fn =
      out_bf16 ? (g_large ? (const void*)paged_decode_q_kernel<__nv_bfloat16, 16>
                          : (const void*)paged_decode_q_kernel<__nv_bfloat16, 4>)
               : (g_large ? (const void*)paged_decode_q_kernel<float, 16>
                          : (const void*)paged_decode_q_kernel<float, 4>);
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int* o = static_cast<int*>(out);
  o[0] = attr.numRegs;
  o[1] = (int)attr.localSizeBytes;
  o[2] = kQSmemMax;
  o[3] = kQThreads;
  return 0;
}

// The fp kernel's build for q dtype, KV dtype (f32/bf16) and group size
// class: out[0] registers per thread, out[1] local (spill) bytes per thread,
// out[2] the dynamic shared memory attribute, out[3] threads per block.
extern "C" int paged_decode_info(int q_bf16, int kv_bf16, int g_large,
                                 void* out) {
  cudaFuncAttributes attr;
  const void* fn =
      q_bf16 ? (kv_bf16 ? fp_kernel<__nv_bfloat16, __nv_bfloat16>(g_large)
                        : fp_kernel<__nv_bfloat16, float>(g_large))
             : (kv_bf16 ? fp_kernel<float, __nv_bfloat16>(g_large)
                        : fp_kernel<float, float>(g_large));
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int* o = static_cast<int*>(out);
  o[0] = attr.numRegs;
  o[1] = (int)attr.localSizeBytes;
  o[2] = kFpSmemMax;
  o[3] = kFpThreads;
  return 0;
}
