// Paged-KV decode attention for Hopper (sm_90a): block-table walks, no gather.
//
// paged_decode_kernel replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::_fp_kernel (pallas_call at :214);
// paged_decode_q_kernel replaces
//   src/repro/kernels/paged_attention.py::_q_kernel (pallas_call at :258).
//
// Both compute Sq=1 GQA decode attention straight off the shared page pool
// (P, page_size, Hkv, hd), walking only the min(n_pages, ceil(len/ps))
// pages a sequence owns, never max_seq rows:
//   * fp: fp32 scores q.k / sqrt(hd), rows >= len masked to -1e30, online
//     softmax (running max, normalizer, rescaled accumulator); a sequence
//     with no pages emits zeros;
//   * int8: the three page walks of the TPU kernel, which replay
//     attention.decode_attention_q — (1) the global max of
//     (q_i8.k_i8)*qs*ks/sqrt(hd); (2) l = sum exp(s-m) and
//     u = max(exp(s-m)*vs), pscale = max(u/l, 1e-6)/127; (3) probabilities
//     requantized pq = clip(rint(exp(s-m)/l*vs/pscale), +-127) and an int32
//     pq.v_i8 accumulation, out = acc*pscale.  The cache stays int8: no fp
//     copy of the pool is ever made.
//
// Bound on the H100: the live KV bytes, sum_b ceil(len_b/ps)*ps * Hkv * hd
// * 2 * itemsize (+ the f32 row scales for int8), over 3.35 TB/s; the
// arithmetic is a few FLOPs per byte.  Design: the grid is (sequence, KV
// head) rather than the TPU's one program per sequence, so B*Hkv blocks
// stream independent KV slices; each block loads its own table row, reads
// one (ps, hd) K and V slice of its head per page (contiguous hd-element
// rows, coalesced across threads) and serves the H/Hkv query heads of its
// group from that one read.  Math follows the reference: expf (not
// __expf), division by sqrt(hd) (passed in from the host as the reference's
// f32 constant), rintf (half to even, as jnp.round).  Later work: split the
// page walk across blocks for long sequences (flash-decoding) and
// cp.async/TMA double buffering of the page slices.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;              // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHdMax = 256;
constexpr int kDpt = kHdMax / kThreads;    // head dims per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
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
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TQ, typename TKV, int GM>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                    const TKV* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ n_pages,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int Hkv, int hd, int ps, int max_pages, float div) {
  const int b = blockIdx.x, h = blockIdx.y, g = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ float smem[];
  float* q_s = smem;               // (g, hd)
  float* s_s = smem + g * hd;      // (g, ps) masked scores of one page
  const size_t q_off = ((size_t)b * H + (size_t)h * g) * hd;
  for (int i = tid; i < g * hd; i += kThreads) q_s[i] = to_f(q[q_off + i]);
  const int L = lengths[b];
  const int n_eff = min(n_pages[b], (L + ps - 1) / ps);

  float m[GM], l[GM], acc[GM][kDpt];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int di = 0; di < kDpt; ++di) acc[gi][di] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < n_eff; ++j) {
    const int pid = tables[(size_t)b * max_pages + j];
    for (int r = warp; r < ps; r += kWarps) {
      const TKV* krow = kp + (((size_t)pid * ps + r) * Hkv + h) * hd;
      for (int gi = 0; gi < g; ++gi) {
        float part = 0.f;
        for (int d = lane; d < hd; d += 32) part += q_s[gi * hd + d] * to_f(krow[d]);
        part = warp_sum(part);
        if (lane == 0) s_s[gi * ps + r] = (j * ps + r < L) ? part / div : -1e30f;
      }
    }
    __syncthreads();
    float mn[GM], corr[GM], psum[GM], pv[GM][kDpt];
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= g) break;
      float mx = -INFINITY;
      for (int r = 0; r < ps; ++r) mx = fmaxf(mx, s_s[gi * ps + r]);
      mn[gi] = fmaxf(m[gi], mx);
      corr[gi] = expf(m[gi] - mn[gi]);
      psum[gi] = 0.f;
#pragma unroll
      for (int di = 0; di < kDpt; ++di) pv[gi][di] = 0.f;
    }
    for (int r = 0; r < ps; ++r) {
      const TKV* vrow = vp + (((size_t)pid * ps + r) * Hkv + h) * hd;
      float vv[kDpt];
#pragma unroll
      for (int di = 0; di < kDpt; ++di) {
        const int d = tid + di * kThreads;
        vv[di] = d < hd ? to_f(vrow[d]) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi >= g) break;
        const float p = expf(s_s[gi * ps + r] - mn[gi]);
        psum[gi] += p;
#pragma unroll
        for (int di = 0; di < kDpt; ++di) pv[gi][di] += p * vv[di];
      }
    }
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= g) break;
      l[gi] = l[gi] * corr[gi] + psum[gi];
#pragma unroll
      for (int di = 0; di < kDpt; ++di) acc[gi][di] = acc[gi][di] * corr[gi] + pv[gi][di];
      m[gi] = mn[gi];
    }
    __syncthreads();
  }
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    if (gi >= g) break;
    const float denom = l[gi] > 0.f ? l[gi] : 1.f;   // no pages: zeros
#pragma unroll
    for (int di = 0; di < kDpt; ++di) {
      const int d = tid + di * kThreads;
      if (d < hd) out[q_off + (size_t)gi * hd + d] = from_f<TQ>(acc[gi][di] / denom);
    }
  }
}

// Masked fp32 scores of page j for every query head of the group, exactly
// as the reference: ((float(q_i8.k_i8) * qs) * ks) / sqrt(hd); also stages
// the page's V row scales.
__device__ __forceinline__ void q_page_scores(
    const int* q_s, const float* qsv, const int8_t* __restrict__ kp,
    const float* __restrict__ ksp, const float* __restrict__ vsp, float* s_s,
    float* vs_s, int pid, int j, int L, int g, int h, int Hkv, int hd, int ps,
    float div, int lane, int warp) {
  for (int r = warp; r < ps; r += kWarps) {
    const size_t row = ((size_t)pid * ps + r) * Hkv + h;
    const int8_t* krow = kp + row * hd;
    const float ks = ksp[row];
    for (int gi = 0; gi < g; ++gi) {
      int part = 0;
      for (int d = lane; d < hd; d += 32) part += q_s[gi * hd + d] * (int)krow[d];
      part = warp_sum(part);
      if (lane == 0) {
        const float s = (float)part * qsv[gi] * ks / div;
        s_s[gi * ps + r] = (j * ps + r < L) ? s : -1e30f;
      }
    }
    if (lane == 0) vs_s[r] = vsp[row];
  }
}

template <typename TO, int GM>
__global__ void __launch_bounds__(kThreads)
paged_decode_q_kernel(const int8_t* __restrict__ q, const float* __restrict__ qs,
                      const int8_t* __restrict__ kp, const float* __restrict__ ksp,
                      const int8_t* __restrict__ vp, const float* __restrict__ vsp,
                      const int* __restrict__ tables, const int* __restrict__ n_pages,
                      const int* __restrict__ lengths, TO* __restrict__ out,
                      int H, int Hkv, int hd, int ps, int max_pages, float div) {
  const int b = blockIdx.x, h = blockIdx.y, g = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ int qsmem[];
  int* q_s = qsmem;                                        // (g, hd)
  float* qsv = reinterpret_cast<float*>(qsmem + g * hd);   // (g,)
  float* s_s = qsv + g;                                    // (g, ps)
  float* vs_s = s_s + g * ps;                              // (ps,)
  const size_t q_off = ((size_t)b * H + (size_t)h * g) * hd;
  for (int i = tid; i < g * hd; i += kThreads) q_s[i] = (int)q[q_off + i];
  for (int i = tid; i < g; i += kThreads) qsv[i] = qs[(size_t)b * H + (size_t)h * g + i];
  const int L = lengths[b];
  const int n_eff = min(n_pages[b], (L + ps - 1) / ps);
  const int* trow = tables + (size_t)b * max_pages;
  __syncthreads();

  // walk 1: global max of the masked scores
  float m[GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) m[gi] = -INFINITY;
  for (int j = 0; j < n_eff; ++j) {
    q_page_scores(q_s, qsv, kp, ksp, vsp, s_s, vs_s, trow[j], j, L, g, h, Hkv,
                  hd, ps, div, lane, warp);
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= g) break;
      for (int r = 0; r < ps; ++r) m[gi] = fmaxf(m[gi], s_s[gi * ps + r]);
    }
    __syncthreads();
  }
  // walk 2: normalizer and the probability row's quantization scale
  float l[GM], u[GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) { l[gi] = 0.f; u[gi] = 0.f; }
  for (int j = 0; j < n_eff; ++j) {
    q_page_scores(q_s, qsv, kp, ksp, vsp, s_s, vs_s, trow[j], j, L, g, h, Hkv,
                  hd, ps, div, lane, warp);
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi >= g) break;
      float psum = 0.f;
      for (int r = 0; r < ps; ++r) {
        const float p = expf(s_s[gi * ps + r] - m[gi]);
        psum += p;
        u[gi] = fmaxf(u[gi], p * vs_s[r]);
      }
      l[gi] += psum;
    }
    __syncthreads();
  }
  float pscale[GM];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    if (gi >= g) break;
    l[gi] = l[gi] > 0.f ? l[gi] : 1.f;   // no pages: zeros
    pscale[gi] = fmaxf(u[gi] / l[gi], 1e-6f) / 127.0f;
  }
  // walk 3: requantized probabilities, integer PV accumulation
  int acc[GM][kDpt];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi)
#pragma unroll
    for (int di = 0; di < kDpt; ++di) acc[gi][di] = 0;
  for (int j = 0; j < n_eff; ++j) {
    const int pid = trow[j];
    q_page_scores(q_s, qsv, kp, ksp, vsp, s_s, vs_s, pid, j, L, g, h, Hkv,
                  hd, ps, div, lane, warp);
    __syncthreads();
    for (int r = 0; r < ps; ++r) {
      const int8_t* vrow = vp + (((size_t)pid * ps + r) * Hkv + h) * hd;
      int vv[kDpt];
#pragma unroll
      for (int di = 0; di < kDpt; ++di) {
        const int d = tid + di * kThreads;
        vv[di] = d < hd ? (int)vrow[d] : 0;
      }
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi >= g) break;
        const float p = expf(s_s[gi * ps + r] - m[gi]) / l[gi] * vs_s[r];
        const int pq = (int)fminf(fmaxf(rintf(p / pscale[gi]), -127.f), 127.f);
#pragma unroll
        for (int di = 0; di < kDpt; ++di) acc[gi][di] += pq * vv[di];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) {
    if (gi >= g) break;
#pragma unroll
    for (int di = 0; di < kDpt; ++di) {
      const int d = tid + di * kThreads;
      if (d < hd) out[q_off + (size_t)gi * hd + d] = from_f<TO>((float)acc[gi][di] * pscale[gi]);
    }
  }
}

template <typename TQ, typename TKV>
void launch_fp(dim3 grid, size_t smem, cudaStream_t st, int g, const void* q,
               const void* k, const void* v, const int* tables,
               const int* n_pages, const int* lengths, void* out, int H,
               int Hkv, int hd, int ps, int max_pages, float div) {
  auto args = [&](auto kern) {
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const TQ*>(q), static_cast<const TKV*>(k),
        static_cast<const TKV*>(v), tables, n_pages, lengths,
        static_cast<TQ*>(out), H, Hkv, hd, ps, max_pages, div);
  };
  if (g <= 4) args(paged_decode_kernel<TQ, TKV, 4>);
  else args(paged_decode_kernel<TQ, TKV, 16>);
}

template <typename TO>
void launch_q(dim3 grid, size_t smem, cudaStream_t st, int g, const void* q,
              const void* qs, const void* k, const void* ks, const void* v,
              const void* vs, const int* tables, const int* n_pages,
              const int* lengths, void* out, int H, int Hkv, int hd, int ps,
              int max_pages, float div) {
  auto args = [&](auto kern) {
    kern<<<grid, kThreads, smem, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(qs),
        static_cast<const int8_t*>(k), static_cast<const float*>(ks),
        static_cast<const int8_t*>(v), static_cast<const float*>(vs), tables,
        n_pages, lengths, static_cast<TO*>(out), H, Hkv, hd, ps, max_pages, div);
  };
  if (g <= 4) args(paged_decode_q_kernel<TO, 4>);
  else args(paged_decode_q_kernel<TO, 16>);
}

}  // namespace

// q (B,H,hd) f32|bf16; k/v pools (P,ps,Hkv,hd) f32|bf16; tables (B,max_pages)
// i32; n_pages, lengths (B,) i32; out (B,H,hd) in q's dtype.  H/Hkv <= 16,
// hd <= 256 (checked by the wrapper).  Returns cudaGetLastError().
extern "C" int paged_decode_launch(const void* q, const void* k, const void* v,
                                   const void* tables, const void* n_pages,
                                   const void* lengths, void* out, int B, int H,
                                   int Hkv, int hd, int ps, int max_pages,
                                   int q_bf16, int kv_bf16, float div,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = H / Hkv;
  dim3 grid(B, Hkv);
  const size_t smem = (size_t)(g * hd + g * ps) * sizeof(float);
  const auto* t = static_cast<const int*>(tables);
  const auto* n = static_cast<const int*>(n_pages);
  const auto* len = static_cast<const int*>(lengths);
  if (q_bf16 && kv_bf16)
    launch_fp<__nv_bfloat16, __nv_bfloat16>(grid, smem, st, g, q, k, v, t, n, len, out, H, Hkv, hd, ps, max_pages, div);
  else if (q_bf16)
    launch_fp<__nv_bfloat16, float>(grid, smem, st, g, q, k, v, t, n, len, out, H, Hkv, hd, ps, max_pages, div);
  else if (kv_bf16)
    launch_fp<float, __nv_bfloat16>(grid, smem, st, g, q, k, v, t, n, len, out, H, Hkv, hd, ps, max_pages, div);
  else
    launch_fp<float, float>(grid, smem, st, g, q, k, v, t, n, len, out, H, Hkv, hd, ps, max_pages, div);
  return (int)cudaGetLastError();
}

// q (B,H,hd) int8 + qs (B,H) f32; k/v pools (P,ps,Hkv,hd) int8 with
// (P,ps,Hkv) f32 row scales; out (B,H,hd) f32|bf16.
extern "C" int paged_decode_q_launch(const void* q, const void* qs,
                                     const void* k, const void* ks,
                                     const void* v, const void* vs,
                                     const void* tables, const void* n_pages,
                                     const void* lengths, void* out, int B,
                                     int H, int Hkv, int hd, int ps,
                                     int max_pages, int out_bf16, float div,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int g = H / Hkv;
  dim3 grid(B, Hkv);
  const size_t smem = (size_t)(g * hd) * sizeof(int) + (size_t)(g + g * ps + ps) * sizeof(float);
  const auto* t = static_cast<const int*>(tables);
  const auto* n = static_cast<const int*>(n_pages);
  const auto* len = static_cast<const int*>(lengths);
  if (out_bf16)
    launch_q<__nv_bfloat16>(grid, smem, st, g, q, qs, k, ks, v, vs, t, n, len, out, H, Hkv, hd, ps, max_pages, div);
  else
    launch_q<float>(grid, smem, st, g, q, qs, k, ks, v, vs, t, n, len, out, H, Hkv, hd, ps, max_pages, div);
  return (int)cudaGetLastError();
}
