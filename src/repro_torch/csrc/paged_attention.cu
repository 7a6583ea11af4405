// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (body _paged_attn_kernel).  One query token per batch
// row attends over that row's KV pages, addressed through its
// block-table row; the per-row length sits either in a separate (B,)
// operand or in the last column of the combined (B, M+1) operand that
// decode_prefetch builds once per decode step.
//
// Features carried over from the TPU kernel: scale on q before QK, an
// optional tanh logit cap after it, window and chunk masks, an online
// softmax in fp32 across pages, GQA (the g query heads of a KV head share
// one read of each page), pages outside a row's visible span skipped,
// int8 pages dequantised after the load against bf16 (slot, head)
// scales, a v_dim that reads V as the leading features of a wider slab
// (absorbed MLA: V is the first kv_lora features of the K slab), and
// exact zeros for rows of length 0.
//
// What bounds it: decode is memory-bound.  The work per call is one read
// of the K and V bytes of each row's visible tokens for each KV head (at
// most decode_hbm_bytes, the TPU kernel's whole-page count), plus the
// page ids, lengths, q and out, against ~3.35 TB/s of HBM; the
// arithmetic is 2 * (hd + vd) FLOPs per (query head, visible token),
// far below the tensor-core rate.  The design keeps each K/V byte read
// from device memory once: the TPU's sequential grid axis over pages
// becomes a loop inside the block, and the g grouped query heads are
// served from one load of each K row (scores) and each V element (PV).
// Only the visible token range of each page is read, so a short row in
// a mixed batch does proportionally less work.  One block per
// (KV head, row); no split across pages yet, no TMA and no wgmma — those
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHdPerLane = 8;      // head_dim <= 256
constexpr int kMaxOutPerThread = 16;  // g * v_dim <= kThreads * 16 = 2048
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One K/V element as fp32.  int8 pages dequantise in fp32 against their
// bf16 (slot, head) scale, as the TPU kernel does.
__device__ __forceinline__ float load_kv(const float* p, int64_t i, float) {
  return p[i];
}
__device__ __forceinline__ float load_kv(const __nv_bfloat16* p, int64_t i,
                                         float) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float load_kv(const int8_t* p, int64_t i,
                                         float s) {
  return static_cast<float>(p[i]) * s;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const TQ* __restrict__ q,                 // (B, H, hd)
    const TKV* __restrict__ k,                // (P, ps, K, hd)
    const TKV* __restrict__ v,                // (P, ps, K, v_ld)
    const __nv_bfloat16* __restrict__ k_scale,  // (P, ps, K) or null
    const __nv_bfloat16* __restrict__ v_scale,  // (P, ps, K) or null
    const int32_t* __restrict__ block_tables, int bt_stride,
    const int32_t* __restrict__ lengths, int len_stride,
    TQ* __restrict__ out,                     // (B, H, vd)
    int num_kv_heads, int g, int hd, int v_ld, int vd, int ps, int m,
    float scale, float logit_cap, int window, int chunk) {
  extern __shared__ float smem[];
  const int hd_pad = (hd + 31) / 32 * 32;
  float* q_s = smem;              // (g, hd_pad) scaled queries
  float* s_s = q_s + g * hd_pad;  // (g, ps) scores, then probabilities
  float* m_s = s_s + g * ps;      // (g,) running max
  float* l_s = m_s + g;           // (g,) running denominator
  float* c_s = l_s + g;           // (g,) this page's rescale factor

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_heads = num_kv_heads * g;
  const int nj = hd_pad / 32;

  for (int i = tid; i < g * hd_pad; i += kThreads) {
    const int gi = i / hd_pad, d = i % hd_pad;
    q_s[i] = d < hd
        ? to_float(q[(static_cast<int64_t>(b) * num_heads + kh * g + gi) * hd
                     + d]) * scale
        : 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  // visible span [lo, hi) of this row: kv_pos < length, and above the
  // window / chunk floors of the query at length - 1
  const int length = lengths[static_cast<int64_t>(b) * len_stride];
  const int q_pos = length - 1;
  int lo = 0;
  if (window > 0) lo = max(lo, q_pos - window + 1);
  if (chunk > 0 && q_pos >= 0) lo = max(lo, (q_pos / chunk) * chunk);
  const int hi = min(length, m * ps);

  float acc[kMaxOutPerThread];
#pragma unroll
  for (int r = 0; r < kMaxOutPerThread; ++r) acc[r] = 0.f;
  const int n_out = g * vd;
  const int64_t tok_stride_k = static_cast<int64_t>(num_kv_heads) * hd;
  const int64_t tok_stride_v = static_cast<int64_t>(num_kv_heads) * v_ld;
  __syncthreads();

  const int first_page = lo / ps;
  const int last_page = hi > lo ? (hi - 1) / ps : first_page - 1;
  for (int i = first_page; i <= last_page; ++i) {
    const int64_t page =
        block_tables[static_cast<int64_t>(b) * bt_stride + i];
    const int t0 = max(lo - i * ps, 0);
    const int t1 = min(hi - i * ps, ps);
    const int64_t slot0 = page * ps;  // first (page, slot) row of the page

    // scores: one warp per token, lanes across head_dim; the K row is
    // loaded once and dotted with all g queries of the group
    for (int t = t0 + warp; t < t1; t += kWarps) {
      const int64_t row = (slot0 + t) * tok_stride_k + kh * hd;
      const float ks = k_scale
          ? __bfloat162float(k_scale[(slot0 + t) * num_kv_heads + kh]) : 1.f;
      float kr[kMaxHdPerLane];
#pragma unroll
      for (int j = 0; j < kMaxHdPerLane; ++j) {
        const int d = lane + 32 * j;
        kr[j] = (j < nj && d < hd) ? load_kv(k, row + d, ks) : 0.f;
      }
      for (int gi = 0; gi < g; ++gi) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxHdPerLane; ++j)
          if (j < nj) part += q_s[gi * hd_pad + lane + 32 * j] * kr[j];
        part = warp_sum(part);
        if (lane == 0) {
          if (logit_cap > 0.f) part = tanhf(part / logit_cap) * logit_cap;
          s_s[gi * ps + t] = part;
        }
      }
    }
    __syncthreads();

    // online-softmax statistics: one warp per query head of the group
    for (int gi = warp; gi < g; gi += kWarps) {
      float mx = kNegInf;
      for (int t = t0 + lane; t < t1; t += 32) mx = fmaxf(mx, s_s[gi * ps + t]);
      mx = warp_max(mx);
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = t0 + lane; t < t1; t += 32) {
        const float p = expf(s_s[gi * ps + t] - m_new);
        s_s[gi * ps + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
        c_s[gi] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: threads across the flattened (head, v
    // feature) outputs, so neighbouring threads read neighbouring V
    // features of one token and each V element is read once per group
#pragma unroll
    for (int r = 0; r < kMaxOutPerThread; ++r) {
      const int o = tid + r * kThreads;
      if (o < n_out) {
        const int gi = o / vd;
        const int d = o - gi * vd;
        const float* p = s_s + gi * ps;
        float a = acc[r] * c_s[gi];
        for (int t = t0; t < t1; ++t) {
          const float vs = v_scale
              ? __bfloat162float(v_scale[(slot0 + t) * num_kv_heads + kh])
              : 1.f;
          a += p[t] * load_kv(v, (slot0 + t) * tok_stride_v + kh * v_ld + d,
                              vs);
        }
        acc[r] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kMaxOutPerThread; ++r) {
    const int o = tid + r * kThreads;
    if (o < n_out) {
      const int gi = o / vd;
      const int d = o - gi * vd;
      // a row with length 0 never reads a page: the contract is exact
      // zeros, not acc / clamped-l
      const float val = length > 0 ? acc[r] / fmaxf(l_s[gi], 1e-30f) : 0.f;
      out[(static_cast<int64_t>(b) * num_heads + kh * g + gi) * vd + d] =
          from_float<TQ>(val);
    }
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const int32_t* block_tables, int bt_stride,
                   const int32_t* lengths, int len_stride, void* out,
                   int batch, int num_kv_heads, int g, int hd, int v_ld,
                   int vd, int ps, int m, float scale, float logit_cap,
                   int window, int chunk, cudaStream_t stream) {
  const int hd_pad = (hd + 31) / 32 * 32;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(g) * hd_pad + static_cast<size_t>(g) * ps + 3 * g);
  auto kernel = paged_attention_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(num_kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), block_tables, bt_stride,
      lengths, len_stride, static_cast<TQ*>(out), num_kv_heads, g, hd, v_ld,
      vd, ps, m, scale, logit_cap, window, chunk);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only).
// logit_cap <= 0, window <= 0 and chunk <= 0 mean "off".
// Returns the cudaError_t of the launch (0 = success).
extern "C" int paged_attention_launch(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* block_tables,
    int bt_stride, const void* lengths, int len_stride, void* out, int batch,
    int num_kv_heads, int g, int hd, int v_ld, int vd, int ps, int m,
    float scale, float logit_cap, int window, int chunk, void* stream) {
  const auto* bt = static_cast<const int32_t*>(block_tables);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto st = static_cast<cudaStream_t>(stream);
#define PA_LAUNCH(TQ, TKV)                                                   \
  return static_cast<int>(launch<TQ, TKV>(                                   \
      q, k, v, k_scale, v_scale, bt, bt_stride, ln, len_stride, out, batch,  \
      num_kv_heads, g, hd, v_ld, vd, ps, m, scale, logit_cap, window, chunk, \
      st))
  if (q_dtype == 0) {
    if (kv_dtype == 0) PA_LAUNCH(float, float);
    if (kv_dtype == 1) PA_LAUNCH(float, __nv_bfloat16);
    if (kv_dtype == 2) PA_LAUNCH(float, int8_t);
  } else if (q_dtype == 1) {
    if (kv_dtype == 0) PA_LAUNCH(__nv_bfloat16, float);
    if (kv_dtype == 1) PA_LAUNCH(__nv_bfloat16, __nv_bfloat16);
    if (kv_dtype == 2) PA_LAUNCH(__nv_bfloat16, int8_t);
  }
#undef PA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
