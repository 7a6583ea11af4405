// Flash attention over a whole prompt (prefill) in fp32 for Hopper
// (sm_90a): the SIMT variant of K3.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _attn_kernel) for fp32 operands; bf16 operands
// go to csrc/flash_attention_sm90.cu (the tensor-core variant).  The
// wrapper picks the variant by dtype (kernels/flash_attention.py::
// flash_plan).  Multi-token attention of q (B, S, H, hd) over k
// (B, T, K, hd) and v (B, T, K, vd), H % K == 0, out (B, S, H, vd), all
// fp32, fp32 arithmetic throughout.
//
// Semantics carried over from the TPU kernel: q is scaled in fp32; an
// optional tanh logit cap applies before masking; the causal alignment
// is TOP-LEFT (query i sees keys <= i, whatever T is — not the
// bottom-right rule of library flash attention when S != T); then
// kv < T, the window (kv > q - window) and the chunk floor
// (kv >= (q / chunk) * chunk); an online softmax in fp32 with the
// denominator clamped at 1e-30.
//
// Design.  One block per (q tile, KV head, batch row) serves all g
// query heads of the GQA group: its g * block_q rows (at most 64;
// block_q = 64 / g) share every K/V tile, so each K/V tile is read once
// per group, as the TPU's grouped grid does.  The TPU's sequential grid
// axis over KV tiles becomes a loop inside the block, and the loop only
// visits the tiles between the block's first and last visible key (the
// TPU kernel's liveness test), so fully masked tiles are never read.
// Masked scores are not carried through the softmax as exp(-1e30 - m):
// a masked entry's probability is exactly 0 and a row with no visible
// key in a tile leaves its running state untouched, so the result does
// not depend on a later tile wiping earlier garbage.  (The wrapper
// refuses inputs where a query row sees no key at all.)
//
// Work split: 256 threads; thread t owns row t / 4 of the block and,
// with the three other lanes of its row, 8 of the 32 keys of each tile
// (scores) and a quarter of the output features (P V, float4 quads).
// Q, the K tile and the V tile sit in shared memory (K and Q rows
// padded by 4 floats so float4 reads of four neighbouring rows hit
// distinct banks); the accumulator stays in registers.
//
// What bounds it: fp32 operands leave the tensor cores to TF32 at best,
// which would not hold the fp32 checks' 1e-4, so this variant does its
// products with fp32 FMAs from shared memory (no cp.async / TMA
// pipelining); the FMA rate (67 TFLOP/s) bounds it.  It serves the fp32
// checks and fp32 models; the served bf16 prefills take the
// tensor-core variant.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                         // g * block_q, at most
constexpr int kLanesPerRow = kThreads / kRows;    // 4
constexpr int kBlockK = 32;                       // keys per KV tile
constexpr int kKeysPerLane = kBlockK / kLanesPerRow;  // 8
constexpr int kPStride = kBlockK + 1;             // P rows on distinct banks

// kMaxQuads: float4 output quads per lane (vd <= 16 * kMaxQuads)
template <int kMaxQuads>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q,     // (B, S, H, hd)
    const float* __restrict__ k,     // (B, T, K, hd)
    const float* __restrict__ v,     // (B, T, K, vd)
    float* __restrict__ out,         // (B, S, H, vd)
    float* __restrict__ lse,         // (B, H, S) or null
    int seq_len, int kv_len, int num_kv_heads, int g, int hd, int vd,
    int block_q, float scale, float logit_cap, int causal, int window,
    int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd4 = (hd + 3) & ~3;
  const int vd4 = (vd + 3) & ~3;
  const int qk_stride = hd4 + 4;
  float* q_s = smem;                          // (kRows, qk_stride)
  float* k_s = q_s + kRows * qk_stride;       // (kBlockK, qk_stride)
  float* v_s = k_s + kBlockK * qk_stride;     // (kBlockK, vd4)
  float* p_s = v_s + kBlockK * vd4;           // (kRows, kPStride)

  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / kLanesPerRow;           // block row: (head, query)
  const int lane4 = tid % kLanesPerRow;
  const int num_heads = num_kv_heads * g;
  const int rows = g * block_q;
  const int q0 = blockIdx.x * block_q;
  const int q_pos = q0 + r % block_q;
  const bool row_ok = r < rows && q_pos < seq_len;
  const int nquads = vd4 / 4;

  // q tile, scaled; unused rows are zeros
  for (int i = tid; i < kRows * hd4; i += kThreads) {
    const int rr = i / hd4, d = i - rr * hd4;
    const int qi = q0 + rr % block_q;
    float x = 0.f;
    if (rr < rows && qi < seq_len && d < hd) {
      const int head = kh * g + rr / block_q;
      x = q[((static_cast<int64_t>(b) * seq_len + qi) * num_heads + head)
            * hd + d] * scale;
    }
    q_s[rr * qk_stride + d] = x;
  }

  // the block's visible key span [kv_lo, kv_hi]: the union over its
  // queries (the lower bounds grow with the query, so the first query
  // sets kv_lo and the last sets kv_hi)
  const int q_last = min(q0 + block_q, seq_len) - 1;
  int kv_lo = 0;
  if (window > 0) kv_lo = max(kv_lo, q0 - window + 1);
  if (chunk > 0) kv_lo = max(kv_lo, (q0 / chunk) * chunk);
  const int kv_hi = causal ? min(kv_len - 1, q_last) : kv_len - 1;
  const int row_floor = chunk > 0 ? (q_pos / chunk) * chunk : 0;

  float m_run = -INFINITY;
  float l_run = 0.f;
  float4 acc[kMaxQuads];
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int64_t tok_k = static_cast<int64_t>(num_kv_heads) * hd;
  const int64_t tok_v = static_cast<int64_t>(num_kv_heads) * vd;
  const float* k_base = k + static_cast<int64_t>(b) * kv_len * tok_k
                         + kh * hd;
  const float* v_base = v + static_cast<int64_t>(b) * kv_len * tok_v
                         + kh * vd;

  for (int t0 = (kv_lo / kBlockK) * kBlockK; t0 <= kv_hi; t0 += kBlockK) {
    __syncthreads();    // the previous tile's K/V/P reads are done
    for (int i = tid; i < kBlockK * hd4; i += kThreads) {
      const int j = i / hd4, d = i - j * hd4;
      const int kv = t0 + j;
      k_s[j * qk_stride + d] =
          (kv < kv_len && d < hd) ? k_base[kv * tok_k + d] : 0.f;
    }
    for (int i = tid; i < kBlockK * vd4; i += kThreads) {
      const int j = i / vd4, d = i - j * vd4;
      const int kv = t0 + j;
      v_s[j * vd4 + d] =
          (kv < kv_len && d < vd) ? v_base[kv * tok_v + d] : 0.f;
    }
    __syncthreads();

    // scores of this lane's 8 keys (lane4 + 4 i) against its row
    float s[kKeysPerLane];
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) s[i] = 0.f;
    const float4* q_row = reinterpret_cast<const float4*>(q_s + r * qk_stride);
    for (int d4 = 0; d4 < hd4 / 4; ++d4) {
      const float4 a = q_row[d4];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const float4 kk = reinterpret_cast<const float4*>(
            k_s + (lane4 + 4 * i) * qk_stride)[d4];
        s[i] += a.x * kk.x + a.y * kk.y + a.z * kk.z + a.w * kk.w;
      }
    }

    // cap, mask, online softmax; masked entries get p = 0 exactly
    bool vis[kKeysPerLane];
    float m_tile = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int kv = t0 + lane4 + 4 * i;
      float x = s[i];
      if (logit_cap > 0.f) x = tanhf(x / logit_cap) * logit_cap;
      s[i] = x;
      bool ok = row_ok && kv < kv_len;
      if (causal) ok = ok && kv <= q_pos;
      if (window > 0) ok = ok && kv > q_pos - window;
      if (chunk > 0) ok = ok && kv >= row_floor;
      vis[i] = ok;
      if (ok) m_tile = fmaxf(m_tile, x);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
    const float m_new = fmaxf(m_run, m_tile);
    // a row that has seen no visible key yet keeps corr = 1 and p = 0
    const bool any = m_new != -INFINITY;
    const float corr = any ? expf(m_run - m_new) : 1.f;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const float p = (any && vis[i]) ? expf(s[i] - m_new) : 0.f;
      s[i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l_run = l_run * corr + sum;
    m_run = m_new;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i)
      p_s[r * kPStride + lane4 + 4 * i] = s[i];
    __syncwarp();       // a row's four lanes share one warp

    // acc = acc * corr + P V over this lane's output quads
#pragma unroll
    for (int i = 0; i < kMaxQuads; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
    const float* p_row = p_s + r * kPStride;
    for (int j = 0; j < kBlockK; ++j) {
      const float p = p_row[j];
      const float4* v_row = reinterpret_cast<const float4*>(v_s + j * vd4);
#pragma unroll
      for (int i = 0; i < kMaxQuads; ++i) {
        const int qd = lane4 + 4 * i;
        if (qd < nquads) {
          const float4 vv = v_row[qd];
          acc[i].x += p * vv.x;
          acc[i].y += p * vv.y;
          acc[i].z += p * vv.z;
          acc[i].w += p * vv.w;
        }
      }
    }
  }

  if (!row_ok) return;
  const float inv = 1.f / fmaxf(l_run, 1e-30f);
  const int head = kh * g + r / block_q;
  // the row's log-sum-exp for the backward (K3's gradient); every lane
  // of the row holds the same m_run and l_run
  if (lse != nullptr && lane4 == 0)
    lse[(static_cast<int64_t>(b) * num_heads + head) * seq_len + q_pos] =
        m_run + logf(l_run);
  float* o_row = out + ((static_cast<int64_t>(b) * seq_len + q_pos)
                        * num_heads + head) * vd;
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    const int c = 4 * (lane4 + 4 * i);
    if (c < vd) o_row[c] = acc[i].x * inv;
    if (c + 1 < vd) o_row[c + 1] = acc[i].y * inv;
    if (c + 2 < vd) o_row[c + 2] = acc[i].z * inv;
    if (c + 3 < vd) o_row[c + 3] = acc[i].w * inv;
  }
}

template <int kMaxQuads>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int seq_len, int kv_len,
                   int num_kv_heads, int g, int hd, int vd, int block_q,
                   float scale,
                   float logit_cap, int causal, int window, int chunk,
                   cudaStream_t stream) {
  const int hd4 = (hd + 3) & ~3;
  const int vd4 = (vd + 3) & ~3;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kRows + kBlockK) * (hd4 + 4)
       + static_cast<size_t>(kBlockK) * vd4
       + static_cast<size_t>(kRows) * kPStride);
  auto kernel = flash_attention_kernel<kMaxQuads>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((seq_len + block_q - 1) / block_q, num_kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), seq_len, kv_len, num_kv_heads, g, hd, vd,
      block_q, scale, logit_cap, causal, window, chunk);
  return cudaGetLastError();
}

}  // namespace

// fp32 q, k, v and out; g * block_q <= 64, hd <= 256, vd <= 256 (the
// wrapper's plan checks it).  lse, where not null, receives each row's
// log-sum-exp of its (scaled, capped) visible scores, (B, H, S) fp32.
// logit_cap <= 0, window <= 0 and chunk <= 0 mean "off".  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int seq_len, int kv_len, int num_kv_heads, int g, int hd,
    int vd, int block_q, float scale, float logit_cap, int causal, int window,
    int chunk, void* stream) {
  if (g * block_q > kRows || hd > 256 || vd > 256 || block_q < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (vd <= 128)
    return static_cast<int>(launch<8>(
        q, k, v, out, lse, batch, seq_len, kv_len, num_kv_heads, g, hd, vd,
        block_q, scale, logit_cap, causal, window, chunk, st));
  return static_cast<int>(launch<16>(
      q, k, v, out, lse, batch, seq_len, kv_len, num_kv_heads, g, hd, vd,
      block_q, scale, logit_cap, causal, window, chunk, st));
}
