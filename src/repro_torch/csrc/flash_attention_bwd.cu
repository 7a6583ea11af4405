// Backward of whole-prompt flash attention (K3) for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// has no VJP: the JAX package trains through plain jnp attention
// (models/transformer.py::lm_loss -> attention.blocked_attention) and
// gets its gradient from autodiff.  The port runs its whole-prompt
// attention through K3 on the card, in training too, so K3's gradient is
// this kernel; kernels/ops.py::FlashAttention binds it as the backward
// of K3's forward.  It computes what kernels/flash_attention.py::
// flash_attention_bwd_plain computes: from q (B, S, H, hd), k (B, T, K,
// hd), v (B, T, K, vd), the forward's out (B, S, H, vd) and row
// log-sum-exp lse (B, H, S) fp32, and dout (B, S, H, vd), the gradients
// dq, dk, dv in the inputs' dtype, with S = T, H % K == 0, hd and vd
// <= 128 and multiples of 8, bf16 or fp32.  The masks are the forward's
// (top-left causal, window kv > q - window, chunk kv >= (q / chunk) *
// chunk) and so is the tanh logit cap.  For a visible (query, key) pair:
//   x = scale (q . k), y = cap tanh(x / cap) (or x), P = exp(y - lse),
//   dP = dout . v, D = rowsum(dout * out),
//   dS = P (dP - D) (1 - tanh^2 under the cap) scale,
//   dq = sum_keys dS k, dk = sum_queries dS q, dv = sum_queries P dout,
// with dk and dv summed over the g query heads of a KV head.
//
// Design: three launches, no atomics, so two runs agree bitwise.
//  1. flash_bwd_delta_kernel: D (B, H, S) fp32, a warp a row.
//  2. flash_bwd_dkdv_kernel: a block per (64-key tile, KV head, batch
//     row) keeps the K and V tiles in shared memory and walks, for each
//     of the g query heads, the 64-row q tiles that can see the tile
//     (the masks bound the walk); dk and dv accumulate in registers.
//  3. flash_bwd_dq_kernel: a block per (64-row q tile, query head, batch
//     row) walks the key tiles its rows can see; dq accumulates in
//     registers.
// Each block has 4 warps; a warp owns 16 rows of every 64-row product,
// so P and dS pass through shared memory only within the warp that
// made them.  Products are tiles of mma.sync m16n8k16 with bf16
// operands fed by ldmatrix and fp32 accumulation (P and dS rounded to
// bf16 as operands); fp32 inputs take fp32 FMAs in the same fragment
// layout, so the softmax-gradient code is one.  Tiles load with 16-byte
// copies; head widths pad to a multiple of 16 in shared memory (zero
// fill) so the k16 steps cover them.
// What bounds it: at olmo-1b's training shape (B 2, S 4096, H 16, hd
// 128, causal) 5 products of 2 x 128 FLOPs over 268 M visible pairs are
// 3.4e11 FLOPs, 0.35 ms at 989 TFLOP/s; this kernel recomputes S and dP
// in both passes (7 products) and runs mma.sync from shared memory
// without a load pipeline, so it sits far from that bound.  Left out:
// wgmma, TMA, double-buffered tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;            // q rows / keys a tile; 16 a warp
constexpr int kMaxDim = 128;         // hd, vd
constexpr int kMaxNt = kMaxDim / 8;  // n8 tiles of a width-128 product

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Row stride (elements) of a shared tile of padded width w: a few extra
// elements so that the rows of a fragment load fall on other banks.
template <typename T> __host__ __device__ constexpr int pad_ld(int w) {
  return w + (sizeof(T) == 2 ? 8 : 4);
}

__host__ __device__ constexpr int round16(int x) { return (x + 15) & ~15; }

// ---- warp tile products ----------------------------------------------------
// acc (16 x 8 nt) += A (16 x kdim) B (kdim x 8 nt) in the m16n8 accumulator
// layout: with g = lane / 4, t = lane % 4, acc[j][0..1] hold row g, columns
// 8 j + 2 t + {0, 1}, and acc[j][2..3] row g + 8.  A(m, k) = a[m lda + k];
// B(k, n) = b[n ldb + k] when KMajorB, else b[k ldb + n].  kdim % 16 == 0.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8 (16-byte aligned); .trans delivers each
// matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16: fragments by ldmatrix, two n8 tiles a load of B (nt even).  A's
// four matrices are rows 0-7 / 8-15 x k 0-7 / 8-15 (its a0a1 .. a6a7);
// B's are (n tile j, k 0-7), (j, k 8-15), (j + 1, k 0-7), (j + 1, k 8-15),
// read as stored when KMajorB ([n][k] rows) and transposed otherwise
// ([k][n] rows).  Row strides are multiples of 16 bytes.
template <int NT, bool KMajorB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb,
                                         int kdim, int nt) {
  const int lane = threadIdx.x % 32;
  const int lr = lane % 8, lm = lane / 8;
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * lda + k0 + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= nt) break;
      uint32_t bf[4];
      if (KMajorB)
        ldsm_x4(bf, b + (8 * j + (lm / 2) * 8 + lr) * ldb + k0
                        + (lm % 2) * 8);
      else
        ldsm_x4_t(bf, b + (k0 + (lm % 2) * 8 + lr) * ldb + 8 * j
                          + (lm / 2) * 8);
      mma16816(acc[j], af, bf[0], bf[1]);
      mma16816(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NT, bool KMajorB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a,
                                         int lda, const float* b, int ldb,
                                         int kdim, int nt) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  for (int k = 0; k < kdim; ++k) {
    const float a_lo = a[g * lda + k];
    const float a_hi = a[(g + 8) * lda + k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      const int n = 8 * j + 2 * t;
      const float b0 = KMajorB ? b[n * ldb + k] : b[k * ldb + n];
      const float b1 = KMajorB ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
      acc[j][0] = fmaf(a_lo, b0, acc[j][0]);
      acc[j][1] = fmaf(a_lo, b1, acc[j][1]);
      acc[j][2] = fmaf(a_hi, b0, acc[j][2]);
      acc[j][3] = fmaf(a_hi, b1, acc[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// ---- shared-memory tiles -----------------------------------------------------

// 64 rows x wpad columns of a (rows, heads, width) slab into dst (row
// stride ld), 16 bytes a copy: rows [row0, row0 + 64); rows past ``rows``
// and columns past ``width`` read as 0.  width is a multiple of 8 and
// every row start 16-byte aligned (the wrapper checks the operands).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows, int width, int wpad) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = wpad / kVec;
  for (int i = threadIdx.x; i < kTile * vecs; i += kThreads) {
    const int r = i / vecs, c = (i - r * vecs) * kVec;
    const int row = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && c < width)
      x = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

// 64 floats of a (B, H, S) row vector (lse or D) times ``mul``; past S
// read as 0.
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int rows, float mul) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = row0 + i < rows ? src[row0 + i] * mul : 0.f;
}

struct Masks {
  int causal, window, chunk, seq_len;
  __device__ __forceinline__ bool visible(int q, int kv) const {
    if (q >= seq_len || kv >= seq_len) return false;
    if (causal && kv > q) return false;
    if (window > 0 && kv <= q - window) return false;
    if (chunk > 0 && kv < (q / chunk) * chunk) return false;
    return true;
  }
  // every pair of q rows [q0, q0 + 64) x keys [t0, t0 + 64) is visible,
  // so the tile skips the per-element mask
  __device__ __forceinline__ bool tile_full(int q0, int t0) const {
    const int q_last = q0 + kTile - 1, t_last = t0 + kTile - 1;
    if (q_last >= seq_len || t_last >= seq_len) return false;
    if (causal && t_last > q0) return false;
    if (window > 0 && t0 <= q_last - window) return false;
    if (chunk > 0 && t0 < (q_last / chunk) * chunk) return false;
    return true;
  }
};

constexpr float kLog2e = 1.4426950408889634f;

// The softmax gradient of one score: P and dS (scale folded in); lse2 is
// the row's log-sum-exp times log2(e).
__device__ __forceinline__ void grad_of_score(float s, float dp, float lse2,
                                              float delta, bool vis,
                                              float scale, float logit_cap,
                                              float& p, float& ds) {
  float y = s * scale;
  float dy = 1.f;
  if (logit_cap > 0.f) {
    const float th = tanhf(y / logit_cap);
    y = th * logit_cap;
    dy = 1.f - th * th;
  }
  p = vis ? exp2f(fmaf(y, kLog2e, -lse2)) : 0.f;
  ds = p * (dp - delta) * (dy * scale);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int batch, seq_len, num_kv_heads, g, hd, vd;
  float scale, logit_cap;
  int causal, window, chunk;
};

// ---- 1. D = rowsum(dout * out) -------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(Args a) {
  const int num_heads = a.num_kv_heads * a.g;
  const int64_t rows = static_cast<int64_t>(a.batch) * a.seq_len * num_heads;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(a.out) + row * a.vd;
  const T* d = static_cast<const T*>(a.dout) + row * a.vd;
  float sum = 0.f;
  for (int c = lane; c < a.vd; c += 32) sum += to_f(o[c]) * to_f(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    // row = (b S + s) H + h  ->  (b H + h) S + s
    const int h = static_cast<int>(row % num_heads);
    const int64_t bs = row / num_heads;
    const int s = static_cast<int>(bs % a.seq_len);
    const int64_t b = bs / a.seq_len;
    a.delta[(b * num_heads + h) * a.seq_len + s] = sum;
  }
}

// ---- 2. dk, dv -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int hdp = round16(a.hd), vdp = round16(a.vd);
  const int ldh = pad_ld<T>(hdp), ldv = pad_ld<T>(vdp),
            ldp = pad_ld<T>(kTile);
  T* k_s = reinterpret_cast<T*>(smem4);
  T* v_s = k_s + kTile * ldh;
  T* q_s = v_s + kTile * ldv;
  T* do_s = q_s + kTile * ldh;
  T* p_s = do_s + kTile * ldv;
  T* ds_s = p_s + kTile * ldp;
  float* lse_s = reinterpret_cast<float*>(ds_s + kTile * ldp);
  float* dl_s = lse_s + kTile;

  const int t0 = blockIdx.x * kTile;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int64_t bs = static_cast<int64_t>(b) * a.seq_len;  // row b's token 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int s_len = a.seq_len, nkv = a.num_kv_heads, g = a.g;
  const int num_heads = nkv * g;
  const Masks mask{a.causal, a.window, a.chunk, s_len};

  const int64_t tok_k = static_cast<int64_t>(nkv) * a.hd;
  const int64_t tok_v = static_cast<int64_t>(nkv) * a.vd;
  const int64_t tok_q = static_cast<int64_t>(num_heads) * a.hd;
  const int64_t tok_o = static_cast<int64_t>(num_heads) * a.vd;
  const T* kg = static_cast<const T*>(a.k) + bs * tok_k + kh * a.hd;
  const T* vg = static_cast<const T*>(a.v) + bs * tok_v + kh * a.vd;
  load_tile(k_s, ldh, kg, tok_k, t0, s_len, a.hd, hdp);
  load_tile(v_s, ldv, vg, tok_v, t0, s_len, a.vd, vdp);

  // the q rows that can see a key of this tile
  const int t_last = min(t0 + kTile, s_len) - 1;
  const int q_lo = a.causal ? t0 : 0;
  int q_hi = s_len - 1;
  if (a.window > 0) q_hi = min(q_hi, t_last + a.window - 1);
  if (a.chunk > 0) q_hi = min(q_hi, (t_last / a.chunk + 1) * a.chunk - 1);

  float acc_dk[kMaxNt][4], acc_dv[kMaxNt][4];
  zero(acc_dk);
  zero(acc_dv);
  const int r0 = warp * 16;                   // this warp's keys in the tile

  for (int hh = 0; hh < g; ++hh) {
    const int head = kh * g + hh;
    const T* qg = static_cast<const T*>(a.q) + bs * tok_q + head * a.hd;
    const T* dog = static_cast<const T*>(a.dout) + bs * tok_o
                   + head * a.vd;
    const float* lse_g = a.lse + (static_cast<int64_t>(b) * num_heads + head)
                                     * s_len;
    const float* dl_g = a.delta + (static_cast<int64_t>(b) * num_heads + head)
                                      * s_len;
    for (int q0 = (q_lo / kTile) * kTile; q0 <= q_hi; q0 += kTile) {
      __syncthreads();      // every warp is done with the previous q tile
      load_tile(q_s, ldh, qg, tok_q, q0, s_len, a.hd, hdp);
      load_tile(do_s, ldv, dog, tok_o, q0, s_len, a.vd, vdp);
      load_vec(lse_s, lse_g, q0, s_len, kLog2e);
      load_vec(dl_s, dl_g, q0, s_len, 1.f);
      __syncthreads();
      const bool full = mask.tile_full(q0, t0);

      // S^T and dP^T for this warp's 16 keys, 32 queries at a time
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float st[4][4], dpt[4][4];
        zero(st);
        zero(dpt);
        warp_mma<4, true>(st, k_s + r0 * ldh, ldh, q_s + half * 32 * ldh, ldh,
                          hdp, 4);
        warp_mma<4, true>(dpt, v_s + r0 * ldv, ldv, do_s + half * 32 * ldv,
                          ldv, vdp, 4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kr = r0 + gq + 8 * (e >> 1);          // key in tile
            const int qr = half * 32 + 8 * j + 2 * tq + (e & 1);
            float p, ds;
            grad_of_score(st[j][e], dpt[j][e], lse_s[qr], dl_s[qr],
                          full || mask.visible(q0 + qr, t0 + kr), a.scale,
                          a.logit_cap, p, ds);
            p_s[kr * ldp + qr] = from_f<T>(p);
            ds_s[kr * ldp + qr] = from_f<T>(ds);
          }
      }
      __syncwarp();
      // dv += P^T dout, dk += dS^T q over the tile's 64 queries
      warp_mma<kMaxNt, false>(acc_dv, p_s + r0 * ldp, ldp, do_s, ldv, kTile,
                              vdp / 8);
      warp_mma<kMaxNt, false>(acc_dk, ds_s + r0 * ldp, ldp, q_s, ldh, kTile,
                              hdp / 8);
    }
  }

  T* dkg = static_cast<T*>(a.dk) + bs * tok_k + kh * a.hd;
  T* dvg = static_cast<T*>(a.dv) + bs * tok_v + kh * a.vd;
#pragma unroll
  for (int j = 0; j < kMaxNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = t0 + r0 + gq + 8 * (e >> 1);
      const int col = 8 * j + 2 * tq + (e & 1);
      if (key >= s_len) continue;
      if (col < a.hd) dkg[key * tok_k + col] = from_f<T>(acc_dk[j][e]);
      if (col < a.vd) dvg[key * tok_v + col] = from_f<T>(acc_dv[j][e]);
    }
}

// ---- 3. dq -------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const int hdp = round16(a.hd), vdp = round16(a.vd);
  const int ldh = pad_ld<T>(hdp), ldv = pad_ld<T>(vdp),
            ldp = pad_ld<T>(kTile);
  T* q_s = reinterpret_cast<T*>(smem4);
  T* do_s = q_s + kTile * ldh;
  T* k_s = do_s + kTile * ldv;
  T* v_s = k_s + kTile * ldh;
  T* ds_s = v_s + kTile * ldv;
  float* lse_s = reinterpret_cast<float*>(ds_s + kTile * ldp);
  float* dl_s = lse_s + kTile;

  // the q tiles from the last, which under the causal rule walk the most
  // keys, so the tail wave holds the short ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int head = blockIdx.y, b = blockIdx.z;
  const int64_t bs = static_cast<int64_t>(b) * a.seq_len;  // row b's token 0
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int s_len = a.seq_len, nkv = a.num_kv_heads, g = a.g;
  const int num_heads = nkv * g;
  const int kh = head / g;
  const Masks mask{a.causal, a.window, a.chunk, s_len};

  const int64_t tok_k = static_cast<int64_t>(nkv) * a.hd;
  const int64_t tok_v = static_cast<int64_t>(nkv) * a.vd;
  const int64_t tok_q = static_cast<int64_t>(num_heads) * a.hd;
  const int64_t tok_o = static_cast<int64_t>(num_heads) * a.vd;
  const T* qg = static_cast<const T*>(a.q) + bs * tok_q + head * a.hd;
  const T* dog = static_cast<const T*>(a.dout) + bs * tok_o
                 + head * a.vd;
  const T* kg = static_cast<const T*>(a.k) + bs * tok_k + kh * a.hd;
  const T* vg = static_cast<const T*>(a.v) + bs * tok_v + kh * a.vd;
  const int64_t vec = (static_cast<int64_t>(b) * num_heads + head) * s_len;
  load_tile(q_s, ldh, qg, tok_q, q0, s_len, a.hd, hdp);
  load_tile(do_s, ldv, dog, tok_o, q0, s_len, a.vd, vdp);
  load_vec(lse_s, a.lse + vec, q0, s_len, kLog2e);
  load_vec(dl_s, a.delta + vec, q0, s_len, 1.f);

  // the keys this tile's rows can see (as the forward's walk)
  const int q_last = min(q0 + kTile, s_len) - 1;
  int kv_lo = 0;
  if (a.window > 0) kv_lo = max(kv_lo, q0 - a.window + 1);
  if (a.chunk > 0) kv_lo = max(kv_lo, (q0 / a.chunk) * a.chunk);
  const int kv_hi = a.causal ? q_last : s_len - 1;

  float acc_dq[kMaxNt][4];
  zero(acc_dq);
  const int r0 = warp * 16;                   // this warp's queries
  for (int t0 = (kv_lo / kTile) * kTile; t0 <= kv_hi; t0 += kTile) {
    __syncthreads();        // every warp is done with the previous K/V tile
    load_tile(k_s, ldh, kg, tok_k, t0, s_len, a.hd, hdp);
    load_tile(v_s, ldv, vg, tok_v, t0, s_len, a.vd, vdp);
    __syncthreads();
    const bool full = mask.tile_full(q0, t0);

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    warp_mma<8, true>(s, q_s + r0 * ldh, ldh, k_s, ldh, hdp, 8);
    warp_mma<8, true>(dp, do_s + r0 * ldv, ldv, v_s, ldv, vdp, 8);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = r0 + gq + 8 * (e >> 1);
        const int kc = 8 * j + 2 * tq + (e & 1);
        float p, ds;
        grad_of_score(s[j][e], dp[j][e], lse_s[qr], dl_s[qr],
                      full || mask.visible(q0 + qr, t0 + kc), a.scale,
                      a.logit_cap, p, ds);
        ds_s[qr * ldp + kc] = from_f<T>(ds);
      }
    __syncwarp();
    // dq += dS k over the tile's 64 keys
    warp_mma<kMaxNt, false>(acc_dq, ds_s + r0 * ldp, ldp, k_s, ldh, kTile,
                            hdp / 8);
  }

  T* dqg = static_cast<T*>(a.dq) + bs * tok_q + head * a.hd;
#pragma unroll
  for (int j = 0; j < kMaxNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + r0 + gq + 8 * (e >> 1);
      const int col = 8 * j + 2 * tq + (e & 1);
      if (row < s_len && col < a.hd)
        dqg[row * tok_q + col] = from_f<T>(acc_dq[j][e]);
    }
}

// Shared memory of the dk/dv and the dq kernels (the same tiles: two
// of width hd, two of width vd, P and dS or dS alone, two row vectors).
template <typename T>
size_t dkdv_smem(int hd, int vd) {
  return sizeof(T) * (static_cast<size_t>(kTile) * 2
                          * (pad_ld<T>(round16(hd)) + pad_ld<T>(round16(vd)))
                      + 2 * static_cast<size_t>(kTile) * pad_ld<T>(kTile))
         + 2 * kTile * sizeof(float);
}

template <typename T>
size_t dq_smem(int hd, int vd) {
  return sizeof(T) * (static_cast<size_t>(kTile) * 2
                          * (pad_ld<T>(round16(hd)) + pad_ld<T>(round16(vd)))
                      + static_cast<size_t>(kTile) * pad_ld<T>(kTile))
         + 2 * kTile * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const int num_heads = a.num_kv_heads * a.g;
  const int64_t rows = static_cast<int64_t>(a.batch) * a.seq_len * num_heads;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                              stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles = (a.seq_len + kTile - 1) / kTile;
  const size_t smem_kv = dkdv_smem<T>(a.hd, a.vd);
  err = allow_smem(flash_bwd_dkdv_kernel<T>, smem_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T><<<dim3(tiles, a.num_kv_heads, a.batch), kThreads,
                             smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem_q = dq_smem<T>(a.hd, a.vd);
  err = allow_smem(flash_bwd_dq_kernel<T>, smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T><<<dim3(tiles, num_heads, a.batch), kThreads, smem_q,
                           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out, dout, dq, dk, dv of one dtype (is_bf16: bfloat16, else
// float32), contiguous; lse and delta (B, H, S) fp32, delta scratch the
// launch overwrites; S = T; hd, vd <= 128 and multiples of 8 (the
// wrapper's plan checks all of it).  logit_cap <= 0, window <= 0 and
// chunk <= 0 mean "off".  Launches three kernels on ``stream`` and
// returns the cudaError_t of the first that fails (0 = success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int batch, int seq_len, int num_kv_heads, int g, int hd, int vd,
    float scale, float logit_cap, int causal, int window, int chunk,
    int is_bf16, void* stream) {
  if (hd > kMaxDim || vd > kMaxDim || hd % 8 != 0 || vd % 8 != 0 || hd <= 0
      || vd <= 0 || g < 1 || num_kv_heads < 1 || seq_len < 1 || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, dout, static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv, batch, seq_len,
               num_kv_heads, g, hd, vd, scale, logit_cap, causal, window,
               chunk};
  const auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
}
