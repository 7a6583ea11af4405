// Paged decode attention for Hopper (sm_90a): split kernel + combine pass.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (body _paged_attn_kernel).  One query token per batch
// row attends over that row's KV pages, addressed through its
// block-table row; the per-row length sits either in a separate (B,)
// operand or in the last column of the combined (B, M+1) operand that
// decode_prefetch builds once per decode step.
//
// Features carried over from the TPU kernel: scale on q before QK, an
// optional tanh logit cap after it, window and chunk masks, a softmax in
// fp32, GQA (the g query heads of a KV head share one read of each K/V
// row), tokens outside a row's visible span never read, int8 pages
// dequantised in fp32 against bf16 (slot, head) scales, a v_dim that
// reads V as the leading features of a wider slab (absorbed MLA: V is
// the first kv_lora features of the K slab), and exact zeros for rows of
// length 0.
//
// What bounds it: decode is memory-bound.  The work of a call is one
// read of the K and V bytes of each row's visible tokens for each KV
// head, plus q, the page ids, the lengths and out, against ~3.35 TB/s;
// the arithmetic, 2 * (hd + vd) FLOPs per (query head, visible token), is
// far below any compute rate.  At the served decode step (B = 8 rows of
// 17-1024 tokens, 16 or 32 KV heads of 128, bf16) that is 34 or 68 MB,
// 10 or 20 us.  Reaching it takes enough bytes in flight on every SM, and
// no row's serial walk longer than the whole call should be:
//  - Splits (flash-decoding).  The grid is (KV heads, rows, num_splits),
//    so blocks start in split order: the first splits, which every
//    non-empty row has, go first, and the heads of one page run side by
//    side.  A split is a fixed run of pages_per_split pages of the block
//    table.
//    The plan (kernels/paged_attention.py::paged_plan) takes the split
//    size and the tile from shapes alone (B, K, g, M, page size, widths,
//    dtype, SM count), never from the lengths, so the wrapper reads
//    nothing back from the card and the call can be captured in a CUDA
//    graph.  A block computes its own visible sub-span [v0, v1) from the
//    row's length, window and chunk; a split with no visible token writes
//    a neutral partial (m = -1e30, l = 0) and returns, so a short row
//    next to a long one costs one cheap block per empty split.
//  - Staging.  The split's K rows, then its V rows, stream through a
//    ring of kStages = 2 tiles (runs of tokens, not pages: ~16 KB, 64
//    bf16 rows of 128) in shared memory with cp.async: load j + 1 is in
//    flight while tile j is scored or accumulated (one barrier a tile),
//    so the first V tile is in flight during the last scores and the
//    softmax.  Each thread stages fixed 16-byte pieces of rows, with no
//    division a piece: on the card the issue cost of staging, not the
//    ring's depth, was what stood in the way.  A block's prologue is one
//    round trip (the length and the split's page ids together); q and
//    the int8 scales load while the first tile is in flight.  A copy is
//    16 bytes where the row's address, stride and width allow it (bf16:
//    hd * 2 % 16 == 0), else 8 or 4 bytes, else element by element, so
//    every width the kernel took before still works.  A row's tail past
//    its width is zero in shared memory.  int8 scales (2-byte values at a
//    stride of K * 2 bytes) are read once per split into shared memory in
//    fp32.
//  - Scores from shared memory with 16-byte reads: lanes cover a K row in
//    16-byte chunks (8 bf16, 4 fp32 or 16 int8 values a read), the
//    partial dots of a token meet by shuffles (several tokens a lane
//    group at once, so their chains interleave), and each of the g query
//    heads (q scaled, fp32, in shared memory) reuses the chunk.  The
//    split's scores stay in shared memory, so the softmax is exact over
//    the split (no rescaling per tile) and the int8 V scale folds into P.
//  - P V: each thread owns (head, feature) outputs and sums over the
//    tile's tokens from shared memory; neighbouring threads read
//    neighbouring features of one V row.  The outputs a thread owns are
//    a template argument (1, 4 or 16 for g * vd up to 128, 512, 2048),
//    so the served MHA shapes keep one accumulator and few registers.
//  - Head tiles (absorbed MLA).  minicpm3-4b decodes 40 query heads
//    against ONE latent head of hd = kv_lora + d_rope = 288 with V the
//    leading v_dim = 256 features of the same slab: g * vd = 10,240
//    outputs, five times what a block owns.  The grid's x dimension then
//    runs over (KV head, head tile): each block owns tile_heads query
//    heads (8 here, 8 * 256 = 2048 outputs, the kOut = 16 accumulator
//    path) of one split, and the five tiles of a split re-read the same
//    latent rows (9.4 MB a layer at B = 8, under the 50 MB L2).  Every
//    other shape has one tile (head_tiles = 1: the block is (KV head,
//    row, split) as before, with the same plan, and runs a narrow
//    instantiation, where the tiling is compiled out; only the wide one
//    takes tiles, and the combine pass has a form of each).  At g = 40
//    the work is 2 * 40 * (288 + 256) FLOPs a visible token against 576
//    bytes, 75 FLOPs a byte: on fp32 CUDA cores (67 TFLOP/s) that is
//    above the 20 FLOPs a byte where bytes bind, so this shape is bound
//    by the arithmetic of a SIMT kernel, not by its bytes.
//  - Row width.  A K row of up to 256 features (kNarrowHd) takes one
//    16-byte chunk a lane for bf16; rows up to 512 (kWideHd: the MLA
//    latent of 288) and every head-tiled shape take the wide
//    instantiation, two chunks a lane (bf16; four for fp32), with half
//    as many tokens a lane group scores at once so a lane still holds 32
//    K values.
//  - Combine (paged_attention_kernel_combine).  Where a shape has more
//    than one split, a second kernel merges each (row, KV head)'s
//    partials (m, l, unnormalised acc, fp32 scratch from the wrapper) by
//    a running log-sum-exp in split order, 16 splits' partials loaded at
//    once, and writes out in q's dtype: no float atomics, so a call is
//    bitwise repeatable, and a row with no visible token (length 0) gets
//    exact zeros.  With one split the split kernel writes out itself.
// What it leaves out: tensor cores for g >= 2 (mma.sync: at g = 40 the
// MLA shape's arithmetic, not its bytes, binds), one staged tile read by
// both the scores and P V where V is a slice of the K slab, TMA, and a
// persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOutPerThread = 16;  // a block's heads * v_dim <= 2048
constexpr int kNarrowHd = 256;        // K row widths of the narrow form
constexpr int kWideHd = 512;          // and of the wide one
constexpr int kStages = 2;            // tiles in the cp.async ring
constexpr int kCombineThreads = 128;
constexpr int kCombineBatch = 16;     // splits whose partials load at once
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- page element types: a 16-byte chunk as E floats, one element -------

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& c, float* f) {
    f[0] = __uint_as_float(c.x);
    f[1] = __uint_as_float(c.y);
    f[2] = __uint_as_float(c.z);
    f[3] = __uint_as_float(c.w);
  }
  __device__ static float one(const float* p, int i) { return p[i]; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& c, float* f) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // element 2i in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float one(const __nv_bfloat16* p, int i) {
    return __bfloat162float(p[i]);
  }
};

template <>
struct Elem<int8_t> {
  static constexpr int E = 16;
  __device__ static void unpack(const uint4& c, float* f) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)     // sign-extend byte j
        f[4 * i + j] = static_cast<float>(
            static_cast<int32_t>(w[i] << (24 - 8 * j)) >> 24);
  }
  __device__ static float one(const int8_t* p, int i) {
    return static_cast<float>(p[i]);
  }
};

// ---- cp.async -------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// Slot (page * ps + t % ps) of split-relative token t; ps_log is log2(ps)
// for a power-of-two page, else -1.
__device__ __forceinline__ int64_t slot_of(const int* pages, int ps,
                                           int ps_log, int t) {
  const int pg = ps_log >= 0 ? t >> ps_log : t / ps;
  return static_cast<int64_t>(pages[pg]) * ps + (t - pg * ps);
}

// Stage rows [t0, t0 + n) (split-relative token indices) of one operand
// into dst, one row every dst_stride bytes: the row of token t lives at
// base + (slot * K + kh) * ld * es bytes, and row_bytes of it are copied
// in pieces of w bytes (w divides the base address, the row stride and
// row_bytes; 16, 8 and 4 go by cp.async).  Where a row's 16-byte pieces
// divide the block, each thread keeps one piece offset and steps over
// rows (no division a piece).
__device__ __forceinline__ void stage_rows(
    unsigned char* dst, int dst_stride, const unsigned char* base,
    int64_t head_off, int64_t slot_stride, int row_bytes, int w,
    const int* pages, int ps, int ps_log, int t0, int n) {
  const int per_row = row_bytes / w;
  if (w == 16 && kThreads % per_row == 0) {
    const int step = kThreads / per_row;
    const int r0 = threadIdx.x / per_row;
    const int off = (threadIdx.x - r0 * per_row) * 16;
    for (int r = r0; r < n; r += step)
      cp_async16(dst + r * dst_stride + off,
                 base + slot_of(pages, ps, ps_log, t0 + r) * slot_stride
                     + head_off + off);
    return;
  }
  const int total = n * per_row;
  for (int c = threadIdx.x; c < total; c += kThreads) {
    const int r = c / per_row;
    const int off = (c - r * per_row) * w;
    const int64_t slot = slot_of(pages, ps, ps_log, t0 + r);
    const unsigned char* src = base + slot * slot_stride + head_off + off;
    unsigned char* d = dst + r * dst_stride + off;
    if (w == 16) {
      cp_async16(d, src);
    } else if (w == 8) {
      cp_async8(d, src);
    } else if (w == 4) {
      cp_async4(d, src);
    } else if (w == 2) {
      *reinterpret_cast<uint16_t*>(d) =
          *reinterpret_cast<const uint16_t*>(src);
    } else {
      *d = *src;
    }
  }
}

__device__ __forceinline__ void store_out(void* out, int out_bf16, int64_t i,
                                          float x) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(out)[i] = x;
}

__device__ __forceinline__ int round16(int x) {
  return (x + 15) / 16 * 16;
}

// kOut: (head, feature) outputs a thread owns, tile_heads * vd <=
// kThreads * kOut; kMaxHd: the widest K row (kNarrowHd or kWideHd)
template <typename TKV, int kOut, int kMaxHd>
__global__ void __launch_bounds__(kThreads, 4) paged_attention_kernel(
    const void* __restrict__ q, int q_bf16,  // (B, H, hd) fp32 or bf16
    const TKV* __restrict__ k,                // (P, ps, K, hd)
    const TKV* __restrict__ v,                // (P, ps, K, v_ld)
    const __nv_bfloat16* __restrict__ k_scale,  // (P, ps, K) or null
    const __nv_bfloat16* __restrict__ v_scale,  // (P, ps, K) or null
    const int32_t* __restrict__ block_tables, int bt_stride,
    const int32_t* __restrict__ lengths, int len_stride,
    float* __restrict__ part_ml,   // (B, K, splits, g, 2) when splits > 1
    float* __restrict__ part_acc,  // (B, K, splits, g, vd) when splits > 1
    void* __restrict__ out,        // (B, H, vd) in q's dtype, splits == 1
    int num_kv_heads, int g, int hd, int v_ld, int vd, int ps, int m,
    int pages_per_split, int tile, int head_tiles, int tile_heads, int wk,
    int wv, float scale, float logit_cap, int window, int chunk) {
  using EL = Elem<TKV>;
  constexpr int es = sizeof(TKV);
  constexpr int E = EL::E;
  constexpr int kMaxChunks = (kMaxHd * es / 16 + 31) / 32;  // per lane
  // tokens a lane group scores at once: 32 K values a lane in flight
  constexpr int kTokPerLane = 32 / (kMaxChunks * E);
  extern __shared__ __align__(16) unsigned char smem[];
  const int kb = round16(hd * es);   // K row bytes in shared memory
  const int vb = round16(vd * es);
  const int row_b = kb > vb ? kb : vb;
  const int hdq = kb / es;            // q row length (floats), zero-padded
  const int split_tokens = pages_per_split * ps;
  const bool quant = k_scale != nullptr;
  // only the wide form takes head tiles (the launcher sends every tiled
  // shape there); in the narrow forms a block owns the KV head's group
  constexpr bool kTiles = kMaxHd == kWideHd;
  const int heads = kTiles ? tile_heads : g;
  // the layout that kernels/paged_attention.py::split_smem_bytes counts
  // (for the block's heads); the launch asks for that count
  float* q_s = reinterpret_cast<float*>(smem + kStages * tile * row_b);
  float* s_s = q_s + heads * hdq;                    // (heads, split_tokens)
  float* ks_s = s_s + heads * split_tokens;          // (split_tokens,)
  float* vs_s = ks_s + (quant ? split_tokens : 0);   // (split_tokens,)
  float* m_s = vs_s + (quant ? split_tokens : 0);    // (heads,)
  float* l_s = m_s + heads;                          // (heads,)
  int* pages_s = reinterpret_cast<int*>(l_s + heads);  // (pages_per_split,)

  // blockIdx.x = (KV head, head tile); the block owns query heads
  // g0 .. g0 + gb - 1 of its KV head's group
  const int kh = kTiles ? blockIdx.x / head_tiles : blockIdx.x;
  const int g0 = kTiles ? (blockIdx.x - kh * head_tiles) * tile_heads : 0;
  const int gb = kTiles ? min(tile_heads, g - g0) : g;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int num_splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_heads = num_kv_heads * g;
  const int n_out = gb * vd;
  const int64_t bk = static_cast<int64_t>(b) * num_kv_heads + kh;

  // prologue: the row's length and the split's page ids in flight
  // together; an empty split leaves after that one round trip
  const int length = lengths[static_cast<int64_t>(b) * len_stride];
  const int first_page = split * pages_per_split;
  for (int i = tid; i < pages_per_split; i += kThreads)
    pages_s[i] = first_page + i < m
        ? block_tables[static_cast<int64_t>(b) * bt_stride + first_page + i]
        : 0;

  // visible span [lo, hi) of the row: kv_pos < length, above the window
  // / chunk floors of the query at length - 1; then this split's part
  const int q_pos = length - 1;
  int lo = 0;
  if (window > 0) lo = max(lo, q_pos - window + 1);
  if (chunk > 0 && q_pos >= 0) lo = max(lo, (q_pos / chunk) * chunk);
  const int hi = min(length, m * ps);
  const int s0 = first_page * ps;
  const int v0 = max(lo, s0) - s0;                                 // split-
  const int v1 = min(hi, min(s0 + split_tokens, m * ps)) - s0;     // relative
  const int n_vis = v1 - v0;
  if (n_vis <= 0) {             // the same for every thread of the block
    if (num_splits == 1) {
      for (int o = tid; o < n_out; o += kThreads)
        store_out(out, q_bf16,
                  (static_cast<int64_t>(b) * num_heads + kh * g + g0) * vd
                      + o,
                  0.f);
    } else {
      for (int gi = tid; gi < gb; gi += kThreads) {
        float* ml =
            part_ml + ((bk * num_splits + split) * g + g0 + gi) * 2;
        ml[0] = kNegInf;
        ml[1] = 0.f;
      }
    }
    return;
  }
  if ((hd * es) % 16 != 0) {    // K rows end short of 16 bytes: zero tails
    uint4* z = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < kStages * tile * row_b / 16; i += kThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();              // page ids and zeroed tails in place

  const int ps_log = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  const int n_tiles = (n_vis + tile - 1) / tile;
  const int n_loads = 2 * n_tiles;   // K tiles, then V tiles
  const auto* kbase = reinterpret_cast<const unsigned char*>(k);
  const auto* vbase = reinterpret_cast<const unsigned char*>(v);
  const int64_t k_head = static_cast<int64_t>(kh) * hd * es;
  const int64_t v_head = static_cast<int64_t>(kh) * v_ld * es;
  const int64_t k_slot = static_cast<int64_t>(num_kv_heads) * hd * es;
  const int64_t v_slot = static_cast<int64_t>(num_kv_heads) * v_ld * es;
  // load j (K tiles, then V tiles) into stage j % kStages; a load past
  // the last commits an empty group, so the group count stays in step
  auto issue = [&](int j) {
    unsigned char* dst = smem + (j % kStages) * tile * row_b;
    if (j >= n_loads) {
      cp_async_commit();
      return;
    }
    const int jt = j < n_tiles ? j : j - n_tiles;
    const int t0 = v0 + jt * tile;
    const int n = min(tile, v1 - t0);
    if (j < n_tiles)
      stage_rows(dst, kb, kbase, k_head, k_slot, hd * es, wk, pages_s, ps,
                 ps_log, t0, n);
    else
      stage_rows(dst, vb, vbase, v_head, v_slot, vd * es, wv, pages_s, ps,
                 ps_log, t0, n);
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue(j);
  // q (scaled, fp32) and the split's int8 scales, while the first tiles
  // are in flight
  const int64_t q_row =
      (static_cast<int64_t>(b) * num_heads + kh * g + g0) * hd;
  for (int i = tid; i < gb * hdq; i += kThreads) {
    const int gi = i / hdq, d = i - gi * hdq;
    float x = 0.f;
    if (d < hd) {
      const int64_t at = q_row + static_cast<int64_t>(gi) * hd + d;
      x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at])
                 : static_cast<const float*>(q)[at];
    }
    q_s[i] = x * scale;
  }
  if (quant) {
    for (int i = tid; i < n_vis; i += kThreads) {
      const int64_t at =
          slot_of(pages_s, ps, ps_log, v0 + i) * num_kv_heads + kh;
      ks_s[i] = __bfloat162float(k_scale[at]);
      vs_s[i] = __bfloat162float(v_scale[at]);
    }
  }

  // scores: lpt lanes per token (the next power of two >= the row's
  // 16-byte chunks, at most 32), each lane kMaxChunks chunks at most
  const int chunks = kb / 16;
  int lpt = 1;
  while (lpt < chunks && lpt < 32) lpt <<= 1;
  const int tpw = 32 / lpt;      // tokens a warp scores at once
  const int sub = lane / lpt;
  const int li = lane - sub * lpt;

  float acc[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) acc[r] = 0.f;

  for (int j = 0; j < n_loads; ++j) {
    cp_async_wait<kStages - 2>();
    // tile j (and q, the scales) visible to all; every thread is done
    // with iteration j - 1, so its stage may take load j + kStages - 1
    __syncthreads();
    issue(j + kStages - 1);
    const unsigned char* buf = smem + (j % kStages) * tile * row_b;
    const int jt = j < n_tiles ? j : j - n_tiles;
    const int i0 = jt * tile;   // index of the tile's first visible token
    const int nt = min(tile, n_vis - i0);
    if (j < n_tiles) {
      // a warp scores kTokPerLane * tpw tokens a pass: independent dot /
      // shuffle chains a lane
      constexpr int U = kTokPerLane;
      for (int base = warp * tpw * U; base < nt; base += kWarps * tpw * U) {
        float kr[U][kMaxChunks][E];
        float ksc[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = base + u * tpw + sub;
          ok[u] = t < nt;
#pragma unroll
          for (int c = 0; c < kMaxChunks; ++c) {
            const int ch = li + c * lpt;
            if (ok[u] && ch < chunks) {
              EL::unpack(
                  *reinterpret_cast<const uint4*>(buf + t * kb + ch * 16),
                  kr[u][c]);
            } else {
#pragma unroll
              for (int e = 0; e < E; ++e) kr[u][c][e] = 0.f;
            }
          }
          ksc[u] = quant && ok[u] ? ks_s[i0 + t] : 1.f;
        }
        for (int gi = 0; gi < gb; ++gi) {
          float part[U];
#pragma unroll
          for (int u = 0; u < U; ++u) part[u] = 0.f;
#pragma unroll
          for (int c = 0; c < kMaxChunks; ++c) {
            const int ch = li + c * lpt;
            if (ch < chunks) {
              const float4* qq =
                  reinterpret_cast<const float4*>(q_s + gi * hdq + ch * E);
#pragma unroll
              for (int e4 = 0; e4 < E / 4; ++e4) {
                const float4 x = qq[e4];
#pragma unroll
                for (int u = 0; u < U; ++u)
                  part[u] += x.x * kr[u][c][4 * e4]
                             + x.y * kr[u][c][4 * e4 + 1]
                             + x.z * kr[u][c][4 * e4 + 2]
                             + x.w * kr[u][c][4 * e4 + 3];
              }
            }
          }
          for (int o = lpt >> 1; o > 0; o >>= 1) {
#pragma unroll
            for (int u = 0; u < U; ++u)
              part[u] += __shfl_xor_sync(0xffffffffu, part[u], o);
          }
          if (li == 0) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
              if (ok[u]) {
                float sc = part[u] * ksc[u];
                if (logit_cap > 0.f) sc = tanhf(sc / logit_cap) * logit_cap;
                s_s[gi * split_tokens + i0 + base + u * tpw + sub] = sc;
              }
            }
          }
        }
      }
      if (j == n_tiles - 1) {
        __syncthreads();        // every score of the split written
        // exact softmax statistics over the split: one warp a query head;
        // P keeps the int8 V scale folded in
        for (int gi = warp; gi < gb; gi += kWarps) {
          float* row = s_s + gi * split_tokens;
          float mx = kNegInf;
          for (int i = lane; i < n_vis; i += 32) mx = fmaxf(mx, row[i]);
          mx = warp_max(mx);
          float sum = 0.f;
          for (int i = lane; i < n_vis; i += 32) {
            const float p = expf(row[i] - mx);
            sum += p;
            row[i] = quant ? p * vs_s[i] : p;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            m_s[gi] = mx;
            l_s[gi] = sum;
          }
        }
      }
    } else {
      // acc += P V over the tile: threads across the flattened (head,
      // feature) outputs, neighbouring threads on neighbouring features
      const TKV* vt = reinterpret_cast<const TKV*>(buf);
      const int vstride = vb / es;
#pragma unroll
      for (int r = 0; r < kOut; ++r) {
        const int o = tid + r * kThreads;
        if (o < n_out) {
          const int gi = o / vd;
          const int d = o - gi * vd;
          const float* p = s_s + gi * split_tokens + i0;
          float a = acc[r];
#pragma unroll 4
          for (int t = 0; t < nt; ++t)
            a += p[t] * EL::one(vt, t * vstride + d);
          acc[r] = a;
        }
      }
    }
  }

  if (num_splits == 1) {        // n_vis > 0, so l >= 1
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int o = tid + r * kThreads;
      if (o < n_out)
        store_out(out, q_bf16,
                  (static_cast<int64_t>(b) * num_heads + kh * g + g0) * vd
                      + o,
                  acc[r] / l_s[o / vd]);
    }
    return;
  }
  float* pa = part_acc + ((bk * num_splits + split) * g + g0) * vd;
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int o = tid + r * kThreads;
    if (o < n_out) pa[o] = acc[r];
  }
  for (int gi = tid; gi < gb; gi += kThreads) {
    float* ml = part_ml + ((bk * num_splits + split) * g + g0 + gi) * 2;
    ml[0] = m_s[gi];
    ml[1] = l_s[gi];
  }
}

// One block per (KV head, row), or with kRuns (a shape with head tiles)
// per (KV head, row, run of kCombineThreads of its g * vd outputs), so
// the 10,240 outputs of an MLA row spread over 80 blocks: a running
// log-sum-exp merge of
// the splits that saw a token (l_s > 0), in split order; kCombineBatch
// splits' partials load at once (an empty split's acc is read but never
// used).  No such split (a row of length 0) gives exact zeros.
template <bool kRuns>
__global__ void __launch_bounds__(kCombineThreads)
    paged_attention_kernel_combine(const float* __restrict__ part_ml,
                                   const float* __restrict__ part_acc,
                                   void* __restrict__ out, int out_bf16,
                                   int num_kv_heads, int g, int vd,
                                   int num_splits) {
  // kRuns: runs of kCombineThreads outputs, one a block
  const int runs = kRuns ? (g * vd + kCombineThreads - 1) / kCombineThreads
                         : 1;
  const int kh = kRuns ? blockIdx.x / runs : blockIdx.x;
  const int o0 = kRuns ? (blockIdx.x - kh * runs) * kCombineThreads : 0;
  const int o1 = kRuns ? min(o0 + kCombineThreads, g * vd) : g * vd;
  const int b = blockIdx.y;
  const int64_t bk = static_cast<int64_t>(b) * num_kv_heads + kh;
  const float* ml = part_ml + bk * num_splits * g * 2;
  const float* pa = part_acc + bk * num_splits * g * vd;
  const int64_t out_row = bk * g * vd;   // (b * H + kh * g) * vd
  for (int o = o0 + threadIdx.x; o < o1; o += kCombineThreads) {
    const int gi = o / vd;
    float mx = kNegInf, l = 0.f, a = 0.f;
    for (int s0 = 0; s0 < num_splits; s0 += kCombineBatch) {
      float ms[kCombineBatch], ls[kCombineBatch], as[kCombineBatch];
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) {
        const int s = s0 + u;
        ls[u] = 0.f;
        if (s < num_splits) {
          const float* x = ml + (static_cast<int64_t>(s) * g + gi) * 2;
          ms[u] = x[0];
          ls[u] = x[1];
          as[u] = pa[static_cast<int64_t>(s) * g * vd + o];
        }
      }
#pragma unroll
      for (int u = 0; u < kCombineBatch; ++u) {
        if (ls[u] > 0.f) {
          const float m_new = fmaxf(mx, ms[u]);
          const float c = expf(mx - m_new);
          const float w = expf(ms[u] - m_new);
          l = l * c + ls[u] * w;
          a = a * c + as[u] * w;
          mx = m_new;
        }
      }
    }
    store_out(out, out_bf16, out_row + o, l > 0.f ? a / l : 0.f);
  }
}

// Largest of 16, 8, 4, 2, 1 bytes that divides the base address, the row
// stride and the bytes copied of a row.
int copy_width(const void* base, int64_t stride, int64_t row_bytes) {
  const uint64_t x = reinterpret_cast<uint64_t>(base)
                     | static_cast<uint64_t>(stride)
                     | static_cast<uint64_t>(row_bytes);
  int w = 16;
  while (w > 1 && x % w != 0) w >>= 1;
  return w;
}

template <typename TKV, int kOut, int kMaxHd>
int launch(int q_bf16, const void* q, const void* k, const void* v,
           const void* k_scale, const void* v_scale,
           const int32_t* block_tables, int bt_stride, const int32_t* lengths,
           int len_stride, float* part_ml, float* part_acc, void* out,
           int batch, int num_kv_heads, int g, int hd, int v_ld, int vd,
           int ps, int m, int pages_per_split, int num_splits, int tile,
           int smem, int head_tiles, int tile_heads, float scale,
           float logit_cap, int window, int chunk, cudaStream_t stream) {
  constexpr int es = sizeof(TKV);
  auto kernel = paged_attention_kernel<TKV, kOut, kMaxHd>;
  // the attribute is per device: raise it to the opt-in limit once on
  // each (bit = device id); the launch asks only for what it needs
  static std::atomic<uint64_t> attr_set{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = 1ull << (device & 63);
  if (!(attr_set.load(std::memory_order_relaxed) & bit)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const int wk = copy_width(k, static_cast<int64_t>(hd) * es,
                            static_cast<int64_t>(hd) * es);
  const int wv = copy_width(v, static_cast<int64_t>(v_ld) * es,
                            static_cast<int64_t>(vd) * es);
  const dim3 grid(num_kv_heads * head_tiles, batch, num_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, q_bf16, static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), block_tables, bt_stride,
      lengths, len_stride, part_ml, part_acc, out, num_kv_heads, g, hd, v_ld,
      vd, ps, m, pages_per_split, tile, head_tiles, tile_heads, wk, wv, scale,
      logit_cap, window, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || num_splits == 1) return static_cast<int>(err);
  if (head_tiles == 1) {
    paged_attention_kernel_combine<false><<<dim3(num_kv_heads, batch),
                                            kCombineThreads, 0, stream>>>(
        part_ml, part_acc, out, q_bf16, num_kv_heads, g, vd, num_splits);
  } else {
    const int runs = (g * vd + kCombineThreads - 1) / kCombineThreads;
    paged_attention_kernel_combine<true><<<dim3(num_kv_heads * runs, batch),
                                           kCombineThreads, 0, stream>>>(
        part_ml, part_acc, out, q_bf16, num_kv_heads, g, vd, num_splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block may opt into on a device (the limit the wrapper's
// plan fits a split block into).  Returns the cudaError_t of the query.
extern "C" int paged_attention_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pages only).  The
// plan (pages_per_split, num_splits, tile, smem, the split block's
// dynamic shared memory, and head_tiles tiles of tile_heads query heads a
// KV head) comes from the wrapper's paged_plan; with num_splits > 1,
// part_ml / part_acc are fp32 scratch of B * K * num_splits * g * 2 and
// * vd floats.  logit_cap <= 0, window <= 0 and chunk <= 0 mean "off".
// Returns the cudaError_t of the launches (0 = success).
extern "C" int paged_attention_launch(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, const void* block_tables,
    int bt_stride, const void* lengths, int len_stride, void* part_ml,
    void* part_acc, void* out, int batch, int num_kv_heads, int g, int hd,
    int v_ld, int vd, int ps, int m, int pages_per_split, int num_splits,
    int tile, int smem, int head_tiles, int tile_heads, float scale,
    float logit_cap, int window, int chunk, void* stream) {
  if (q_dtype < 0 || q_dtype > 1 || pages_per_split < 1 || num_splits < 1
      || tile < 1 || smem < 1 || hd < 1 || hd > kWideHd || vd < 1
      || vd > v_ld || head_tiles < 1 || tile_heads < 1
      || tile_heads * vd > kThreads * kMaxOutPerThread
      || head_tiles * tile_heads < g || (head_tiles - 1) * tile_heads >= g
      || (num_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* bt = static_cast<const int32_t*>(block_tables);
  const auto* ln = static_cast<const int32_t*>(lengths);
  auto* ml = static_cast<float*>(part_ml);
  auto* pa = static_cast<float*>(part_acc);
  const auto st = static_cast<cudaStream_t>(stream);
  // outputs a thread owns: 1 up to g * vd = 128 (the served MHA shapes),
  // 4 up to 512, else 16; rows past kNarrowHd and shapes with head tiles
  // take the wide form, whose one instantiation owns 16
  const int n_out = tile_heads * vd;
  const int outs = hd > kNarrowHd || head_tiles > 1 ? 0
                   : n_out <= kThreads     ? 1
                   : n_out <= 4 * kThreads ? 4
                                           : 16;
#define PA_LAUNCH(TKV, OUT, HD)                                              \
  if (outs == (HD == kWideHd ? 0 : OUT))                                    \
  return launch<TKV, OUT, HD>(q_dtype, q, k, v, k_scale, v_scale, bt,        \
                              bt_stride, ln, len_stride, ml, pa, out, batch, \
                              num_kv_heads, g, hd, v_ld, vd, ps, m,          \
                              pages_per_split, num_splits, tile, smem,       \
                              head_tiles, tile_heads, scale, logit_cap,      \
                              window, chunk, st)
#define PA_LAUNCH_OUTS(TKV)       \
  PA_LAUNCH(TKV, 1, kNarrowHd);   \
  PA_LAUNCH(TKV, 4, kNarrowHd);   \
  PA_LAUNCH(TKV, 16, kNarrowHd);  \
  PA_LAUNCH(TKV, 16, kWideHd)
  if (kv_dtype == 0) { PA_LAUNCH_OUTS(float); }
  if (kv_dtype == 1) { PA_LAUNCH_OUTS(__nv_bfloat16); }
  if (kv_dtype == 2) { PA_LAUNCH_OUTS(int8_t); }
#undef PA_LAUNCH_OUTS
#undef PA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
