// Flash attention over a whole prompt (prefill) in bf16 for Hopper
// (sm_90a): the tensor-core variant of K3.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body _attn_kernel) for bf16 operands; fp32 operands
// go to csrc/flash_attention.cu (the SIMT variant).  The wrapper picks
// the variant by dtype (kernels/flash_attention.py::flash_plan).  It
// computes what the plain version flash_attention_plain computes: q
// (B, S, H, hd), k (B, T, K, hd), v (B, T, K, vd), H % K == 0, out
// (B, S, H, vd) bf16; top-left causal alignment (query i sees keys <= i
// whatever T is), then kv < T, the window (kv > q - window) and the
// chunk floor (kv >= (q / chunk) * chunk); a tanh logit cap before the
// masks; an online softmax in fp32 with the denominator clamped at
// 1e-30; a masked entry's probability is exactly 0.  Rounding differs
// from the plain version at two points: the scores are a bf16 product
// accumulated in fp32 and scaled after it (the plain version scales q in
// fp32 first), and P is rounded to bf16 before P V.
//
// What bounds it at the served shape (codeqwen1.5-7b's 1024-token
// prefill: B=1, S=T=1024, H=K=32, hd=vd=128, causal): moving q, k, v and
// out once is 33.6 MB, 0.0100 ms at 3.35 TB/s; the live causal half of
// the two products is 8.6 GFLOP, 0.0087 ms at 989 TFLOP/s bf16.  The two
// bounds are within 15% of each other, so the design keeps the tensor
// cores fed and reads each byte once:
//  - Operations: both products are warpgroup MMAs.  S = Q K^T is wgmma
//    m64n64k16 with Q and the K tile in shared memory; O += P V is wgmma
//    m64n{D}k16 with P as the register A operand (the fp32 S accumulator
//    packs pairwise into the bf16 A fragment, no shuffle) and the V tile
//    as the shared-memory B operand read MN-major (V sits key-major).
//    Only the diagonal tile, the ragged end of T and a window's or
//    chunk's edge tiles run the per-element mask; interior tiles skip it.
//    Under the causal rule the plan asks for the q tiles longest first
//    (longest_first: blockIdx.y counts the tiles down), so the tail wave
//    holds the short tiles.
//  - Bytes: one block per (64 query rows, KV head, batch row) serves all
//    g heads of a GQA group (64 / g positions x g heads), so each K/V tile
//    is read once per group, and the loop visits only the key tiles
//    between the block's first and last visible key.  One producer warp
//    keeps a 2-stage ring of 64-key K/V tiles in flight with TMA
//    (cp.async.bulk.tensor into 128-byte-swizzled tiles, which the wgmma
//    descriptors read as they land); a stage completes on its "full"
//    mbarrier and is handed back on its "empty" one once the P V product
//    that read it has retired.  Q is loaded once.  The tensor maps
//    describe q, k and v in place, and TMA's out-of-bounds zero fill
//    covers the ragged S / T edges and head widths below the padded one
//    D (64, 128 or 256; hd and vd share it), so no load is masked.  Two
//    blocks fit an SM at D = 128 (81 KB of shared memory each), so one
//    block's softmax overlaps the other's products.
// What it leaves out: persistent blocks, two consumer warpgroups in
// ping-pong, overlap of the next tile's Q K^T with this tile's softmax
// inside a block, a TMA store of the output, and fp8.
#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int kRows = 64;                 // query rows of the warpgroup
constexpr int kBlockK = 64;               // keys per K/V tile
constexpr int kChunk = 64;                // bf16 columns per 128-byte row
constexpr int kChunkBytes = 64 * 128;     // 64 rows of one 128-byte chunk
constexpr int kStages = 2;                // K/V ring depth
constexpr int kConsumers = 128;           // one warpgroup
constexpr int kThreads = kConsumers + 32; // + one producer warp
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the completion of the barrier's phase of parity ``parity``.
// A wrong parity or byte count would hang the block.  As a guard, after
// every 4096 failed tries (each suspends the thread for a while; a tile
// lands in microseconds) it reads the clock, and after two seconds it
// traps, so a protocol fault surfaces as a launch error, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t tries = 0;
  uint64_t t_first = 0;
  while (!mbar_try_wait(addr, parity)) {
    if (++tries % 4096 != 0) continue;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t_first == 0) t_first = now;
    else if (now - t_first > 2000000000ull) __trap();
  }
}

// ---- TMA -----------------------------------------------------------------

// One box of a 4-d tensor map into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor for a 128-byte-swizzled operand whose
// tile base is 1024-byte aligned: start address, leading and stride byte
// offsets (16-byte units), layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (1ull << 62);
}

// K-major (Q, K tile): rows of 128 bytes, 8-row groups 1024 bytes apart;
// the leading offset is unused under the swizzle.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}

// MN-major (V tile read as the K x N operand of P V): 8-key groups 1024
// bytes apart, 64-column chunks kChunkBytes apart.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, kChunkBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins registers an in-flight wgmma reads or writes to this point of the
// program, so the compiler neither reads an accumulator before the wait
// nor reuses an A-operand register before the product retired.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d (m64n64, fp32) = (scale_d ? d : 0) + A (shared, K-major) x B (shared,
// K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64n{N}, fp32) += A (registers, bf16 P) x B (shared, MN-major V)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123,"
      "%124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Per-tile softmax on one thread's share of the S accumulator: 32 scores
// of two rows (row r0 where i % 4 < 2, else r0 + 8) x 16 keys (key t0 +
// 8 (i / 4) + key_lane + i % 2).  Scores are scaled (and capped) into the
// log2 domain; masked entries become -inf and then p = 0.  Updates the
// running max m and sum l of each row and returns in ``corr`` the factor
// by which the output accumulator must be rescaled.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2], int t0,
    int key_lane, const int (&lo)[2], const int (&hi)[2], float scale,
    float logit_cap) {
  float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i] * scale;
    if (logit_cap > 0.f) x = tanhf(x / logit_cap) * logit_cap;
    x *= kLog2e;
    if (kMasked) {
      const int kv = t0 + 8 * (i / 4) + key_lane + (i & 1);
      if (kv < lo[r] || kv > hi[r]) x = -INFINITY;
    }
    s[i] = x;
    mt[r] = fmaxf(mt[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the four lanes of a row hold its 64 keys
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m[r], mt[r]);
    // a row that has seen no visible key yet keeps corr = 1 and p = 0
    corr[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float p;
    if (kMasked) p = s[i] == -INFINITY ? 0.f : exp2f(s[i] - m[r]);
    else p = exp2f(s[i] - m[r]);
    s[i] = p;
    sum[r] += p;
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// D: the padded head width of q, k and v (64, 128 or 256).  Block
// (blockIdx.x = kv head + K * batch row, blockIdx.y = q tile, counted from
// the last when longest_first): warps 0-3 are the consumer warpgroup, warp
// 4 the producer.
// Row rr of the block's 64 is position q0 + rr / g of query head
// kh * g + rr % g (the order in which the Q box lands).
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_attention_sm90_kernel(
    // maps of (hd, H, S, B), box (64, g, bq, 1); (hd, K, T, B) and
    // (vd, K, T, B), box (64, 1, 64, 1)
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    __nv_bfloat16* __restrict__ out,             // (B, S, H, vd)
    float* __restrict__ lse,                     // (B, H, S) or null
    int seq_len, int kv_len, int num_kv_heads, int g, int vd, int block_q,
    int longest_first, float scale, float logit_cap, int causal, int window,
    int chunk) {
  constexpr int kChunks = D / kChunk;
  constexpr int kTileBytes = kChunks * kChunkBytes;   // Q, a K or a V tile
  constexpr int kStageBytes = 2 * kTileBytes;

  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles want 1024-byte alignment; the launch adds the slack
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* kv_s = q_s + kTileBytes;                // kStages x (K, V)
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + kStages * kStageBytes);
  uint64_t* full = bars;                           // [kStages]
  uint64_t* empty = bars + kStages;                // [kStages]
  uint64_t* q_full = bars + 2 * kStages;

  const int kh = blockIdx.x % num_kv_heads;
  const int b = blockIdx.x / num_kv_heads;
  const int q_tile = longest_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * block_q;
  const int rows = g * block_q;                    // <= 64 valid rows

  // the block's visible key span [kv_lo, kv_hi]: the first query sets the
  // lower bound, the last the upper one
  const int q_last = min(q0 + block_q, seq_len) - 1;
  int kv_lo = 0;
  if (window > 0) kv_lo = max(kv_lo, q0 - window + 1);
  if (chunk > 0) kv_lo = max(kv_lo, (q0 / chunk) * chunk);
  const int kv_hi = causal ? min(kv_len - 1, q_last) : kv_len - 1;
  const int tile_begin = kv_lo / kBlockK;
  const int num_tiles = kv_hi / kBlockK - tile_begin + 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);                     // the producer's expect_tx
      mbar_init(&empty[st], kConsumers);           // every consumer thread
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // no block-wide barrier after this point: the roles never reconverge

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // ---- producer: one thread issues every TMA load --------------------
    if (lane != 0) return;
    mbar_expect_tx(q_full, kChunks * rows * 128);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(q_s + c * kChunkBytes, &q_map, q_full, c * kChunk, kh * g,
                  q0, b);
    for (int it = 0; it < num_tiles; ++it) {
      const int st = it % kStages;
      // refill a stage once the consumers released its previous round
      if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
      uint8_t* k_dst = kv_s + st * kStageBytes;
      uint8_t* v_dst = k_dst + kTileBytes;
      const int t0 = (tile_begin + it) * kBlockK;
      mbar_expect_tx(&full[st], kStageBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        tma_load_4d(k_dst + c * kChunkBytes, &k_map, &full[st], c * kChunk,
                    kh, t0, b);
        tma_load_4d(v_dst + c * kChunkBytes, &v_map, &full[st], c * kChunk,
                    kh, t0, b);
      }
    }
    return;
  }

  // ---- consumers: the warpgroup's 64 rows ------------------------------
  // a thread owns rows r_base and r_base + 8 of the tile and keys / output
  // columns 8 j + key_lane + {0, 1} of each 8-wide slice j
  const int r_base = warp * 16 + lane / 4;
  const int key_lane = 2 * (lane % 4);
  int pos[2], lo[2], hi[2];
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r_base + 8 * r;
    pos[r] = q0 + rr / g;
    ok[r] = rr < rows && pos[r] < seq_len;
    lo[r] = 0;
    if (window > 0) lo[r] = max(lo[r], pos[r] - window + 1);
    if (chunk > 0) lo[r] = max(lo[r], (pos[r] / chunk) * chunk);
    hi[r] = ok[r] ? (causal ? min(pos[r], kv_len - 1) : kv_len - 1) : -1;
  }
  // a tile needs the per-element mask unless every key of it is visible
  // to every row of the block (rows past S or past g * block_q skip the
  // mask too in such a tile: each row of the products stands alone, and
  // those rows are never stored)
  const int full_lo = max(window > 0 ? q_last - window + 1 : 0,
                          chunk > 0 ? (q_last / chunk) * chunk : 0);
  const int full_hi = causal ? min(q0, kv_len - 1) : kv_len - 1;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(q_s);

  mbar_wait(q_full, 0);
  for (int it = 0; it < num_tiles; ++it) {
    const int st = it % kStages;
    const int t0 = (tile_begin + it) * kBlockK;
    const uint32_t k_addr = smem_u32(kv_s + st * kStageBytes);
    const uint32_t v_addr = k_addr + kTileBytes;
    mbar_wait(&full[st], (it / kStages) & 1);

    // S = Q K^T over the padded width in k16 steps: 4 steps per 128-byte
    // chunk (+32 bytes inside the swizzled row), then the next chunk
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks / 4) * kChunkBytes + (ks % 4) * 32;
      wgmma_ss_n64(s, desc_k_major(q_addr + off), desc_k_major(k_addr + off),
                   ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float corr[2];
    const bool interior = t0 >= full_lo && t0 + kBlockK - 1 <= full_hi;
    if (interior)
      softmax_tile<false>(s, m, l, corr, t0, key_lane, lo, hi, scale,
                          logit_cap);
    else
      softmax_tile<true>(s, m, l, corr, t0, key_lane, lo, hi, scale,
                         logit_cap);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // P (bf16) as the A fragments of four k16 steps: the m64n64 fp32
    // accumulator's pairs (8 kk + 2 j, 8 kk + 2 j + 1) are exactly the
    // A operand's registers j of step kk
    uint32_t pa[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) pa[j] = pack_bf16x2(s[2 * j], s[2 * j + 1]);

    // O += P V over the tile's 64 keys in k16 steps of 16 key rows
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                             pa[4 * kk + 3]};
      wgmma_rs<D>(o, a, desc_mn_major(v_addr + kk * 16 * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&empty[st]);                       // the stage may refill
  }

  // epilogue: the row sums over the four lanes of a row, then out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int num_heads = num_kv_heads * g;
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!ok[r]) continue;
    const int rr = r_base + 8 * r;
    const int head = kh * g + rr % g;
    // the row's log-sum-exp for the backward (K3's gradient), back from
    // the log2 domain; the four lanes of a row hold the same m and l
    if (lse != nullptr && key_lane == 0)
      lse[(static_cast<int64_t>(b) * num_heads + head) * seq_len + pos[r]] =
          (m[r] + log2f(l[r])) * 0.6931471805599453f;
    __nv_bfloat16* o_row =
        out + ((static_cast<int64_t>(b) * seq_len + pos[r]) * num_heads + head)
              * vd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + key_lane;            // even; vd % 8 == 0
      if (col < vd) {
        const uint32_t packed = pack_bf16x2(o[4 * j + 2 * r] * inv[r],
                                            o[4 * j + 2 * r + 1] * inv[r]);
        *reinterpret_cast<uint32_t*>(o_row + col) = packed;
      }
    }
  }
}

// ---- host ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime already loaded, so
// the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d bf16 map of a contiguous (d3, d2, d1, d0) tensor (d0 innermost)
// with a (64, box1, box2, 1) box, 128-byte swizzle, zero fill outside.
CUresult encode_4d(EncodeTiled encode, CUtensorMap* map, const void* base,
                   uint64_t d0, uint64_t d1, uint64_t d2, uint64_t d3,
                   uint32_t box1, uint32_t box2) {
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kChunk), box1, box2, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeFailed = 1000;   // + the CUresult of a failed encode

// Dynamic shared memory of a launch: Q, the K/V ring, the barriers and
// the slack that aligns the tiles to 1024 bytes.
size_t smem_bytes(int d) {
  return 1024 + static_cast<size_t>(1 + 2 * kStages) * (d / kChunk)
                    * kChunkBytes
         + (2 * kStages + 1) * sizeof(uint64_t);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int batch, int seq_len, int kv_len, int num_kv_heads, int g,
           int hd, int vd,
           int block_q, int longest_first, float scale, float logit_cap,
           int causal, int window, int chunk, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int num_heads = num_kv_heads * g;
  CUtensorMap q_map, k_map, v_map;
  CUresult res = encode_4d(encode, &q_map, q, hd, num_heads, seq_len, batch,
                           g, block_q);
  if (res == CUDA_SUCCESS)
    res = encode_4d(encode, &k_map, k, hd, num_kv_heads, kv_len, batch, 1,
                    kBlockK);
  if (res == CUDA_SUCCESS)
    res = encode_4d(encode, &v_map, v, vd, num_kv_heads, kv_len, batch, 1,
                    kBlockK);
  if (res != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(res);

  const size_t smem = smem_bytes(D);
  auto kernel = flash_attention_sm90_kernel<D>;
  // the attribute is per device: set it once on each (bit = device id)
  static std::atomic<uint64_t> attr_set{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = 1ull << (device & 63);
  if (!(attr_set.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid(num_kv_heads * batch, (seq_len + block_q - 1) / block_q);
  kernel<<<grid, kThreads, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), seq_len, kv_len, num_kv_heads, g, vd, block_q,
      longest_first, scale, logit_cap, causal, window, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v and out, contiguous, 16-byte aligned; ``width`` (the padded
// head width D) in {64, 128, 256} with hd, vd <= width, hd and vd
// multiples of 8 (TMA strides); g * block_q <= 64 (the wrapper's plan
// checks all of it).  longest_first != 0 runs the q tiles from the last.
// lse, where not null, receives each row's log-sum-exp of its (scaled,
// capped) visible scores, (B, H, S) fp32.  logit_cap <= 0, window <= 0
// and chunk <= 0 mean "off".  Returns the cudaError_t of the launch (0 =
// success), or 1000 + the CUresult of a tensor-map encode the CUDA driver
// refused.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int seq_len, int kv_len, int num_kv_heads, int g, int hd,
    int vd, int width, int block_q, int longest_first, float scale, float logit_cap,
    int causal, int window, int chunk, void* stream) {
  if (g * block_q > kRows || block_q < 1 || hd > width || vd > width
      || hd % 8 != 0 || vd % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define FA_LAUNCH(D)                                                        \
  if (width == D)                                                           \
    return launch<D>(q, k, v, out, lse, batch, seq_len, kv_len,            \
                     num_kv_heads, g, hd, vd, block_q, longest_first, scale, \
                     logit_cap, causal, window, chunk, st)
  FA_LAUNCH(64);
  FA_LAUNCH(128);
  FA_LAUNCH(256);
#undef FA_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// Bytes of dynamic shared memory a launch at padded width ``width`` asks
// for.
extern "C" int flash_attention_sm90_smem(int width) {
  return static_cast<int>(smem_bytes(width));
}

// Keys per K/V tile: a block walks the tiles between its first and last
// visible key.
extern "C" int flash_attention_sm90_block_k() { return kBlockK; }
