// Mamba-1 selective scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/selective_scan.py::
// selective_scan (body _scan_kernel).  For x, dt (B, S, d_in), B_t, C_t
// (B, S, n), A (d_in, n) and D (d_in,), each channel (b, d) runs
//   h = exp(dt_t * A[d]) * h + (dt_t * x_t) * B_t     (n states)
//   y_t = h . C_t + D[d] * x_t
// in order over t, from the start state h0 (zeros when none is given),
// and returns y (B, S, d_in) fp32 and the final state h_final
// (B, d_in, n) fp32.  Three changes from the TPU kernel: it takes h0
// (a prefill that continues a cached state), it returns h_final (the
// prefill-to-decode hand-off) and it adds D * x itself.  Any S (0
// included: h_final = h0) and any d_in are taken; x comes in fp32 or
// bf16 and is upcast in registers; dt, B, C, A, D and h0 are fp32 (the
// Mamba block computes dt, B and C in fp32); n is 1 to 64.
//
// What bounds it: per (t, d, n) one exponential on the SFU (MUFU, 16 a
// clock per SM) and 4 fp32 operations (dt * A, (dt x) * B, the h FMA,
// the y FMA; 128 a clock); per (t, d) x, dt and y cross device memory
// once.  At the served
// prefill (B = 2, S = 1024, d_in = 8192, n = 16, bf16 x) the 268 M
// exponentials bound it at ~0.064 ms, the bytes (~170 MB) at ~0.051 ms.
// A warp's MUFU op takes 8 issue cycles of the SFU, so the kernel nears
// its bound only if a state costs fewer than 8 instructions in all and
// the SFU never waits for a dependent chain:
//  - Exponentials as ex2.approx.ftz.f32 on a pre-scaled A.  A * log2(e)
//    is loaded into registers once a block, so a decay is one multiply
//    and one MUFU op (expf adds range reduction and fix-ups on the FMA
//    pipe around the same MUFU op).  Its error is a few ulp; a decay is
//    <= 1, so the error does not grow along t, and a decay below 2^-126
//    flushes to 0, its limit.
//  - 8 states a thread: a channel's n states (padded to a power of two
//    >= 8) sit on n_pad / 8 neighbouring lanes, 2 at the served n = 16.
//    What a time step costs a thread besides its states (dt and x from
//    shared memory, dt x, D x, the y reduction and store) is shared by 8
//    states instead of 4.
//  - Several time steps in flight a thread.  A run of kRun = 4 steps
//    reads its dt, x, B_t and C_t from shared memory and computes its 32
//    decays and (dt x) B_t products, which do not depend on h, before it
//    walks the h chain (one FMA a step a state); two runs are unrolled,
//    so one run's chain and reduction overlap the next run's MUFU ops.
//    y's sum over a channel's lanes is deferred to once a run: the
//    run's 4 partial sums go through a transpose-reduce (2 lanes: one
//    exchange of two values, two shuffles instead of four; 4 lanes:
//    three instead of eight), after which each lane holds whole steps'
//    y and stores them, so every lane stores.  D * x enters the sum as
//    lane 0's starting value.
//  - Staged, double-buffered tiles.  A block of 64 threads (two warps,
//    so few wait at a barrier) serves 64 / lanes channels of one batch
//    row.  x, dt, B_t and C_t of kTile time steps (64 at the served
//    shape) go to shared memory with cp.async while the previous tile's
//    steps run.  x and dt rows of the block's channels are contiguous
//    along d_in and B_t, C_t rows along n, so each thread issues 16-byte
//    copies at fixed per-thread offsets (no division a piece) where the
//    base and the row stride allow, 4-byte copies otherwise (bf16 x
//    whose rows are not 16-byte aligned: 2-byte loads).  Rows past the
//    sequence, channels past d_in and state columns past n are
//    zero-filled, so a padded step (dt = x = 0) leaves h unchanged and
//    padded states never move.
//  - One pass over S.  A block walks its channels' whole sequence, so
//    the grid is (d_in / channels a block, B): 3.9 warps an SM at B = 1
//    and 7.8 at B = 2 of the served widths.  A chunked scan over S (two
//    passes, up to twice the exponentials) was measured slower than one
//    pass at both (PERF.md §6) and is not built.  No float atomics, so
//    two calls are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;       // two warps: few of them wait at a barrier
constexpr int kStatesPerLane = 8;
constexpr int kRun = 4;           // time steps in flight a thread
constexpr int kUnrollRuns = 2;    // runs the compiler may interleave
constexpr int kStages = 2;        // tiles in the cp.async ring
constexpr int kMaxState = 64;
constexpr int kMinBlocks = 6;     // blocks an SM: ptxas keeps <= 170 registers
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
// ScanArgs::vec: which operands go in 16-byte copies
constexpr int kVecX = 1, kVecDt = 2, kVecBC = 4;

// Shared-memory layout of a block with L lanes a channel (static: at
// most 48 KB, so no opt-in is needed).  A stage holds x
// (tile x chans, in x's dtype), dt (tile x chans), B_t and C_t
// (tile x n_pad each).
template <typename TX, int L>
struct Layout {
  static constexpr int kChans = kThreads / L;
  static constexpr int kNPad = kStatesPerLane * L;
  static constexpr int kTile = L == 1 ? 16 : L == 8 ? 32 : 64;
  static constexpr int kXBytes = kTile * kChans * int(sizeof(TX));
  static constexpr int kDtBytes = kTile * kChans * 4;
  static constexpr int kBBytes = kTile * kNPad * 4;
  static constexpr int kStageBytes = kXBytes + kDtBytes + 2 * kBBytes;
};

struct ScanArgs {
  const void* x;          // (B, S, d_in) fp32 or bf16
  const float* dt;        // (B, S, d_in)
  const float* bm;        // (B, S, n)
  const float* cm;        // (B, S, n)
  const float* a;         // (d_in, n)
  const float* dvec;      // (d_in,)
  const float* h0;        // (B, d_in, n) or nullptr (zeros)
  float* y;               // (B, S, d_in)
  float* h_final;         // (B, d_in, n)
  int batch, seqlen, d_in, n;
  int vec;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_size 0 zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage `rows` time steps starting at global row `row` (= b * S + t)
// into one stage of shared memory; rows up to kTile past them are zeros.
template <typename TX, int L>
__device__ __forceinline__ void stage_tile(const ScanArgs& p,
                                           unsigned char* buf, long long row,
                                           int rows, int d0, int tid) {
  using Lay = Layout<TX, L>;
  constexpr int T = Lay::kTile, C = Lay::kChans, NP = Lay::kNPad;
  TX* sx = reinterpret_cast<TX*>(buf);
  float* sdt = reinterpret_cast<float*>(buf + Lay::kXBytes);
  float* sb = reinterpret_cast<float*>(buf + Lay::kXBytes + Lay::kDtBytes);
  float* sc = sb + T * NP;
  const TX* x = static_cast<const TX*>(p.x);
  const long long d_in = p.d_in;

  if (p.vec & kVecX) {
    constexpr int kPer = 16 / int(sizeof(TX));
    constexpr int Q = C / kPer;                  // copies a row
    const int q = tid % Q, dc = d0 + q * kPer;
    for (int r = tid / Q; r < T; r += kThreads / Q) {
      const bool ok = r < rows && dc < p.d_in;
      cp_async16(sx + r * C + q * kPer, ok ? x + (row + r) * d_in + dc : x,
                 ok);
    }
  } else {
    const int col = tid % C, dc = d0 + col;
    for (int r = tid / C; r < T; r += kThreads / C) {
      const bool ok = r < rows && dc < p.d_in;
      if constexpr (sizeof(TX) == 4) {
        cp_async4(sx + r * C + col, ok ? x + (row + r) * d_in + dc : x, ok);
      } else {                                   // 2-byte rows: plain loads
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
        reinterpret_cast<unsigned short*>(sx)[r * C + col] =
            ok ? xs[(row + r) * d_in + dc] : 0;
      }
    }
  }
  if (p.vec & kVecDt) {
    constexpr int Q = C / 4;
    const int q = tid % Q, dc = d0 + q * 4;
    for (int r = tid / Q; r < T; r += kThreads / Q) {
      const bool ok = r < rows && dc < p.d_in;
      cp_async16(sdt + r * C + q * 4,
                 ok ? p.dt + (row + r) * d_in + dc : p.dt, ok);
    }
  } else {
    const int col = tid % C, dc = d0 + col;
    for (int r = tid / C; r < T; r += kThreads / C) {
      const bool ok = r < rows && dc < p.d_in;
      cp_async4(sdt + r * C + col, ok ? p.dt + (row + r) * d_in + dc : p.dt,
                ok);
    }
  }
  const long long n = p.n;
  if (p.vec & kVecBC) {                          // n % 4 == 0
    constexpr int Q = NP / 4;                    // copies a row
    const int q = tid % Q;
    for (int r = tid / Q; r < T; r += kThreads / Q) {
      const bool ok = r < rows && q * 4 < p.n;
      const long long off = (row + r) * n + q * 4;
      cp_async16(sb + r * NP + q * 4, ok ? p.bm + off : p.bm, ok);
      cp_async16(sc + r * NP + q * 4, ok ? p.cm + off : p.cm, ok);
    }
  } else {
    const int i = tid % NP;
    for (int r = tid / NP; r < T; r += kThreads / NP) {
      const bool ok = r < rows && i < p.n;
      const long long off = (row + r) * n + i;
      cp_async4(sb + r * NP + i, ok ? p.bm + off : p.bm, ok);
      cp_async4(sc + r * NP + i, ok ? p.cm + off : p.cm, ok);
    }
  }
}

// y of a run: acc[r] is this lane's partial sum of the run's step r.
// After the transpose-reduce lane l holds whole steps from run_step(l)
// on: step 2 (l & 1) + ((l >> 1) & 1) (L >= 4; lanes >= 4 hold copies),
// steps 2 (l & 1) and + 1 (L = 2), all four (L = 1).  yr points at y of
// step run_step(l); `left` counts the run's steps that exist from there.
template <int L>
__device__ __forceinline__ void store_run(const float (&acc)[kRun],
                                          int lane, float* yr,
                                          long long d_in, int left,
                                          bool store) {
  if constexpr (L == 1) {
#pragma unroll
    for (int r = 0; r < kRun; ++r)
      if (store && r < left) yr[r * d_in] = acc[r];
  } else {
    const bool b0 = lane & 1;
    const float w0 = (b0 ? acc[2] : acc[0]) +
                     __shfl_xor_sync(kFull, b0 ? acc[0] : acc[2], 1);
    const float w1 = (b0 ? acc[3] : acc[1]) +
                     __shfl_xor_sync(kFull, b0 ? acc[1] : acc[3], 1);
    if constexpr (L == 2) {
      if (store && left > 0) yr[0] = w0;
      if (store && left > 1) yr[d_in] = w1;
    } else {
      const bool b1 = lane & 2;
      float z = (b1 ? w1 : w0) + __shfl_xor_sync(kFull, b1 ? w0 : w1, 2);
#pragma unroll
      for (int o = 4; o < L; o <<= 1) z += __shfl_xor_sync(kFull, z, o);
      if (store && left > 0) yr[0] = z;
    }
  }
}

// The step of a run whose y lane `lane` stores first (see store_run).
template <int L>
__device__ __forceinline__ int run_step(int lane) {
  return L == 1 ? 0 : L == 2 ? 2 * (lane & 1)
                             : 2 * (lane & 1) + ((lane >> 1) & 1);
}

// The steps of one staged tile.  yr: this lane's y pointer at step
// run_step(lane) of the tile.
template <typename TX, int L>
__device__ __forceinline__ void scan_tile(const unsigned char* buf,
                                          int steps, int ch, int lane,
                                          float (&h)[kStatesPerLane],
                                          const float (&a2)[kStatesPerLane],
                                          float dd0, float* yr,
                                          long long d_in, bool store) {
  using Lay = Layout<TX, L>;
  constexpr int T = Lay::kTile, C = Lay::kChans, NP = Lay::kNPad;
  constexpr int S = kStatesPerLane;
  const TX* sx = reinterpret_cast<const TX*>(buf) + ch;
  const float* sdt = reinterpret_cast<const float*>(buf + Lay::kXBytes) + ch;
  const float* sb = reinterpret_cast<const float*>(
      buf + Lay::kXBytes + Lay::kDtBytes) + lane * S;
  const float* sc = sb + T * NP;
  const int first = run_step<L>(lane);
#pragma unroll kUnrollRuns
  for (int t0 = 0; t0 < steps; t0 += kRun) {
    float xv[kRun], dv[kRun], e[kRun][S], ub[kRun][S], cv[kRun][S];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      dv[r] = sdt[(t0 + r) * C];
      xv[r] = to_float(sx[(t0 + r) * C]);
      const float u = dv[r] * xv[r];
#pragma unroll
      for (int q = 0; q < S; q += 4) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(sb + (t0 + r) * NP + q);
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          e[r][q + k] = ex2(dv[r] * a2[q + k]);
          ub[r][q + k] = u * bv[k];
        }
        const float4 c4 =
            *reinterpret_cast<const float4*>(sc + (t0 + r) * NP + q);
        cv[r][q] = c4.x, cv[r][q + 1] = c4.y, cv[r][q + 2] = c4.z,
        cv[r][q + 3] = c4.w;
      }
    }
    float acc[kRun];
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      acc[r] = dd0 * xv[r];
#pragma unroll
      for (int k = 0; k < S; ++k) {
        h[k] = fmaf(e[r][k], h[k], ub[r][k]);
        acc[r] = fmaf(h[k], cv[r][k], acc[r]);
      }
    }
    store_run<L>(acc, lane, yr, d_in, steps - t0 - first, store);
    yr += kRun * d_in;
  }
}

template <typename TX, int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks) selective_scan_kernel(
    const ScanArgs p) {
  using Lay = Layout<TX, L>;
  constexpr int T = Lay::kTile;
  __shared__ __align__(16) unsigned char smem[kStages * Lay::kStageBytes];
  const int tid = threadIdx.x;
  const int ch = tid / L, lane = tid % L;
  const int d0 = blockIdx.x * Lay::kChans;
  const int d = d0 + ch;
  const bool live = d < p.d_in;
  const int len = p.seqlen;
  const long long row0 = static_cast<long long>(blockIdx.y) * len;
  const int s0 = lane * kStatesPerLane;
  const long long state0 =
      (static_cast<long long>(blockIdx.y) * p.d_in + d) * p.n;

  float a2[kStatesPerLane], h[kStatesPerLane];
#pragma unroll
  for (int k = 0; k < kStatesPerLane; ++k) {
    const int i = s0 + k;
    const bool ok = live && i < p.n;
    a2[k] = ok ? p.a[static_cast<long long>(d) * p.n + i] * kLog2e : 0.f;
    h[k] = ok && p.h0 != nullptr ? p.h0[state0 + i] : 0.f;
  }
  const float dd0 = (live && lane == 0) ? p.dvec[d] : 0.f;
  // after the transpose-reduce lanes >= 4 hold copies (L >= 8)
  const bool store = live && (L < 8 || lane < 4);
  const long long d_in = p.d_in;
  float* yr = p.y + (row0 + run_step<L>(lane)) * d_in + d0 + ch;

  // the tile ring: tile k + 1 is in flight while tile k's steps run
  const int tiles = (len + T - 1) / T;
  if (tiles > 0) stage_tile<TX, L>(p, smem, row0, min(T, len), d0, tid);
  cp_async_commit();
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles)
      stage_tile<TX, L>(p, smem + ((k + 1) % kStages) * Lay::kStageBytes,
                        row0 + (k + 1) * T, min(T, len - (k + 1) * T), d0,
                        tid);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();                    // tile k is in shared memory
    scan_tile<TX, L>(smem + (k % kStages) * Lay::kStageBytes,
                     min(T, len - k * T), ch, lane, h, a2, dd0,
                     yr + static_cast<long long>(k) * T * d_in, d_in, store);
    __syncthreads();                    // its stage may be overwritten
  }

#pragma unroll
  for (int k = 0; k < kStatesPerLane; ++k) {
    const int i = s0 + k;
    if (live && i < p.n) p.h_final[state0 + i] = h[k];
  }
}

template <typename TX, int L>
cudaError_t launch(ScanArgs p, cudaStream_t stream) {
  constexpr int C = Layout<TX, L>::kChans;
  const unsigned gx = static_cast<unsigned>((p.d_in + C - 1) / C);
  const uintptr_t x = reinterpret_cast<uintptr_t>(p.x);
  const uintptr_t dt = reinterpret_cast<uintptr_t>(p.dt);
  const uintptr_t bc = reinterpret_cast<uintptr_t>(p.bm) |
                       reinterpret_cast<uintptr_t>(p.cm);
  p.vec = ((x % 16 == 0 && (p.d_in * sizeof(TX)) % 16 == 0) ? kVecX : 0) |
          ((dt % 16 == 0 && p.d_in % 4 == 0) ? kVecDt : 0) |
          ((bc % 16 == 0 && p.n % 4 == 0) ? kVecBC : 0);
  selective_scan_kernel<TX, L><<<dim3(gx, p.batch), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_lanes(const ScanArgs& p, cudaStream_t stream) {
  int n_pad = kStatesPerLane;
  while (n_pad < p.n) n_pad <<= 1;
  switch (n_pad / kStatesPerLane) {
    case 1: return launch<TX, 1>(p, stream);
    case 2: return launch<TX, 2>(p, stream);
    case 4: return launch<TX, 4>(p, stream);
    default: return launch<TX, 8>(p, stream);    // n 33-64
  }
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  dt, B, C, A, D, h0 (may be null:
// a zero start state), y and h_final are float32, every operand
// contiguous.  Returns the cudaError_t of the launch (0 = success).
extern "C" int selective_scan_launch(
    int x_dtype, const void* x, const void* dt, const void* bm,
    const void* cm, const void* a, const void* dvec, const void* h0,
    void* y, void* h_final, int batch, int seqlen, int d_in, int n,
    void* stream) {
  if ((x_dtype != 0 && x_dtype != 1) || n < 1 || n > kMaxState ||
      batch < 0 || seqlen < 0 || d_in < 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || d_in == 0) return 0;
  ScanArgs p{};
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.bm = static_cast<const float*>(bm);
  p.cm = static_cast<const float*>(cm);
  p.a = static_cast<const float*>(a);
  p.dvec = static_cast<const float*>(dvec);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<float*>(y);
  p.h_final = static_cast<float*>(h_final);
  p.batch = batch, p.seqlen = seqlen, p.d_in = d_in, p.n = n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(x_dtype == 0 ? launch_lanes<float>(p, s)
                                       : launch_lanes<__nv_bfloat16>(p, s));
}
