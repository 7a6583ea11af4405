// Fused multiplexer head (paper Eq. 5-6) for Hopper (sm_90a), in two forms
// of one templated kernel.
//
// Replaces the TPU kernel src/repro/kernels/mux_score.py::mux_score (body
// _mux_kernel): optional L2-normalise of each meta-feature row, meta @ v^T,
// divide by each model's (cost-exponentiated) relative cost, row softmax.
//
// * meta form (mux_score_kernel<false>): meta (B, M) in, exactly the TPU
//   kernel's contract.  One warp a row; no block barrier.
// * head form (mux_score_kernel<true>), the probe's path: the token probe's
//   last hidden states h (B, S, d) in.  The kernel computes the mean over S,
//   the out projection (d x M), tanh, then the meta form's steps, so the
//   probe's mean, matmul, tanh and head launches (and the cost^alpha launch,
//   which the server now computes once) are one launch.
//
// What bounds it: nothing the card's rates set.  At the served head shape
// (B=1, S=64, d=128, M=32, N=2) the call reads 49,416 bytes (h 32,768, w_out
// 16,384, v 256, cost 8) and writes 8: 1.5e-5 ms at 3.35 TB/s.  One row is
// one block, so the call's time is the launch's fixed cost plus one block's
// serial chain: the pool's loads (one L2 round trip when h was just written
// by the probe's trunk), two block barriers, the projection, and warp 0's
// tail.  A few microseconds, which the probe's CUDA graph keeps from being
// multiplied by host dispatch.
//
// Design for this card (not the TPU kernel's one VMEM block):
// * one block per row; nothing crosses blocks.
// * head form, 256 threads (8 warps).  The pool: warps split S, lanes own
//   4 consecutive channels (16-byte loads when d % 4 == 0 and h is 16-byte
//   aligned, else 1 channel a lane), so each row of h is one coalesced read
//   (512 bytes at d=128, one warp) and at S=64 each thread has 8 independent
//   loads in flight: the whole 32 KB row block is one round trip.  Each
//   warp's partial sums over its rows go to shared memory once; a warp then
//   sums the 8 partials of the channels it projects (k = warp mod 8) and
//   writes the mean back in place, so pool -> projection needs only
//   __syncwarp after the one barrier.
// * the projection: lanes own outputs j (consecutive columns of w_out, so a
//   warp reads 128 contiguous bytes of a row), warps split d (16 rows each at
//   d=128).  The 8 partial sums of each j are reduced once through shared
//   memory after the second barrier.
// * the tail, in warp 0 with shuffles only: tanh and the squared norm with
//   lanes owning j; then lanes own models n, each lane's dot over M read from
//   shared memory, the max and the sum by butterfly shuffles.
// * 8 warps, not 4: ptxas gives the head form 40 registers and the meta
//   form 46, no spills (sm_90a, CUDA 12.8), far from any cap, and one
//   block a row leaves the SM otherwise idle at B=1; so the only trade is
//   two barriers' cost against loads in flight, and 8 warps halve each
//   thread's chain of pool loads and projection FMAs at the served shape.
// * shared memory: (8 d + 8 M + M + N) floats (head), (M + N) floats (meta);
//   5,256 bytes at the served shape.  The opt-in limit is set once per
//   device by mux_score_init, never at a launch, since a launch may be
//   captured in a CUDA graph.
// * deterministic: a fixed summation order everywhere, so two calls on the
//   same inputs are bitwise equal.
#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kHeadThreads = 256;
constexpr int kHeadWarps = kHeadThreads / 32;

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

// Pool rows s = warp, warp + 8, ... of one row block into part[warp][c].
template <bool kVec4>
__device__ __forceinline__ void pool_partials(const float* __restrict__ hb,
                                              float* part, int seq, int d,
                                              int lane, int warp) {
  constexpr int kPer = kVec4 ? 4 : 1;
  for (int c = lane * kPer; c < d; c += 32 * kPer) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int s = warp; s < seq; s += kHeadWarps) {
      const float* p = hb + static_cast<int64_t>(s) * d + c;
      if constexpr (kVec4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p));
        a0 += x.x;
        a1 += x.y;
        a2 += x.z;
        a3 += x.w;
      } else {
        a0 += __ldg(p);
      }
    }
    float* dst = part + warp * d + c;
    dst[0] = a0;
    if constexpr (kVec4) {
      dst[1] = a1;
      dst[2] = a2;
      dst[3] = a3;
    }
  }
}

template <bool kHead>
__global__ void __launch_bounds__(kHead ? kHeadThreads : 32)
    mux_score_kernel(const float* __restrict__ x,      // h (B,S,d) | meta (B,M)
                     const float* __restrict__ w_out,  // (d, M), head form
                     const float* __restrict__ v,      // (N, M)
                     const float* __restrict__ cost,   // (N,)
                     float* __restrict__ out,          // (B, N)
                     int seq, int d, int m_dim, int n_models, int normalize,
                     int vec4) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* part = smem;                                    // (8, d), head
  float* proj = part + (kHead ? kHeadWarps * d : 0);     // (8, M), head
  float* row = proj + (kHead ? kHeadWarps * m_dim : 0);  // (M,)
  float* logits = row + m_dim;                           // (N,)

  if constexpr (kHead) {
    const float* hb = x + static_cast<int64_t>(b) * seq * d;
    if (vec4)
      pool_partials<true>(hb, part, seq, d, lane, warp);
    else
      pool_partials<false>(hb, part, seq, d, lane, warp);
    __syncthreads();
    // the mean of channel k, for the k this warp projects, in place of
    // part[0][k] (only this lane reads or writes column k from here on)
    for (int k = warp + kHeadWarps * lane; k < d; k += kHeadWarps * 32) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kHeadWarps; ++w) total += part[w * d + k];
      part[k] = total / static_cast<float>(seq);
    }
    __syncwarp();
    for (int j = lane; j < m_dim; j += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (int k = warp; k < d; k += kHeadWarps)
        acc = fmaf(part[k], __ldg(w_out + static_cast<int64_t>(k) * m_dim + j),
                   acc);
      proj[warp * m_dim + j] = acc;
    }
    __syncthreads();
    if (warp != 0) return;
  }

  // warp 0: meta row -> (normalise) -> logits / cost -> softmax
  float sq = 0.f;
  for (int j = lane; j < m_dim; j += 32) {
    float mj;
    if constexpr (kHead) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kHeadWarps; ++w) acc += proj[w * m_dim + j];
      mj = tanhf(acc);
    } else {
      mj = __ldg(x + static_cast<int64_t>(b) * m_dim + j);
    }
    row[j] = mj;
    sq = fmaf(mj, mj, sq);
  }
  if (normalize) {
    const float norm = fmaxf(sqrtf(warp_sum(sq)), 1e-6f);
    for (int j = lane; j < m_dim; j += 32) row[j] = row[j] / norm;
  }
  __syncwarp();

  float mx = -FLT_MAX;
  for (int n = lane; n < n_models; n += 32) {
    const float* vn = v + static_cast<int64_t>(n) * m_dim;
    float dot = 0.f;
#pragma unroll 8
    for (int j = 0; j < m_dim; ++j) dot = fmaf(row[j], __ldg(vn + j), dot);
    const float lg = dot / __ldg(cost + n);
    logits[n] = lg;
    mx = fmaxf(mx, lg);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int n = lane; n < n_models; n += 32) sum += expf(logits[n] - mx);
  sum = warp_sum(sum);
  for (int n = lane; n < n_models; n += 32)
    out[static_cast<int64_t>(b) * n_models + n] = expf(logits[n] - mx) / sum;
}

size_t smem_bytes(bool head, int d, int m_dim, int n_models) {
  const size_t floats = (head ? static_cast<size_t>(kHeadWarps) * (d + m_dim)
                              : 0) + m_dim + n_models;
  return floats * sizeof(float);
}

}  // namespace

// Raise both forms' dynamic shared-memory limit to the device's opt-in
// maximum.  Called once per device before the first launch, outside any
// stream capture.  Returns the cudaError_t (0 = success).
extern "C" int mux_score_init(int device) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mux_score_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mux_score_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  const cudaError_t restore = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}

// head = 1: x is h (B, seq, d) and w_out (d, M) is read; head = 0: x is meta
// (B, M), seq, d and w_out are ignored.  All operands fp32 and contiguous,
// cost already raised to the server's exponent.  Launches on `stream` only
// (no attribute call, no allocation, no synchronisation), so it can be
// captured.  Returns the cudaError_t of the launch (0 = success).
extern "C" int mux_score_launch(int head, const void* x, const void* w_out,
                                const void* v, const void* cost, void* out,
                                int batch, int seq, int d, int m_dim,
                                int n_models, int normalize, void* stream) {
  if (batch < 1 || m_dim < 1 || n_models < 1
      || (head && (seq < 1 || d < 1 || w_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(head != 0, d, m_dim, n_models);
  const auto st = static_cast<cudaStream_t>(stream);
  if (head) {
    const int vec4 =
        d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 ? 1 : 0;
    mux_score_kernel<true><<<batch, kHeadThreads, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w_out),
        static_cast<const float*>(v), static_cast<const float*>(cost),
        static_cast<float*>(out), seq, d, m_dim, n_models, normalize, vec4);
  } else {
    mux_score_kernel<false><<<batch, 32, smem, st>>>(
        static_cast<const float*>(x), nullptr, static_cast<const float*>(v),
        static_cast<const float*>(cost), static_cast<float*>(out), 1, 0,
        m_dim, n_models, normalize, 0);
  }
  return static_cast<int>(cudaGetLastError());
}
