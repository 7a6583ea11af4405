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
// prefill-to-decode hand-off) and it adds D * x itself.  Any S and any
// d_in are taken (tail guards); x comes in fp32 or bf16 and is upcast
// right after the load; dt, B, C, A, D and h0 are fp32 (the Mamba block
// computes dt, B and C in fp32).  The
// exponential is expf (the accurate one, not __expf), so the kernel and
// its plain version agree to fp32 rounding: within 2e-5 (absolute plus
// relative, as the JAX sweep holds the TPU kernel) on the checked
// shapes.
//
// Design.  The TPU kernel carries a (block_d, n) state in VMEM across a
// sequential grid axis over sequence chunks.  Here the state lives in
// registers and a loop over time steps inside the block replaces that
// axis: nothing carries between blocks.  Each thread holds 4 of a
// channel's states, so a channel occupies n_pad / 4 neighbouring lanes
// (n_pad = n rounded up to a power of two, at least 4, at most 64) and
// its y_t is summed over those lanes with xor shuffles.  Splitting n
// across lanes is the answer to occupancy: with one thread per channel
// the served prefill (B = 2, d_in = 8192) would be 16,384 threads, about
// 4 warps per SM on 132 SMs, too few to hide the loads; with n = 16 on
// 4 lanes it is 65,536 threads in 512 blocks of 128, about 16 warps per
// SM.  A block of 128 threads serves 128 / lanes channels of one batch
// row and stages a tile of 32 time steps in shared memory: x and dt
// (coalesced along d_in), B_t and C_t (contiguous, read by every
// channel of the block; padded state columns stay zero, so padded
// states never move), then walks the tile in order.  The lane that
// owns a channel's first states stores y_t (neighbouring channels on
// neighbouring addresses).
//
// What bounds it: per (t, d, n) one exponential (SFU, 16 a clock per
// SM) and ~3 fp32 FMAs; per (t, d) x, dt and y cross device memory once.
// At the served shape (B = 2, S = 1024, d_in = 8192, n = 16, fp32 dt and
// y, bf16 x) the exponentials (268 M) bound it at ~0.07 ms, the bytes
// (~168 MB) at ~0.05 ms.  This first version does not pipeline its tile
// loads (no cp.async / TMA double buffer): a tile's loads wait for the
// previous tile's steps, and other resident blocks cover that wait.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStatesPerLane = 4;
constexpr int kTile = 32;        // time steps staged per pass
constexpr int kMaxState = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TX>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const TX* __restrict__ x,        // (B, S, d_in)
    const float* __restrict__ dt,    // (B, S, d_in)
    const float* __restrict__ bm,    // (B, S, n)
    const float* __restrict__ cm,    // (B, S, n)
    const float* __restrict__ a,     // (d_in, n)
    const float* __restrict__ dvec,  // (d_in,)
    const float* __restrict__ h0,    // (B, d_in, n) or nullptr (zeros)
    float* __restrict__ y,           // (B, S, d_in)
    float* __restrict__ h_final,     // (B, d_in, n)
    int seqlen, int d_in, int n, int lanes) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n_pad = lanes * kStatesPerLane;
  const int chans = kThreads / lanes;            // channels of this block
  float* sx = smem;                              // (kTile, chans)
  float* sdt = sx + kTile * chans;               // (kTile, chans)
  float* sb = sdt + kTile * chans;               // (kTile, n_pad)
  float* sc = sb + kTile * n_pad;                // (kTile, n_pad)

  const int tid = threadIdx.x;
  const int batch = blockIdx.y;
  const int d0 = blockIdx.x * chans;
  const int ch = tid / lanes;
  const int lane = tid % lanes;
  const int d = d0 + ch;
  const bool live = d < d_in;
  const int s0 = lane * kStatesPerLane;
  const long long state0 = (static_cast<long long>(batch) * d_in + d) * n;

  float av[kStatesPerLane], h[kStatesPerLane];
#pragma unroll
  for (int k = 0; k < kStatesPerLane; ++k) {
    const int i = s0 + k;
    const bool ok = live && i < n;
    av[k] = ok ? a[static_cast<long long>(d) * n + i] : 0.f;
    h[k] = (ok && h0 != nullptr) ? h0[state0 + i] : 0.f;
  }
  const float dd = live ? dvec[d] : 0.f;

  // sb and sc are contiguous; their padded columns (i >= n) stay zero
  for (int j = tid; j < 2 * kTile * n_pad; j += kThreads) sb[j] = 0.f;

  const long long row0 = static_cast<long long>(batch) * seqlen;
  for (int t0 = 0; t0 < seqlen; t0 += kTile) {
    const int steps = min(kTile, seqlen - t0);
    __syncthreads();               // the previous tile is consumed
    for (int j = tid; j < steps * chans; j += kThreads) {
      const int t = j / chans;
      const int dc = d0 + j % chans;
      float xv = 0.f, dv = 0.f;
      if (dc < d_in) {
        const long long off = (row0 + t0 + t) * d_in + dc;
        xv = to_float(x[off]);
        dv = dt[off];
      }
      sx[j] = xv;
      sdt[j] = dv;
    }
    const long long boff = (row0 + t0) * n;
    for (int j = tid; j < steps * n; j += kThreads) {
      const int t = j / n;
      const int i = j - t * n;
      sb[t * n_pad + i] = bm[boff + j];
      sc[t * n_pad + i] = cm[boff + j];
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float xv = sx[t * chans + ch];
      const float dv = sdt[t * chans + ch];
      const float u = dv * xv;
      const float4 b4 = *reinterpret_cast<const float4*>(sb + t * n_pad + s0);
      const float4 c4 = *reinterpret_cast<const float4*>(sc + t * n_pad + s0);
      const float bv[kStatesPerLane] = {b4.x, b4.y, b4.z, b4.w};
      const float cv[kStatesPerLane] = {c4.x, c4.y, c4.z, c4.w};
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kStatesPerLane; ++k) {
        h[k] = expf(dv * av[k]) * h[k] + u * bv[k];
        acc += h[k] * cv[k];
      }
      for (int o = lanes >> 1; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0 && live) y[(row0 + t0 + t) * d_in + d] = acc + dd * xv;
    }
  }
#pragma unroll
  for (int k = 0; k < kStatesPerLane; ++k) {
    const int i = s0 + k;
    if (live && i < n) h_final[state0 + i] = h[k];
  }
}

template <typename TX>
cudaError_t launch(const void* x, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* dvec,
                   const void* h0, void* y, void* h_final, int batch,
                   int seqlen, int d_in, int n, cudaStream_t stream) {
  int n_pad = kStatesPerLane;
  while (n_pad < n) n_pad <<= 1;
  const int lanes = n_pad / kStatesPerLane;
  const int chans = kThreads / lanes;
  const size_t smem = sizeof(float) * 2 * kTile * (chans + n_pad);
  const dim3 grid((d_in + chans - 1) / chans, batch);
  selective_scan_kernel<TX><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(dvec),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_final), seqlen, d_in, n, lanes);
  return cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16.  dt, B, C, A, D, h0 (may be
// null: a zero start state), y and h_final are float32.  Every operand
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return static_cast<int>(launch<float>(x, dt, bm, cm, a, dvec, h0, y,
                                          h_final, batch, seqlen, d_in, n,
                                          s));
  return static_cast<int>(launch<__nv_bfloat16>(x, dt, bm, cm, a, dvec, h0,
                                                y, h_final, batch, seqlen,
                                                d_in, n, s));
}
