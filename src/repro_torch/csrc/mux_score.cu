// Fused multiplexer head (paper Eq. 5-6) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mux_score.py::mux_score
// (body _mux_kernel): optional L2-normalise of each meta-feature row,
// meta @ v^T, divide by each model's relative cost, row softmax — one
// pass with the row and its logits kept in shared memory, so none of the
// four steps round-trips through device memory.
//
// What bounds it: at the served shapes (a few rows, N = zoo size, M a
// few dozen features) the work is a few hundred bytes and FLOPs; the
// bytes bound (meta + v + cost read once, weights written once, over
// ~3.35 TB/s) is nanoseconds, so the call is launch-latency bound.  One
// block per row; warps split the N dot products, lanes split M.
#include <cfloat>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

__global__ void __launch_bounds__(kThreads) mux_score_kernel(
    const float* __restrict__ meta,  // (B, M)
    const float* __restrict__ v,     // (N, M)
    const float* __restrict__ cost,  // (N,)
    float* __restrict__ out,         // (B, N)
    int m_dim, int n_models, int normalize) {
  extern __shared__ float smem[];
  float* row = smem;                // (M,)
  float* logits = row + m_dim;      // (N,)
  float* red = logits + n_models;   // (kWarps,)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float sq = 0.f;
  for (int i = tid; i < m_dim; i += kThreads) {
    const float x = meta[static_cast<long long>(b) * m_dim + i];
    row[i] = x;
    sq += x * x;
  }
  if (normalize) {
    sq = warp_sum(sq);
    if (lane == 0) red[warp] = sq;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w];
    const float norm = fmaxf(sqrtf(total), 1e-6f);
    for (int i = tid; i < m_dim; i += kThreads) row[i] = row[i] / norm;
  }
  __syncthreads();

  for (int n = warp; n < n_models; n += kWarps) {
    float dot = 0.f;
    for (int i = lane; i < m_dim; i += 32)
      dot += row[i] * v[static_cast<long long>(n) * m_dim + i];
    dot = warp_sum(dot);
    if (lane == 0) logits[n] = dot / cost[n];
  }
  __syncthreads();

  if (warp == 0) {
    float mx = -FLT_MAX;
    for (int n = lane; n < n_models; n += 32) mx = fmaxf(mx, logits[n]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int n = lane; n < n_models; n += 32) sum += expf(logits[n] - mx);
    sum = warp_sum(sum);
    for (int n = lane; n < n_models; n += 32)
      out[static_cast<long long>(b) * n_models + n] =
          expf(logits[n] - mx) / sum;
  }
}

}  // namespace

// All operands fp32 and contiguous.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int mux_score_launch(const void* meta, const void* v,
                                const void* cost, void* out, int batch,
                                int m_dim, int n_models, int normalize,
                                void* stream) {
  const size_t smem = sizeof(float) * (m_dim + n_models + kWarps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mux_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mux_score_kernel<<<batch, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meta), static_cast<const float*>(v),
      static_cast<const float*>(cost), static_cast<float*>(out), m_dim,
      n_models, normalize);
  return static_cast<int>(cudaGetLastError());
}
