// ELL SpMM kernels for Hopper (sm_90a).
//
//   out[i, f] = sum_k w[i, k] * x[idx[i, k], f]      i < N_out, k < K, f < F
//
// idx int32 [N_out, K], w f32 [N_out, K], x f32 [N_in, F], out f32 [N_out, F],
// all row-major and contiguous.  The sum runs over the K slots in slot order
// with f32 accumulation (one fmaf per slot).  Padding slots (w == 0,
// idx == 0) are computed like any other and add 0 * x[0].  Any K, N_out,
// N_in and F are taken; N_out == 0 or F == 0 launches nothing.
//
// Replaces the two Pallas kernels of protgram_directgcn_tpu/ops/pallas_spmm.py:
//   ell_resident_f32  <- _ell_pallas_raw (_ell_kernel), the x-resident regime
//                        (N_in * 128 * 4 bytes <= 8 MiB, N_in <= 16,384);
//   ell_hbm_f32       <- _ell_hbm_raw (_ell_hbm_kernel), the regime where x
//                        stays in device memory and rows are gathered by DMA.
// The backward pass of each runs the same entry point on the transpose
// orientation (idx_t, w_t).  On Hopper the counterpart of "x resident in
// VMEM" is L2 residency: a source table of N_in <= 16,384 rows at F = 256 in
// f32 is at most 16 MB, inside the 50 MB L2, so its rows are read from device
// memory about once whatever the gather order.  A larger table streams from
// device memory.  Both regimes share one kernel body; each keeps its own
// entry point, wrapper, launch count and timing.  The gather is a plain
// load, not a cp.async ring in shared memory.
//
// Bound on this card: bytes.  The least traffic is N_out*K*8 (idx, w)
// + N_in*F*4 (x, each row once) + N_out*F*4 (out) bytes at 3.35 TB/s, for
// 2*N_out*K*F operations at 67 TFLOP/s (f32, no tensor cores): at most
// 2*K*F / (8*K + 4*F) < 0.5 operations per byte, far below the ~20 the card
// sustains.  Design, for that bound:
//   - each thread owns 4 consecutive features of one output row (a float4
//     load and store when F % 4 == 0 and the pointers are 16-byte aligned,
//     else 1 feature), and the threads of a row read its gathered source row
//     as one contiguous, coalesced run (up to 64 threads x 16 bytes);
//   - a block takes 256 / threads-per-row output rows, and a second grid
//     dimension tiles F wider than 64 vectors; the block stages its rows'
//     idx/w in shared memory, 16 slots at a time, with coalesced loads, so
//     every (row, slot) pair is read from device memory once per feature tile;
//   - the slot loop is unrolled by 4 and the four gathers are issued before
//     the four fmaf's, so four independent loads are in flight per thread
//     (a loop of one load and one dependent fma would wait a full memory
//     latency per slot);
//   - out is written once, with no atomics: every output element belongs to
//     exactly one thread.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes.  Each
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;      // slots of idx/w staged in shared memory per pass
constexpr int kMaxRowThreads = 64;  // threads per output row (x VEC features each)

__device__ __forceinline__ void fma_into(float& acc, float w, float v) { acc = fmaf(w, v, acc); }
__device__ __forceinline__ void fma_into(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// V = float4 (4 features a thread) or float (1).  nvec = F / features-per-V.
// Thread t of the block serves output row blockIdx.x * rows + (t >> row_log2)
// and feature vector blockIdx.y * (1 << row_log2) + (t & ((1 << row_log2) - 1)).
template <typename V>
__global__ void __launch_bounds__(kThreads)
    ell_kernel(const int* __restrict__ idx, const float* __restrict__ w,
               const V* __restrict__ x, V* __restrict__ out, int n_out, int k, int nvec,
               int row_log2) {
  __shared__ int s_idx[kThreads * kChunk];
  __shared__ float s_w[kThreads * kChunk];
  const int row_threads = 1 << row_log2;
  const int rows = kThreads >> row_log2;
  const int local_row = threadIdx.x >> row_log2;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int64_t row = row0 + local_row;
  const int v = blockIdx.y * row_threads + (threadIdx.x & (row_threads - 1));
  const bool live = row < n_out && v < nvec;

  V acc = zero<V>();
  for (int k0 = 0; k0 < k; k0 += kChunk) {
    const int kc = min(kChunk, k - k0);
    __syncthreads();  // the previous chunk's slots have been read
    for (int t = threadIdx.x; t < rows * kChunk; t += kThreads) {
      const int r = t / kChunk;
      const int j = t - r * kChunk;
      const int64_t gr = row0 + r;
      int iv = 0;
      float wv = 0.0f;
      if (gr < n_out && j < kc) {
        iv = idx[gr * k + k0 + j];
        wv = w[gr * k + k0 + j];
      }
      s_idx[t] = iv;
      s_w[t] = wv;
    }
    __syncthreads();
    if (live) {
      const int* ri = s_idx + local_row * kChunk;
      const float* rw = s_w + local_row * kChunk;
      int j = 0;
      for (; j + 4 <= kc; j += 4) {
        const V a0 = x[(int64_t)ri[j] * nvec + v];
        const V a1 = x[(int64_t)ri[j + 1] * nvec + v];
        const V a2 = x[(int64_t)ri[j + 2] * nvec + v];
        const V a3 = x[(int64_t)ri[j + 3] * nvec + v];
        fma_into(acc, rw[j], a0);
        fma_into(acc, rw[j + 1], a1);
        fma_into(acc, rw[j + 2], a2);
        fma_into(acc, rw[j + 3], a3);
      }
      for (; j < kc; ++j) fma_into(acc, rw[j], x[(int64_t)ri[j] * nvec + v]);
    }
  }
  if (live) out[row * nvec + v] = acc;
}

template <typename V>
int launch_typed(const int* idx, const float* w, const void* x, void* out, int n_out, int k,
                 int nvec, cudaStream_t stream) {
  int row_log2 = 0;
  while ((1 << row_log2) < nvec && (1 << row_log2) < kMaxRowThreads) ++row_log2;
  const int rows = kThreads >> row_log2;
  const dim3 grid((unsigned)((n_out + rows - 1) / rows),
                  (unsigned)((nvec + (1 << row_log2) - 1) >> row_log2));
  ell_kernel<V><<<grid, kThreads, 0, stream>>>(idx, w, (const V*)x, (V*)out, n_out, k, nvec,
                                               row_log2);
  return (int)cudaGetLastError();
}

int launch(const void* idx, const void* w, const void* x, void* out, int n_out, int k, int f,
           void* stream) {
  if (n_out < 0 || k < 0 || f < 0) return (int)cudaErrorInvalidValue;
  if (n_out == 0 || f == 0) return (int)cudaSuccess;
  const bool vec4 = f % 4 == 0 && ((uintptr_t)x % 16) == 0 && ((uintptr_t)out % 16) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* i = (const int*)idx;
  const float* wf = (const float*)w;
  if (vec4) return launch_typed<float4>(i, wf, x, out, n_out, k, f / 4, s);
  return launch_typed<float>(i, wf, x, out, n_out, k, f, s);
}

}  // namespace

extern "C" {

int ell_resident_f32(const void* idx, const void* w, const void* x, void* out, int n_out, int k,
                     int f, void* stream) {
  return launch(idx, w, x, out, n_out, k, f, stream);
}

int ell_hbm_f32(const void* idx, const void* w, const void* x, void* out, int n_out, int k,
                int f, void* stream) {
  return launch(idx, w, x, out, n_out, k, f, stream);
}

}  // extern "C"
