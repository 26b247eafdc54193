// Hypercube propagation kernels K1 and K2 for Hopper (sm_90a).
//
// One hypercube propagation out = scale * (M x) + shift runs as two kernels
// over features carried in the rg layout x[r, g, f] (node r*G + g), with the
// weight banks in the r-major layout w[r, g, c]:
//
//   K1 (A pattern)  z[g, c, f]   = sum_r w1[r, g, c] * x[r, g, f]
//                   z is written in gc order [G, A, F]; the caller views the
//                   same memory as rg [A, G, F] with no copy.
//   K2 (A^T pattern, diagonal, affine epilogue)
//                   out[r, g, f] = scale * (z[r, g, f] + d[r, g] * x[r, g, f]
//                                  + sum_c w2[r, g, c] * x_gc[g, c, f]) + shift
//                   x_gc is the memory of x indexed as [G, A, F].
//
// Replaces the Pallas kernels of protgram_directgcn_tpu/ops/pallas_hyper.py:
// K1 is the first pallas_call of apply_hyper_pallas (_k1_body_rs), K2 the
// second (_k2_body).  The backward pass runs the same pair with the banks
// swapped.
//
// Bound on this card: bytes.  Each g key does 2*A*A*F operations on
// (2*A*F + A*A) carry and bank elements, about A = 21 operations per element
// (5 per byte in f32, 10 in bf16), below the ~20 f32 operations per byte of
// device memory the H100's CUDA cores sustain (67 TFLOP/s over 3.35 TB/s).
// Design: one block per (key g, feature tile); each thread
// owns one feature column and keeps the A carry values of that column in
// registers, the block stages the [A, A] bank slab of its key in shared
// memory (read as a broadcast), and every global read and write is a
// contiguous row of F features across the threads (coalesced).  f32
// accumulation; stores in the carry dtype.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes.  Each
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxAlphabet = 32;  // register budget per thread: one carry column

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage the bank slab w[:, g, :] ([A, A] at row stride G*A) as f32.
template <typename T>
__device__ __forceinline__ void load_slab(const T* __restrict__ w, float* w_s, int a, int g,
                                          int64_t gdim) {
  for (int i = threadIdx.x; i < a * a; i += blockDim.x) {
    const int r = i / a;
    const int c = i - r * a;
    w_s[i] = to_f32(w[((int64_t)r * gdim + g) * a + c]);
  }
}

template <typename T>
__global__ void k1_kernel(const T* __restrict__ w1, const T* __restrict__ x, T* __restrict__ z,
                          int a, int gdim, int fdim) {
  __shared__ float w_s[kMaxAlphabet * kMaxAlphabet];
  const int g = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  load_slab(w1, w_s, a, g, gdim);
  __syncthreads();
  if (f >= fdim) return;

  float xr[kMaxAlphabet];
#pragma unroll
  for (int r = 0; r < kMaxAlphabet; ++r) {
    xr[r] = r < a ? to_f32(x[((int64_t)r * gdim + g) * fdim + f]) : 0.0f;
  }
  T* zg = z + (int64_t)g * a * fdim + f;
  for (int c = 0; c < a; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxAlphabet; ++r) {
      if (r < a) acc = fmaf(w_s[r * a + c], xr[r], acc);
    }
    zg[(int64_t)c * fdim] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void k2_kernel(const float* __restrict__ d, const T* __restrict__ w2,
                          const T* __restrict__ z, const T* __restrict__ x, T* __restrict__ out,
                          int a, int gdim, int fdim, float scale, float shift) {
  __shared__ float w_s[kMaxAlphabet * kMaxAlphabet];
  const int g = blockIdx.x;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  load_slab(w2, w_s, a, g, gdim);
  __syncthreads();
  if (f >= fdim) return;

  // x_gc[g, c, f]: the A rows of key g are contiguous in node order g*A + c.
  float xg[kMaxAlphabet];
  const T* xgc = x + (int64_t)g * a * fdim + f;
#pragma unroll
  for (int c = 0; c < kMaxAlphabet; ++c) {
    xg[c] = c < a ? to_f32(xgc[(int64_t)c * fdim]) : 0.0f;
  }
  for (int r = 0; r < a; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < kMaxAlphabet; ++c) {
      if (c < a) acc = fmaf(w_s[r * a + c], xg[c], acc);
    }
    const int64_t node = (int64_t)r * gdim + g;
    const int64_t idx = node * fdim + f;
    const float v = to_f32(z[idx]) + d[node] * to_f32(x[idx]) + acc;
    out[idx] = from_f32<T>(scale * v + shift);
  }
}

// Threads per block: one per feature column, up to 128, in whole warps.
inline dim3 block_for(int fdim) {
  int t = ((fdim + 31) / 32) * 32;
  return dim3(t < 128 ? t : 128);
}

inline dim3 grid_for(int gdim, int fdim, dim3 block) {
  return dim3(gdim, (fdim + block.x - 1) / block.x);
}

template <typename T>
int launch_k1(const void* w1, const void* x, void* z, int a, int gdim, int fdim, void* stream) {
  if (a < 1 || a > kMaxAlphabet || gdim < 1 || fdim < 1) return (int)cudaErrorInvalidValue;
  const dim3 block = block_for(fdim);
  k1_kernel<T><<<grid_for(gdim, fdim, block), block, 0, (cudaStream_t)stream>>>(
      (const T*)w1, (const T*)x, (T*)z, a, gdim, fdim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k2(const void* d, const void* w2, const void* z, const void* x, void* out, int a,
              int gdim, int fdim, float scale, float shift, void* stream) {
  if (a < 1 || a > kMaxAlphabet || gdim < 1 || fdim < 1) return (int)cudaErrorInvalidValue;
  const dim3 block = block_for(fdim);
  k2_kernel<T><<<grid_for(gdim, fdim, block), block, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const T*)w2, (const T*)z, (const T*)x, (T*)out, a, gdim, fdim, scale,
      shift);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hyper_max_alphabet() { return kMaxAlphabet; }

int hyper_k1_f32(const void* w1, const void* x, void* z, int a, int g, int f, void* stream) {
  return launch_k1<float>(w1, x, z, a, g, f, stream);
}

int hyper_k1_bf16(const void* w1, const void* x, void* z, int a, int g, int f, void* stream) {
  return launch_k1<__nv_bfloat16>(w1, x, z, a, g, f, stream);
}

int hyper_k2_f32(const void* d, const void* w2, const void* z, const void* x, void* out, int a,
                 int g, int f, float scale, float shift, void* stream) {
  return launch_k2<float>(d, w2, z, x, out, a, g, f, scale, shift, stream);
}

int hyper_k2_bf16(const void* d, const void* w2, const void* z, const void* x, void* out, int a,
                  int g, int f, float scale, float shift, void* stream) {
  return launch_k2<__nv_bfloat16>(d, w2, z, x, out, a, g, f, scale, shift, stream);
}

}  // extern "C"
