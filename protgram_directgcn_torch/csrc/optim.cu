// The optimizer's pass over the parameters for Hopper (sm_90a): Adam over
// many leaves in one launch, and the sum of squares of many leaves (the
// loss's L2 term) in one launch.
//
//   adam:  for each leaf of the table and each element, with p and g in the
//          leaf's type (f32 or bf16) and mu, nu f32:
//            g' = c ? round_to(type, g + c * p) : g      (weight decay or 2 * L2)
//            mu = b1 * mu + (1 - b1) * g'
//            nu = b2 * nu + (1 - b2) * g' * g'
//            p  = round_to(type, p - lr * (mu / bc1) / (sqrt(nu / bc2) + eps))
//          bc1, bc2: optax's float32 bias corrections at the leaves' step
//          count (every leaf of a launch shares it).  The order of the
//          plain version (ops/optim_kernels.py adam_plain); IEEE division
//          and square root (no fast math).
//   sum of squares:  out = sum over the leaves' elements of (f32 of x)^2,
//          each square rounded in f32, summed in f64, stored as f32.
//
// Replaces no TPU kernel: optax's Adam and the L2 term ran under XLA, which
// fuses an elementwise update into one pass.  The port ran them as ATen
// ops: about ten torch._foreach_* passes (thirteen ops a slice on the
// largest leaf) and, for the L2 term, about seven kernels a leaf inside
// autograd, some 450 launches a step and 150 bytes an element.
//
// Bound on this card: bytes.  Adam reads p, g, mu and nu once and writes p,
// mu and nu once: 28 bytes an f32 element (20 for bf16 p and g), for about
// 12 operations; the sum reads p once, 4 bytes an element.  Design, for
// that:
//   - one launch covers up to kTableLeaves leaves: a table of their
//     pointers and sizes travels in the kernel's parameters (under 4 KB),
//     so a step hands it over with no copy and no host sync;
//   - the leaves are cut into tiles of kTileElems elements; a block takes a
//     tile (Adam: one block a tile; the sum: a fixed grid walking the
//     tiles), finds its leaf by a binary search over the tiles' prefix sums
//     in the table, and its threads move 16 bytes of each f32 array a load
//     (4 elements; 8 bytes of a bf16 one) where the leaf's pointers are
//     aligned for it, one element at a time otherwise and at the ragged end;
//   - nothing is staged in shared memory: each byte is used once, and the
//     many blocks in flight keep enough loads outstanding to fill the bus;
//   - the sum is deterministic: each block writes its f64 partial, and the
//     last block to finish (a counter that it resets) adds the partials in
//     a fixed order.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes.  Each
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// a table it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTableLeaves = 64;  // leaves one launch's table holds
constexpr int kThreads = 256;
constexpr int kVec = 4;  // elements a thread moves a load on the vector path
constexpr int kTileElems = kThreads * kVec * 8;  // 8,192: 8 vector loads a thread
constexpr int kSumBlocks = 1024;  // the sum's grid (and its partials) at most

// flags of a leaf
constexpr unsigned char kBf16 = 1;     // p and g are bf16 (else f32)
constexpr unsigned char kAligned = 2;  // every pointer aligned for the vector path

struct LeafTable {
  void* p[kTableLeaves];
  const void* g[kTableLeaves];
  float* mu[kTableLeaves];
  float* nu[kTableLeaves];
  long long numel[kTableLeaves];
  int tile_start[kTableLeaves + 1];  // tile_start[n]: the table's tiles
  unsigned char flags[kTableLeaves];
  int n;
};

struct AdamScalars {
  float lr, b1, b2, one_minus_b1, one_minus_b2, bc1, bc2, eps, c;
};

// The leaf whose tiles hold `tile`: the last leaf that starts at or before
// it (an empty leaf starts where the next one does, so it is never chosen).
__device__ __forceinline__ int leaf_of(const LeafTable& t, int tile) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One element of Adam; p and g as f32 (widened from bf16), p returned as
// f32 before its rounding to the leaf's type.
template <bool kIsBf16>
__device__ __forceinline__ float adam_elem(float p, float g, float& mu, float& nu,
                                           const AdamScalars& s) {
  if (s.c != 0.0f) {
    g = g + s.c * p;
    if (kIsBf16) g = round_bf16(g);
  }
  mu = mu * s.b1 + s.one_minus_b1 * g;
  nu = nu * s.b2 + s.one_minus_b2 * g * g;
  return p - s.lr * ((mu / s.bc1) / (sqrtf(nu / s.bc2) + s.eps));
}

__device__ __forceinline__ float load_elem(const void* base, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

template <bool kIsBf16>
__device__ __forceinline__ void adam_scalar(void* p, const void* g, float* mu, float* nu,
                                            long long i, const AdamScalars& s) {
  float m = mu[i], v = nu[i];
  const float out = adam_elem<kIsBf16>(load_elem(p, i, kIsBf16), load_elem(g, i, kIsBf16),
                                       m, v, s);
  mu[i] = m;
  nu[i] = v;
  if (kIsBf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(out);
  } else {
    static_cast<float*>(p)[i] = out;
  }
}

// Four elements from i (a multiple of 4; the pointers aligned for it).
template <bool kIsBf16>
__device__ __forceinline__ void adam_vec(void* p, const void* g, float* mu, float* nu,
                                         long long i, const AdamScalars& s) {
  float pv[kVec], gv[kVec];
  if (kIsBf16) {
    const uint2 pw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
    const uint2 gw = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(g) + i);
    const __nv_bfloat162* ph = reinterpret_cast<const __nv_bfloat162*>(&pw);
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gw);
    for (int k = 0; k < 2; ++k) {
      const float2 pf = __bfloat1622float2(ph[k]);
      const float2 gf = __bfloat1622float2(gh[k]);
      pv[2 * k] = pf.x; pv[2 * k + 1] = pf.y;
      gv[2 * k] = gf.x; gv[2 * k + 1] = gf.y;
    }
  } else {
    const float4 pf = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    const float4 gf = *reinterpret_cast<const float4*>(static_cast<const float*>(g) + i);
    pv[0] = pf.x; pv[1] = pf.y; pv[2] = pf.z; pv[3] = pf.w;
    gv[0] = gf.x; gv[1] = gf.y; gv[2] = gf.z; gv[3] = gf.w;
  }
  float4 m = *reinterpret_cast<const float4*>(mu + i);
  float4 v = *reinterpret_cast<const float4*>(nu + i);
  float mv[kVec] = {m.x, m.y, m.z, m.w}, vv[kVec] = {v.x, v.y, v.z, v.w}, out[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) out[k] = adam_elem<kIsBf16>(pv[k], gv[k], mv[k], vv[k], s);
  *reinterpret_cast<float4*>(mu + i) = make_float4(mv[0], mv[1], mv[2], mv[3]);
  *reinterpret_cast<float4*>(nu + i) = make_float4(vv[0], vv[1], vv[2], vv[3]);
  if (kIsBf16) {
    uint2 w;
    *reinterpret_cast<__nv_bfloat162*>(&w.x) = __floats2bfloat162_rn(out[0], out[1]);
    *reinterpret_cast<__nv_bfloat162*>(&w.y) = __floats2bfloat162_rn(out[2], out[3]);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p) + i) = w;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + i) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

template <bool kIsBf16>
__device__ __forceinline__ void adam_tile(const LeafTable& t, int leaf, long long begin,
                                          long long end, const AdamScalars& s) {
  void* p = t.p[leaf];
  const void* g = t.g[leaf];
  float* mu = t.mu[leaf];
  float* nu = t.nu[leaf];
  long long tail = begin;
  if (t.flags[leaf] & kAligned) {
    tail = begin + (end - begin) / kVec * kVec;
    for (long long i = begin + (long long)threadIdx.x * kVec; i < tail;
         i += (long long)kThreads * kVec) {
      adam_vec<kIsBf16>(p, g, mu, nu, i, s);
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    adam_scalar<kIsBf16>(p, g, mu, nu, i, s);
  }
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const LeafTable t, const AdamScalars s) {
  const int tile = blockIdx.x;
  const int leaf = leaf_of(t, tile);
  const long long begin = (long long)(tile - t.tile_start[leaf]) * kTileElems;
  const long long end = min(begin + kTileElems, t.numel[leaf]);
  if (t.flags[leaf] & kBf16) {
    adam_tile<true>(t, leaf, begin, end, s);
  } else {
    adam_tile<false>(t, leaf, begin, end, s);
  }
}

__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    if (lane < kThreads / 32) v = warp_sums[lane];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;  // whole in thread 0
}

__device__ __forceinline__ double square_f64(float x) {
  return (double)(x * x);
}

__global__ void __launch_bounds__(kThreads) sum_squares_kernel(
    const LeafTable t, double* __restrict__ partials, unsigned int* __restrict__ counter,
    float* __restrict__ out) {
  __shared__ double warp_sums[kThreads / 32];
  __shared__ bool last;
  double acc = 0.0;
  for (int tile = blockIdx.x; tile < t.tile_start[t.n]; tile += gridDim.x) {
    const int leaf = leaf_of(t, tile);
    const long long begin = (long long)(tile - t.tile_start[leaf]) * kTileElems;
    const long long end = min(begin + kTileElems, t.numel[leaf]);
    const void* p = t.p[leaf];
    const bool bf16 = t.flags[leaf] & kBf16;
    long long tail = begin;
    if ((t.flags[leaf] & kAligned) && !bf16) {
      tail = begin + (end - begin) / kVec * kVec;
      for (long long i = begin + (long long)threadIdx.x * kVec; i < tail;
           i += (long long)kThreads * kVec) {
        const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
        acc += square_f64(v.x) + square_f64(v.y) + square_f64(v.z) + square_f64(v.w);
      }
    }
    for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
      acc += square_f64(load_elem(p, i, bf16));
    }
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = acc;
    __threadfence();
    last = atomicInc(counter, gridDim.x) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: the partials in a fixed order, whichever block was last.
  __threadfence();
  double total = 0.0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) total += __ldcg(partials + b);
  __syncthreads();  // warp_sums is reused
  total = block_sum(total, warp_sums);
  if (threadIdx.x == 0) {
    out[0] = (float)total;
    *counter = 0u;
  }
}

// Fill the table from the caller's arrays: ptrs holds n pointers each of
// p, g, mu and nu (in that order; g, mu and nu may be absent for the sum).
// Returns the table's tiles, or -1 for a table it does not take.
long long fill_table(LeafTable& t, int n, const long long* ptrs, bool adam,
                     const long long* numel, const unsigned char* flags) {
  if (n < 1 || n > kTableLeaves) return -1;
  t.n = n;
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0) return -1;
    t.p[i] = (void*)ptrs[i];
    t.g[i] = adam ? (const void*)ptrs[n + i] : nullptr;
    t.mu[i] = adam ? (float*)ptrs[2 * n + i] : nullptr;
    t.nu[i] = adam ? (float*)ptrs[3 * n + i] : nullptr;
    t.numel[i] = numel[i];
    t.flags[i] = flags[i];
    t.tile_start[i] = (int)tiles;
    tiles += (numel[i] + kTileElems - 1) / kTileElems;
    if (tiles > 0x7fffffffLL) return -1;
  }
  t.tile_start[n] = (int)tiles;
  return tiles;
}

}  // namespace

extern "C" {

// One Adam step over n leaves (n <= kTableLeaves) at one step count.
int optim_adam(int n, const long long* ptrs, const long long* numel, const unsigned char* flags,
               float lr, float b1, float b2, float one_minus_b1, float one_minus_b2, float bc1,
               float bc2, float eps, float c, void* stream) {
  LeafTable t;
  const long long tiles = fill_table(t, n, ptrs, true, numel, flags);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;
  const AdamScalars s{lr, b1, b2, one_minus_b1, one_minus_b2, bc1, bc2, eps, c};
  adam_kernel<<<(unsigned int)tiles, kThreads, 0, (cudaStream_t)stream>>>(t, s);
  return (int)cudaGetLastError();
}

// out[0] = the sum of squares of n leaves (n <= kTableLeaves).  partials:
// kSumBlocks doubles of scratch; counter: one unsigned int that is 0 before
// the launch and is left 0 after it.
int optim_sum_squares(int n, const long long* ptrs, const long long* numel,
                      const unsigned char* flags, double* partials, unsigned int* counter,
                      float* out, void* stream) {
  LeafTable t;
  const long long tiles = fill_table(t, n, ptrs, false, numel, flags);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)(tiles < kSumBlocks ? (tiles > 0 ? tiles : 1)
                                                              : kSumBlocks);
  sum_squares_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(t, partials, counter, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
