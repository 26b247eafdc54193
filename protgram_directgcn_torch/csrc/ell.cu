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
// VMEM" is L2 residency: a table of N_in <= 16,384 rows at F = 256 in f32
// is at most 16 MB, inside the 50 MB L2.  Both regimes share one kernel
// body; each keeps its own entry point, wrapper, launch count and timing.
//
// Bound on this card: bytes.  The least traffic is N_out*K*8 (idx, w)
// + N_in*F*4 (x, each row once) + N_out*F*4 (out) bytes at 3.35 TB/s, for
// 2*N_out*K*F operations at 67 TFLOP/s (f32, no tensor cores): at most
// 2*K*F / (8*K + 4*F) < 0.5 operations per byte.  What the kernel really
// moves is the gathered rows, N_out*K*F*4 bytes (7.5 GB at the n = 4 level,
// F = 256), from L2 or L1, so its rate is what L2 and L1 deliver to the SMs
// (about 12.5 TB/s of gathered rows on an NVIDIA H100 80GB HBM3 at
// 700.00 W, L1 serving the rows that a block's rows share).
// Design, for that:
//   - a thread owns V features of one output row (V = 4, one 16-byte load
//     and store, when F % 4 == 0 and x and out are 16-byte aligned; else
//     V = 1, the same body), and the ct threads of a row read a gathered
//     source row's feature tile (ct * V features) as one contiguous run;
//   - a block takes `rows` consecutive output rows over one feature tile,
//     and the grid's x runs over row blocks, its y over feature tiles, so
//     the blocks of one tile run together.  The plan (ops/ell_kernels.py
//     `launch_plan`) sizes both to the table: where x is larger than 16 MB
//     a tile is one 128-byte line (32 features, 8 threads) and a block 16
//     rows (128 threads), so a tile's slice of x (N_in lines, 21 MB at the
//     n = 4 level) stays in L2 while its blocks run; a smaller x stays in
//     L2 whole, and takes 256-byte tiles and 256 threads a block;
//   - idx/w and out, read or written once, carry the streaming hint
//     (evict first) where x is the large table, so they do not push x out
//     of L2 and L1;
//   - the block stages its rows' idx/w in dynamic shared memory sized to
//     what it serves (rows * kc * 8 bytes, kc = min(K, 16 KB / (rows * 8));
//     5.5 KB at 16 rows and K = 44), one coalesced copy of a contiguous run
//     when kc == K (kept for what it saves: see the kernel), and reads each
//     slot as one 8-byte broadcast; the rest of the SM's 256 KB is L1;
//   - each thread issues 8 gathers, then their 8 fmaf's (then 4, then 1 at
//     the end of a row), so 8 independent loads are in flight per thread;
//   - out is written once, with no atomics: every output element belongs to
//     exactly one thread.
// A design that copied each block's distinct source rows into shared memory
// first (cp.async) and summed from there halved the rows read from L2 but
// ran 2x slower: a block's copies and sums do not overlap (PERF.md).
//
// Plain C entry points (no PyTorch headers), loaded with ctypes.  Each
// launch entry point checks the plan it is given, returns
// cudaErrorInvalidValue on one it cannot run, and else cudaGetLastError()
// after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;      // threads a block
constexpr int kMaxSmemBytes = 49152;  // dynamic shared memory without the opt-in
constexpr int kUnroll = 8;            // gathers in flight per thread

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

// idx/w loads and out stores, with the streaming hint (evict first from L1
// and L2: read or written once, they leave the caches to x) where `cs`.
template <typename T>
__device__ __forceinline__ T load_once(const T* p, bool cs) { return cs ? __ldcs(p) : __ldg(p); }
template <typename V>
__device__ __forceinline__ void store_once(V* p, const V& v, bool cs) {
  if (cs)
    __stcs(p, v);
  else
    *p = v;
}

// acc += w * x[index * nvec + v] over slots j.. of s ({index, bits of w}) in
// slot order, U loads issued before their U fmaf's; returns the first slot
// left.
template <int U, typename V>
__device__ __forceinline__ int accumulate(const int2* s, int j, int n, const V* x, int nvec,
                                          int v, V& acc) {
  for (; j + U <= n; j += U) {
    V a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = x[(int64_t)s[j + u].x * nvec + v];
#pragma unroll
    for (int u = 0; u < U; ++u) fma_into(acc, __int_as_float(s[j + u].y), a[u]);
  }
  return j;
}

// V = float4 (4 features a thread) or float (1).  nvec = F / features-per-V.
// Thread t of block (bx, by) serves output row bx * rows + (t >> ct_log2)
// and feature vector by * ct + (t & (ct - 1)), ct = 1 << ct_log2.
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
    ell_kernel(const int* __restrict__ idx, const float* __restrict__ w,
               const V* __restrict__ x, V* __restrict__ out, int n_out, int k, int nvec,
               int ct_log2, int rows, int kc, bool cs) {
  extern __shared__ int2 s_slot[];  // [rows][kc]: {idx, bits of w}
  const int local_row = threadIdx.x >> ct_log2;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int64_t row = row0 + local_row;
  const int v = (blockIdx.y << ct_log2) + (threadIdx.x & ((1 << ct_log2) - 1));
  const bool live = row < n_out && v < nvec;
  const int live_rows = n_out - row0 < rows ? (int)(n_out - row0) : rows;

  V acc = zero<V>();
  for (int k0 = 0; k0 < k; k0 += kc) {
    const int n = min(kc, k - k0);
    if (k0 > 0) __syncthreads();  // the previous chunk's slots have been read
    // When the block's slots are one contiguous run (n == k), the copy below
    // and the general loop after it stage the same slots; with both, the
    // float4 body takes 40 registers (12 blocks of 128 threads an SM), and
    // without the first, 44 (10 blocks), a 4-byte spill in the float body,
    // 10% more time over the 4-gram table and up to 7% over the 3-gram one
    // (PERF.md).
    if (n == k) {
      const int64_t base = row0 * k;
      for (int t = threadIdx.x; t < live_rows * k; t += blockDim.x)
        s_slot[(t / k) * kc + t % k] =
            make_int2(load_once(idx + base + t, cs), __float_as_int(load_once(w + base + t, cs)));
    } else {
      for (int t = threadIdx.x; t < live_rows * n; t += blockDim.x) {
        const int r = t / n;
        const int j = t - r * n;
        const int64_t g = (row0 + r) * k + k0 + j;
        s_slot[r * kc + j] =
            make_int2(load_once(idx + g, cs), __float_as_int(load_once(w + g, cs)));
      }
    }
    __syncthreads();
    if (live) {
      const int2* s = s_slot + local_row * kc;
      int j = accumulate<kUnroll>(s, 0, n, x, nvec, v, acc);
      j = accumulate<4>(s, j, n, x, nvec, v, acc);
      accumulate<1>(s, j, n, x, nvec, v, acc);
    }
  }
  if (live) store_once(out + row * nvec + v, acc, cs);
}

int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

// The plan (ops/ell_kernels.py `launch_plan`): v features a thread, ct
// threads a row (a power of two), `rows` rows a block, kc slots staged a
// pass, grid (row blocks, feature tiles), cs the streaming hints.  Refused
// unless it covers every output element once and fits a block.
int launch(const void* idx, const void* w, const void* x, void* out, int n_out, int k, int f,
           int v, int ct, int rows, int kc, int grid_x, int grid_y, int cs, void* stream) {
  if (n_out < 0 || k < 0 || f < 0) return (int)cudaErrorInvalidValue;
  if (n_out == 0 || f == 0) return (int)cudaSuccess;
  const int ct_log2 = log2_exact(ct);
  const int64_t threads = (int64_t)ct * rows;
  if ((v != 1 && v != 4) || f % v != 0 || ct_log2 < 0 || rows < 1 || threads > kMaxThreads ||
      threads % 32 != 0 || kc < 1 || (int64_t)rows * kc * 8 > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const int nvec = f / v;
  if ((int64_t)grid_x * rows < n_out || (int64_t)grid_y * ct < nvec ||
      (int64_t)(grid_x - 1) * rows >= n_out || (int64_t)(grid_y - 1) * ct >= nvec ||
      grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  if (v == 4 && (((uintptr_t)x | (uintptr_t)out) % 16) != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const size_t smem = (size_t)rows * kc * 8;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* i = (const int*)idx;
  const float* wf = (const float*)w;
  if (v == 4)
    ell_kernel<float4><<<grid, (unsigned)threads, smem, s>>>(
        i, wf, (const float4*)x, (float4*)out, n_out, k, nvec, ct_log2, rows, kc, cs != 0);
  else
    ell_kernel<float><<<grid, (unsigned)threads, smem, s>>>(
        i, wf, (const float*)x, (float*)out, n_out, k, nvec, ct_log2, rows, kc, cs != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ell_resident_f32(const void* idx, const void* w, const void* x, void* out, int n_out, int k,
                     int f, int v, int ct, int rows, int kc, int grid_x, int grid_y, int cs,
                     void* stream) {
  return launch(idx, w, x, out, n_out, k, f, v, ct, rows, kc, grid_x, grid_y, cs, stream);
}

int ell_hbm_f32(const void* idx, const void* w, const void* x, void* out, int n_out, int k,
                int f, int v, int ct, int rows, int kc, int grid_x, int grid_y, int cs,
                void* stream) {
  return launch(idx, w, x, out, n_out, k, f, v, ct, rows, kc, grid_x, grid_y, cs, stream);
}

// Resident blocks an SM holds of the V = v body at `threads` threads and
// `smem` bytes of dynamic shared memory; a negative CUDA error code on failure.
int ell_occupancy(int v, int threads, int smem) {
  int blocks = 0;
  const cudaError_t e =
      v == 4 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ell_kernel<float4>,
                                                             threads, (size_t)smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ell_kernel<float>,
                                                             threads, (size_t)smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

}  // extern "C"
