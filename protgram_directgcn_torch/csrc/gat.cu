// GAT's multi-head edge softmax and aggregation on an ELL table (Hopper, sm_90a).
//
// One GAT layer (Velickovic et al., ICLR 2018; PyG GATConv form) over the
// in-edges j -> i of every target i, one self loop a node included:
//
//   e[i, k, h]  = LeakyReLU_0.2(a_src[j, h] + a_dst[i, h]),  j = idx[i, k]
//   alpha       = softmax of e over the valid slots k of row i, per head h
//   out[i, c]   = sum_k alpha[i, k, head(c)] * z[j, c],      head(c) = c / F
//
// with z [N, H*F] (the heads' projections side by side), a_src, a_dst
// [N, H], and the table idx int32 [N, K], mask f32 [N, K] (1 on a real slot,
// 0 on padding; ops/spmm.py `build_ell` with unit weights).  No TPU kernel
// of the JAX package computes this (its zoo GAT forms per-edge messages
// [E, H, F] under XLA); it was added so that GAT trains at its published
// widths: at the n = 4 level one [E, H*F] f32 message tensor is 13.4 GB.
// Nothing here holds a per-edge tensor wider than the head count.
//
// Four launches a layer and step, each plain C (no PyTorch headers), loaded
// with ctypes by ops/gat_kernels.py:
//   gat_softmax_f32    forward, one warp a (row, head): an online max and sum
//                      over the row's slots (a lane's running pair, merged
//                      across the warp), then alpha [N, K, H] and the
//                      statistics lse [N, H] (log-sum-exp);
//   gat_aggregate_f32  forward, out = alpha-weighted sum of z over the slots:
//                      csrc/ell.cu's SpMM design (16 B a thread where F % 4
//                      == 0, a 128-byte feature tile of a row's threads, the
//                      grid's y over tiles so that a tile's slice of z stays
//                      in L2, idx/alpha staged in shared memory, streaming
//                      hints on what is read once) with one weight a head;
//                      backward, the same kernel on the transpose table
//                      (idx_t: the targets of each source, alpha_t its
//                      weights) gives dz;
//   gat_edge_grad_f32  backward, one block a target row: D[h] = <dout_i, out_i>
//                      per head, then per slot and head the SDDMM
//                      d_alpha = <dout_i, z_j> (a warp's dot), alpha recomputed
//                      from lse, de = alpha (d_alpha - D), and through the
//                      LeakyReLU dpre; it writes dpre and alpha at each edge's
//                      transpose slot (perm: the flat slot j * Kt + t of the
//                      edge in the transpose table, -1 on padding), so that
//                      the transpose pass reads them in its own order, and
//                      d_a_dst[i, h] = sum_k dpre (per-warp partials summed in
//                      a fixed order: no atomics).
//   d_a_src is the sum of dpre_t over each source's transpose slots (a
//   contiguous reduction in ops/gat_kernels.py).
//
// Bound on this card: bytes.  The aggregation reads z's rows once each at
// best (N*H*F*4 bytes, 685 MB at the n = 4 level and 4 x 256), but gathers
// E*H*F*4 (13.4 GB a layer at n = 4): as csrc/ell.cu, its rate is what L2
// and L1 deliver of the gathered rows; 2*E*H*F operations at 67 TFLOP/s are
// a tenth of that time.  The edge gradient gathers z once per slot too.
// Each entry point checks its plan, returns cudaErrorInvalidValue on one it
// cannot run, and else cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;      // threads a block
constexpr int kMaxSmemBytes = 49152;  // dynamic shared memory without the opt-in
constexpr int kMaxHeads = 32;         // heads a layer (edge gradient's shared arrays)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kUnroll = 8;            // gathers in flight per thread
constexpr float kSlope = 0.2f;        // LeakyReLU's negative slope

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : kSlope * v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// exp(m - to), 0 where m is -inf (an empty running max).
__device__ __forceinline__ float rescale(float m, float to) {
  return m == -INFINITY ? 0.f : expf(m - to);
}

// ---------------------------------------------------------------------------
// Forward 1: the softmax statistics and alpha.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxThreads)
    gat_softmax_kernel(const int* __restrict__ idx, const float* __restrict__ mask,
                       const float* __restrict__ a_src, const float* __restrict__ a_dst,
                       float* __restrict__ alpha, float* __restrict__ lse, int n, int k, int h) {
  const int lane = threadIdx.x & 31;
  const int64_t pair = (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (pair >= (int64_t)n * h) return;
  const int64_t row = pair / h;
  const int head = (int)(pair - row * h);
  const float ad = a_dst[row * h + head];
  const int64_t base = row * k;
  float m = -INFINITY, s = 0.f;
  for (int j = lane; j < k; j += 32) {
    if (mask[base + j] == 0.f) continue;
    const float e = leaky(a_src[(int64_t)idx[base + j] * h + head] + ad);
    if (e > m) {
      s = s * rescale(m, e) + 1.f;
      m = e;
    } else {
      s += expf(e - m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    const float mm = fmaxf(m, m2);
    s = s * rescale(m, mm) + s2 * rescale(m2, mm);
    m = mm;
  }
  // A row without a valid slot (none here: every node has its self loop)
  // gets lse 0 and alpha 0.
  const float l = m == -INFINITY ? 0.f : m + logf(s);
  if (lane == 0) lse[row * h + head] = l;
  for (int j = lane; j < k; j += 32) {
    float a = 0.f;
    if (mask[base + j] != 0.f)
      a = expf(leaky(a_src[(int64_t)idx[base + j] * h + head] + ad) - l);
    alpha[(base + j) * h + head] = a;
  }
}

// ---------------------------------------------------------------------------
// Forward 2 and the backward's dz: the alpha-weighted ELL product.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T load_once(const T* p, bool cs) { return cs ? __ldcs(p) : __ldg(p); }
template <typename V>
__device__ __forceinline__ void store_once(V* p, const V& v, bool cs) {
  if (cs)
    __stcs(p, v);
  else
    *p = v;
}

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

// acc += w[j * h] * x[s_idx[j] * nvec + v] over slots j.. in slot order, U
// loads issued before their U fmaf's; returns the first slot left.
template <int U, typename V>
__device__ __forceinline__ int accumulate(const int* si, const float* sw, int h, int j, int n,
                                          const V* x, int nvec, int v, V& acc) {
  for (; j + U <= n; j += U) {
    V a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = x[(int64_t)si[j + u] * nvec + v];
#pragma unroll
    for (int u = 0; u < U; ++u) fma_into(acc, sw[(j + u) * h], a[u]);
  }
  return j;
}

// Thread t of block (bx, by) serves output row bx * rows + (t >> ct_log2)
// and feature vector by * ct + (t & (ct - 1)) of nvec, whose head is
// (vector * vw) / f (vw: features a vector; a vector never straddles two
// heads).  The block stages kc slots of its rows a pass: idx and the h
// weights of each slot ([rows][kc] ints, then [rows][kc][h] floats), the
// weight of head q at slot s being alpha[s * h + q].
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
    gat_aggregate_kernel(const int* __restrict__ idx, const float* __restrict__ alpha,
                         const V* __restrict__ x, V* __restrict__ out, int n_out, int k, int h, int f, int vw, int nvec,
                         int ct_log2, int rows, int kc, bool cs) {
  extern __shared__ int s_raw[];
  int* s_idx = s_raw;                                  // [rows][kc]
  float* s_w = reinterpret_cast<float*>(s_raw + rows * kc);  // [rows][kc][h]
  const int local_row = threadIdx.x >> ct_log2;
  const int64_t row0 = (int64_t)blockIdx.x * rows;
  const int64_t row = row0 + local_row;
  const int v = (blockIdx.y << ct_log2) + (threadIdx.x & ((1 << ct_log2) - 1));
  const bool live = row < n_out && v < nvec;
  const int head = live ? (v * vw) / f : 0;
  const int live_rows = n_out - row0 < rows ? (int)(n_out - row0) : rows;

  V acc = zero<V>();
  for (int k0 = 0; k0 < k; k0 += kc) {
    const int n = min(kc, k - k0);
    if (k0 > 0) __syncthreads();  // the previous chunk's slots have been read
    for (int t = threadIdx.x; t < live_rows * n; t += blockDim.x) {
      const int r = t / n;
      const int j = t - r * n;
      const int64_t g = (row0 + r) * k + k0 + j;
      s_idx[r * kc + j] = load_once(idx + g, cs);
      float* w = s_w + (r * kc + j) * h;
      for (int q = 0; q < h; ++q) w[q] = load_once(alpha + g * h + q, cs);
    }
    __syncthreads();
    if (live) {
      const int* si = s_idx + local_row * kc;
      const float* sw = s_w + local_row * kc * h + head;
      int j = accumulate<kUnroll>(si, sw, h, 0, n, x, nvec, v, acc);
      j = accumulate<4>(si, sw, h, j, n, x, nvec, v, acc);
      accumulate<1>(si, sw, h, j, n, x, nvec, v, acc);
    }
  }
  if (live) store_once(out + row * nvec + v, acc, cs);
}

// ---------------------------------------------------------------------------
// Backward: the edge gradient (SDDMM through the softmax and the LeakyReLU).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot_part(const float& a, const float& b) { return a * b; }
__device__ __forceinline__ float dot_part(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// <p[0:fv], q[0:fv]> over a warp's lanes (fv vectors of V), on every lane.
template <typename V>
__device__ __forceinline__ float warp_dot(const V* p, const V* q, int fv, int lane) {
  float acc = 0.f;
  for (int c = lane; c < fv; c += 32) acc += dot_part(p[c], q[c]);
  return warp_sum(acc);
}

// Block = one target row i; warp w takes heads w, w + W, ... for D, then
// slots w, w + W, ... for the edges.  fv = F / vw vectors a head.  dpre_t
// and alpha_t are written at the edge's transpose slot perm[slot] (their
// padding slots are left as the caller set them: 0).
template <typename V>
__global__ void __launch_bounds__(kMaxThreads)
    gat_edge_grad_kernel(const int* __restrict__ idx, const float* __restrict__ mask,
                         const int* __restrict__ perm, const V* __restrict__ z,
                         const V* __restrict__ dout,
                         const V* __restrict__ out, const float* __restrict__ a_src,
                         const float* __restrict__ a_dst, const float* __restrict__ lse,
                         float* __restrict__ dpre_t, float* __restrict__ alpha_t,
                         float* __restrict__ d_a_dst, int k, int h, int fv) {
  __shared__ float s_d[kMaxHeads], s_ad[kMaxHeads], s_lse[kMaxHeads];
  __shared__ float s_part[kMaxWarps][kMaxHeads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t row = blockIdx.x;
  const int64_t row_vec = row * h * fv;  // the row's first vector in z, dout, out
  for (int q = warp; q < h; q += warps) {
    const float d = warp_dot(dout + row_vec + (int64_t)q * fv, out + row_vec + (int64_t)q * fv,
                             fv, lane);
    if (lane == 0) {
      s_d[q] = d;
      s_ad[q] = a_dst[row * h + q];
      s_lse[q] = lse[row * h + q];
    }
  }
  for (int q = lane; q < h; q += 32) s_part[warp][q] = 0.f;
  __syncthreads();
  const int64_t base = row * k;
  for (int j = warp; j < k; j += warps) {
    const bool valid = mask[base + j] != 0.f;
    const int64_t src = idx[base + j];
    const int64_t to = perm[base + j];
    for (int q = 0; q < h; ++q) {
      float g = 0.f, a = 0.f;
      if (valid) {
        const float da = warp_dot(dout + row_vec + (int64_t)q * fv,
                                  z + (src * h + q) * fv, fv, lane);
        const float pre = a_src[src * h + q] + s_ad[q];
        a = expf(leaky(pre) - s_lse[q]);
        const float de = a * (da - s_d[q]);
        g = pre > 0.f ? de : kSlope * de;
      }
      if (lane == 0) {
        if (to >= 0) {
          dpre_t[to * h + q] = g;
          alpha_t[to * h + q] = a;
        }
        s_part[warp][q] += g;
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < h; q += blockDim.x) {
    float total = 0.f;
    for (int w = 0; w < warps; ++w) total += s_part[w][q];
    d_a_dst[row * h + q] = total;
  }
}

int log2_exact(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return (1 << l) == n ? l : -1;
}

bool aligned16(const void* p) { return ((uintptr_t)p % 16) == 0; }

}  // namespace

extern "C" {

// threads: a multiple of 32; one warp a (row, head) pair.
int gat_softmax_f32(const void* idx, const void* mask, const void* a_src, const void* a_dst,
                    void* alpha, void* lse, int n, int k, int h, int threads, void* stream) {
  if (n < 0 || k < 1 || h < 1 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int64_t pairs = (int64_t)n * h;
  const int64_t blocks = (pairs + threads / 32 - 1) / (threads / 32);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  gat_softmax_kernel<<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>(
      (const int*)idx, (const float*)mask, (const float*)a_src, (const float*)a_dst,
      (float*)alpha, (float*)lse, n, k, h);
  return (int)cudaGetLastError();
}

// The plan (ops/gat_kernels.py `launch_plan`): v features a thread (4 only
// where f % 4 == 0 and x, out are 16-byte aligned), ct threads a row (a
// power of two), `rows` rows a block, kc slots staged a pass, grid (row
// blocks, feature tiles), cs the streaming hints.
int gat_aggregate_f32(const void* idx, const void* alpha, const void* x, void* out, int n_out, int k, int h, int f, int v, int ct, int rows, int kc,
                      int grid_x, int grid_y, int cs, void* stream) {
  if (n_out < 0 || k < 1 || h < 1 || f < 1) return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaSuccess;
  const int ct_log2 = log2_exact(ct);
  const int64_t threads = (int64_t)ct * rows;
  const int64_t smem = (int64_t)rows * kc * 4 * (1 + h);
  if ((v != 1 && v != 4) || f % v != 0 || ct_log2 < 0 || rows < 1 || threads > kMaxThreads ||
      threads % 32 != 0 || kc < 1 || kc > k || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  const int nvec = h * f / v;
  if ((int64_t)grid_x * rows < n_out || (int64_t)grid_y * ct < nvec ||
      (int64_t)(grid_x - 1) * rows >= n_out || (int64_t)(grid_y - 1) * ct >= nvec ||
      grid_y > 65535)
    return (int)cudaErrorInvalidValue;
  if (v == 4 && !(aligned16(x) && aligned16(out))) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)grid_y);
  const cudaStream_t s = (cudaStream_t)stream;
  if (v == 4)
    gat_aggregate_kernel<float4><<<grid, (unsigned)threads, (size_t)smem, s>>>(
        (const int*)idx, (const float*)alpha, (const float4*)x, (float4*)out,
        n_out, k, h, f, 4, nvec, ct_log2, rows, kc, cs != 0);
  else
    gat_aggregate_kernel<float><<<grid, (unsigned)threads, (size_t)smem, s>>>(
        (const int*)idx, (const float*)alpha, (const float*)x, (float*)out,
        n_out, k, h, f, 1, nvec, ct_log2, rows, kc, cs != 0);
  return (int)cudaGetLastError();
}

// One block a target row of `threads` threads (a multiple of 32, at most
// kMaxThreads); v = 4 only where f % 4 == 0 and z, dout, out are 16-byte
// aligned.  dpre_t and alpha_t: [N_t * Kt, H], zero on entry.
int gat_edge_grad_f32(const void* idx, const void* mask, const void* perm, const void* z,
                      const void* dout, const void* out, const void* a_src, const void* a_dst,
                      const void* lse, void* dpre_t, void* alpha_t, void* d_a_dst, int n, int k,
                      int h, int f, int v, int threads, void* stream) {
  if (n < 0 || k < 1 || h < 1 || h > kMaxHeads || f < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || (v != 1 && v != 4) || f % v != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (v == 4 && !(aligned16(z) && aligned16(dout) && aligned16(out)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (v == 4)
    gat_edge_grad_kernel<float4><<<(unsigned)n, (unsigned)threads, 0, s>>>(
        (const int*)idx, (const float*)mask, (const int*)perm, (const float4*)z,
        (const float4*)dout,
        (const float4*)out, (const float*)a_src, (const float*)a_dst, (const float*)lse,
        (float*)dpre_t, (float*)alpha_t, (float*)d_a_dst, k, h, f / 4);
  else
    gat_edge_grad_kernel<float><<<(unsigned)n, (unsigned)threads, 0, s>>>(
        (const int*)idx, (const float*)mask, (const int*)perm, (const float*)z,
        (const float*)dout,
        (const float*)out, (const float*)a_src, (const float*)a_dst, (const float*)lse,
        (float*)dpre_t, (float*)alpha_t, (float*)d_a_dst, k, h, f);
  return (int)cudaGetLastError();
}

}  // extern "C"
