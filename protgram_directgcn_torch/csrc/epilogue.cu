// The DirectGCN layer's elementwise tail for Hopper (sm_90a), one kernel
// each way.  Per element of a layer's [R, F] output, with the five gates
// c_in, c_out, c_dir, c_und, c_all read once a row (a node's, or one scalar
// each) and the three biases once a column:
//
//   forward:   ic = pi + b_in,  oc = po + b_out,  uc = pu + b_und
//              t  = c_in*ic + c_out*oc
//              m  = c_und*uc + c_dir*t
//              s  = (c_all*m + const) + res
//              a  = s > 0 ? s : s*slope                       (leaky ReLU)
//              out = u < keep ? a*inv_keep : 0               (dropout; out = a without u)
//              code = (s > 0) | (u < keep) << 1              (one byte, for the backward)
//   backward:  g  = code & 2 ? dout*inv_keep : 0,  ds = code & 1 ? g : g*slope
//              e  = ds*c_all,  f = e*c_dir
//              d_pi = f*c_in,  d_po = f*c_out,  d_pu = e*c_und,  ds (const and res)
//              d_c_all = sum_F ds*m,  d_c_und = sum_F e*uc,  d_c_dir = sum_F e*t,
//              d_c_in = sum_F f*ic,   d_c_out = sum_F f*oc    (a row's sums)
//              d_b_in, d_b_out, d_b_und: the column sums of d_pi, d_po, d_pu.
//
// Every product and sum of the forward and every elementwise output of the
// backward rounds once, in the order of the plain ATen chain
// (ops/epilogue_kernels.py tail_plain; __fmul_rn / __fadd_rn, so no FMA
// contraction), and inv_keep is ATen's 1/keep for a division by a scalar
// on the card: those outputs equal the chain's to the bit.  The sums are
// taken in another order than ATen's reductions.
//
// Replaces no TPU kernel: under XLA the JAX package's tail fused into the
// propagation's consumers.  The port ran it as ATen ops, about 20 launches
// forward and 35 backward a layer, each a pass over [R, F].
//
// Bound on this card: bytes.  The forward reads pi, po, pu, const, res and
// u and writes out and the code (29 bytes an element); the backward reads
// dout, the code, pi, po and pu and writes d_pi, d_po, d_pu and ds (33).
// Design, for that:
//   - a row belongs to a group of `lanes` lanes of one warp (a power of two
//     up to 32, ~F/V), which walk its columns V = 4 elements (16 bytes) a
//     load where F % 4 == 0 and every pointer is aligned, one otherwise;
//     warps walk the rows with a grid stride, so no block is short of work;
//   - a row's five gate sums are a shuffle reduction inside its group: no
//     atomics, and a row's sum is the same whatever block takes it;
//   - the bias sums: each lane keeps its columns' sums over its rows in
//     registers (kMaxChunks * V columns at most), the block adds its groups'
//     in a fixed order through shared memory and writes one partial a
//     column, and the last block to finish (a counter that it resets) adds
//     the partials in block order, as sum_squares in csrc/optim.cu does.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes.  Each
// returns cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// a shape or plan it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 8;  // vectors of a row one lane holds
constexpr int kGates = 5;      // c_in, c_out, c_dir, c_und, c_all
constexpr int kSmemBytes = 48 * 1024;  // the backward's shared memory at most

struct Tail {
  const float* pi;
  const float* po;
  const float* pu;
  const float* b_in;
  const float* b_out;
  const float* b_und;
  const float* gate[kGates];
  long long gate_stride[kGates];  // 1: one a row; 0: one scalar
  long long rows;
  int f;
  int lanes;  // a row's lanes, a power of two <= 32
  float slope;
  float keep;
  float inv_keep;
};

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

template <int V>
__device__ __forceinline__ void store_code(unsigned char* __restrict__ p,
                                           const unsigned char (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<uchar4*>(p) = make_uchar4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = v[k];
  }
}

__device__ __forceinline__ void load_gates(const Tail& a, long long row, float (&g)[kGates]) {
#pragma unroll
  for (int k = 0; k < kGates; ++k) g[k] = a.gate[k][row * a.gate_stride[k]];
}

template <int V>
__global__ void __launch_bounds__(kThreads) epilogue_fwd_kernel(
    const Tail a, const float* __restrict__ cst, const float* __restrict__ res,
    const float* __restrict__ u, float* __restrict__ out, unsigned char* __restrict__ code) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (a.lanes - 1);
  const int rows_per_warp = 32 / a.lanes;
  const long long warp = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const long long step = (long long)gridDim.x * kWarps * rows_per_warp;
  for (long long row = warp * rows_per_warp + lane / a.lanes; row < a.rows; row += step) {
    float g[kGates];
    load_gates(a, row, g);
    const float c_in = g[0], c_out = g[1], c_dir = g[2], c_und = g[3], c_all = g[4];
    for (int c = sub * V; c < a.f; c += a.lanes * V) {
      const long long i = row * a.f + c;
      float pi[V], po[V], pu[V], bi[V], bo[V], bu[V], k[V], r[V], o[V];
      load<V>(a.pi + i, pi);
      load<V>(a.po + i, po);
      load<V>(a.pu + i, pu);
      load<V>(a.b_in + c, bi);
      load<V>(a.b_out + c, bo);
      load<V>(a.b_und + c, bu);
      load<V>(cst + i, k);
      load<V>(res + i, r);
      float uu[V];
      if (u != nullptr) load<V>(u + i, uu);
      unsigned char cd[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float ic = __fadd_rn(pi[e], bi[e]);
        const float oc = __fadd_rn(po[e], bo[e]);
        const float uc = __fadd_rn(pu[e], bu[e]);
        const float t = __fadd_rn(__fmul_rn(c_in, ic), __fmul_rn(c_out, oc));
        const float m = __fadd_rn(__fmul_rn(c_und, uc), __fmul_rn(c_dir, t));
        const float s = __fadd_rn(__fadd_rn(__fmul_rn(c_all, m), k[e]), r[e]);
        const bool pos = s > 0.0f;
        const float act = pos ? s : __fmul_rn(s, a.slope);
        const bool kept = u == nullptr || uu[e] < a.keep;
        o[e] = u == nullptr ? act : (kept ? __fmul_rn(act, a.inv_keep) : 0.0f);
        cd[e] = (unsigned char)(pos | (kept << 1));
      }
      store<V>(out + i, o);
      if (code != nullptr) store_code<V>(code + i, cd);
    }
  }
}

template <int V, int CH>
__global__ void __launch_bounds__(kThreads) epilogue_bwd_kernel(
    const Tail a, const float* __restrict__ dout, const unsigned char* __restrict__ code,
    float* __restrict__ d_pi, float* __restrict__ d_po, float* __restrict__ d_pu,
    float* __restrict__ ds_out, float* __restrict__ d_gate, float* __restrict__ partials,
    unsigned int* __restrict__ counter, float* __restrict__ d_bias) {
  extern __shared__ float smem[];  // [groups of the block][f]
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (a.lanes - 1);
  const int rows_per_warp = 32 / a.lanes;
  const long long warp = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const long long step = (long long)gridDim.x * kWarps * rows_per_warp;
  float bias[3][CH][V];
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int k = 0; k < CH; ++k)
#pragma unroll
      for (int e = 0; e < V; ++e) bias[b][k][e] = 0.0f;
  // The loop's bound is the warp's, so that every lane takes every shuffle.
  for (long long row0 = warp * rows_per_warp; row0 < a.rows; row0 += step) {
    const long long row = row0 + lane / a.lanes;
    const bool active = row < a.rows;
    float g[kGates] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (active) load_gates(a, row, g);
    const float c_in = g[0], c_out = g[1], c_dir = g[2], c_und = g[3], c_all = g[4];
    float sum[kGates] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = (k * a.lanes + sub) * V;
      if (!active || c >= a.f) continue;
      const long long i = row * a.f + c;
      float dy[V], pi[V], po[V], pu[V], bi[V], bo[V], bu[V];
      float dpi[V], dpo[V], dpu[V], dsv[V];
      load<V>(dout + i, dy);
      load<V>(a.pi + i, pi);
      load<V>(a.po + i, po);
      load<V>(a.pu + i, pu);
      load<V>(a.b_in + c, bi);
      load<V>(a.b_out + c, bo);
      load<V>(a.b_und + c, bu);
      unsigned char cd[V];
      if constexpr (V == 4) {
        const uchar4 t = *reinterpret_cast<const uchar4*>(code + i);
        cd[0] = t.x; cd[1] = t.y; cd[2] = t.z; cd[3] = t.w;
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) cd[e] = code[i + e];
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float gr = (cd[e] & 2) ? __fmul_rn(dy[e], a.inv_keep) : 0.0f;
        const float ds = (cd[e] & 1) ? gr : __fmul_rn(gr, a.slope);
        const float ic = __fadd_rn(pi[e], bi[e]);
        const float oc = __fadd_rn(po[e], bo[e]);
        const float uc = __fadd_rn(pu[e], bu[e]);
        const float t = __fadd_rn(__fmul_rn(c_in, ic), __fmul_rn(c_out, oc));
        const float m = __fadd_rn(__fmul_rn(c_und, uc), __fmul_rn(c_dir, t));
        const float em = __fmul_rn(ds, c_all);
        const float ft = __fmul_rn(em, c_dir);
        sum[4] += __fmul_rn(ds, m);
        sum[3] += __fmul_rn(em, uc);
        sum[2] += __fmul_rn(em, t);
        sum[0] += __fmul_rn(ft, ic);
        sum[1] += __fmul_rn(ft, oc);
        dpi[e] = __fmul_rn(ft, c_in);
        dpo[e] = __fmul_rn(ft, c_out);
        dpu[e] = __fmul_rn(em, c_und);
        dsv[e] = ds;
        bias[0][k][e] += dpi[e];
        bias[1][k][e] += dpo[e];
        bias[2][k][e] += dpu[e];
      }
      store<V>(d_pi + i, dpi);
      store<V>(d_po + i, dpo);
      store<V>(d_pu + i, dpu);
      store<V>(ds_out + i, dsv);
    }
#pragma unroll
    for (int j = 0; j < kGates; ++j)
      for (int o = a.lanes / 2; o > 0; o >>= 1) sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], o);
    if (active && sub == 0) {
#pragma unroll
      for (int j = 0; j < kGates; ++j) d_gate[j * a.rows + row] = sum[j];
    }
  }
  // The block's column sums: its groups' in order, through shared memory.
  const int groups = kThreads / a.lanes;
  const int group = threadIdx.x / a.lanes;
  for (int b = 0; b < 3; ++b) {
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int c = (k * a.lanes + sub) * V;
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (c + e < a.f) smem[group * a.f + c + e] = bias[b][k][e];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < a.f; c += kThreads) {
      float s = 0.0f;
      for (int q = 0; q < groups; ++q) s += smem[q * a.f + c];
      partials[((long long)blockIdx.x * 3 + b) * a.f + c] = s;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(counter, gridDim.x) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The last block: the partials in block order, whichever block was last.
  __threadfence();
  for (int j = threadIdx.x; j < 3 * a.f; j += kThreads) {
    const int b = j / a.f, c = j - b * a.f;
    float s = 0.0f;
    for (int q = 0; q < (int)gridDim.x; ++q) s += __ldcg(partials + ((long long)q * 3 + b) * a.f + c);
    d_bias[j] = s;
  }
  if (threadIdx.x == 0) *counter = 0u;
}

// Read the shared arguments: ptrs holds pi, po, pu, b_in, b_out, b_und and
// the five gates; gate_rows[k] is 1 where gate k has one value a row.
bool fill(Tail& a, const long long* ptrs, const int* gate_rows, long long rows, int f, int vec,
          int lanes, float slope, float keep, float inv_keep) {
  if (rows < 0 || f < 1 || (vec != 1 && vec != 4) || (vec == 4 && f % 4) || lanes < 1 ||
      lanes > 32 || (lanes & (lanes - 1)))
    return false;
  a.pi = (const float*)ptrs[0];
  a.po = (const float*)ptrs[1];
  a.pu = (const float*)ptrs[2];
  a.b_in = (const float*)ptrs[3];
  a.b_out = (const float*)ptrs[4];
  a.b_und = (const float*)ptrs[5];
  for (int k = 0; k < kGates; ++k) {
    a.gate[k] = (const float*)ptrs[6 + k];
    a.gate_stride[k] = gate_rows[k] ? 1 : 0;
  }
  a.rows = rows;
  a.f = f;
  a.lanes = lanes;
  a.slope = slope;
  a.keep = keep;
  a.inv_keep = inv_keep;
  return true;
}

// Blocks for `rows` rows: as many as the card holds at once, fewer where the
// rows run out first; at most `cap`.
template <typename K>
int grid_of(K kernel, long long rows, int lanes, int smem, int cap) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const long long rows_per_block = (long long)kWarps * (32 / lanes);
  long long grid = (rows + rows_per_block - 1) / rows_per_block;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > full) grid = full;
  if (grid > cap) grid = cap;
  return (int)(grid > 0 ? grid : 1);
}

template <int V, int CH>
int launch_bwd(const Tail& a, const long long* ptrs, int max_blocks, cudaStream_t stream) {
  const int smem = (kThreads / a.lanes) * a.f * (int)sizeof(float);
  if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
  auto kernel = epilogue_bwd_kernel<V, CH>;
  const int grid = grid_of(kernel, a.rows, a.lanes, smem, max_blocks);
  kernel<<<grid, kThreads, smem, stream>>>(
      a, (const float*)ptrs[11], (const unsigned char*)ptrs[12], (float*)ptrs[13],
      (float*)ptrs[14], (float*)ptrs[15], (float*)ptrs[16], (float*)ptrs[17],
      (float*)ptrs[18], (unsigned int*)ptrs[19], (float*)ptrs[20]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward.  ptrs: pi, po, pu, b_in, b_out, b_und, c_in, c_out, c_dir,
// c_und, c_all, const, res, u (0: no dropout), out, code (0: none kept).
int epilogue_fwd(const long long* ptrs, const int* gate_rows, long long rows, int f, int vec,
                 int lanes, float slope, float keep, float inv_keep, void* stream) {
  Tail a;
  if (!fill(a, ptrs, gate_rows, rows, f, vec, lanes, slope, keep, inv_keep))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const float* cst = (const float*)ptrs[11];
  const float* res = (const float*)ptrs[12];
  const float* u = (const float*)ptrs[13];
  float* out = (float*)ptrs[14];
  unsigned char* code = (unsigned char*)ptrs[15];
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    const int grid = grid_of(epilogue_fwd_kernel<4>, rows, lanes, 0, 0x7fffffff);
    epilogue_fwd_kernel<4><<<grid, kThreads, 0, s>>>(a, cst, res, u, out, code);
  } else {
    const int grid = grid_of(epilogue_fwd_kernel<1>, rows, lanes, 0, 0x7fffffff);
    epilogue_fwd_kernel<1><<<grid, kThreads, 0, s>>>(a, cst, res, u, out, code);
  }
  return (int)cudaGetLastError();
}

// The backward.  ptrs: the forward's first eleven, then dout, code, d_pi,
// d_po, d_pu, ds, d_gate [5, rows], partials [max_blocks, 3, f], counter
// (0 between launches), d_bias [3, f].  chunks: vectors of a row a lane
// holds (1, 2, 4 or 8, with lanes * chunks * vec >= f).
int epilogue_bwd(const long long* ptrs, const int* gate_rows, long long rows, int f, int vec,
                 int lanes, int chunks, int max_blocks, float slope, float inv_keep,
                 void* stream) {
  Tail a;
  if (!fill(a, ptrs, gate_rows, rows, f, vec, lanes, slope, 1.0f, inv_keep) || max_blocks < 1 ||
      chunks > kMaxChunks || (long long)lanes * chunks * vec < f)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    switch (chunks) {
      case 1: return launch_bwd<4, 1>(a, ptrs, max_blocks, s);
      case 2: return launch_bwd<4, 2>(a, ptrs, max_blocks, s);
      case 4: return launch_bwd<4, 4>(a, ptrs, max_blocks, s);
      case 8: return launch_bwd<4, 8>(a, ptrs, max_blocks, s);
    }
  } else {
    switch (chunks) {
      case 1: return launch_bwd<1, 1>(a, ptrs, max_blocks, s);
      case 2: return launch_bwd<1, 2>(a, ptrs, max_blocks, s);
      case 4: return launch_bwd<1, 4>(a, ptrs, max_blocks, s);
      case 8: return launch_bwd<1, 8>(a, ptrs, max_blocks, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
