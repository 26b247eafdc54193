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
// K1 is the pallas_call at :217 (_k1_body, _k1_body_rs, _k1_body_pk), K2 the
// one at :245 (_k2_body).  The backward pass runs the same pair with the
// banks swapped.
//
// Bound on this card: bytes.  Each key g does 2*A*A*F operations on
// 2*A*F carry and A*A bank elements, about A = 21 operations per element
// (5 per byte in f32, 10 in bf16), below the ~20 f32 operations per byte of
// device memory that the CUDA cores sustain (67 TFLOP/s over 3.35 TB/s), so
// tensor cores would buy nothing.  K1 moves x, w1 and z once; K2 reads x
// twice (its own key's gc rows for the product and the rg rows of the
// diagonal, which are different rows of the tensor), plus z, w2 and d.
//
// Design, one body for both kernels (a template on which side is rg, which
// way the slab is read, and K2's epilogue):
//  - 16-byte accesses: a thread owns V = 16 / itemsize contiguous features
//    of one key in every row it reads and writes, neighbouring threads the
//    neighbouring chunks.  Where F * itemsize is not a multiple of 16 or a
//    pointer is not 16-byte aligned, the caller's plan picks V = 1 and the
//    same body runs one element a thread;
//  - several keys a block: a block takes `keys` consecutive keys, so its
//    bank slabs w[r, g0:g0+keys, :] arrive as A contiguous runs of keys*A
//    elements.  Each key's slab is kept in shared memory as f32, transposed
//    for K2 and zero-padded so that a thread reads the weights of its
//    output rows for one input row with one vector load;
//  - no dependent round trip per output row: the loops over A are unrolled
//    to a compile-time bound (21, the paths' alphabet, or 32), each thread issues its A
//    input chunks before it stages the slabs and holds them in registers as
//    loaded (bf16 pairs packed in 32-bit words, widened where used), the
//    slab staging issues several rows of a column before it stores any, and
//    a thread computes kGroup output rows at once (K2 issuing their z and x
//    chunks first).
// The launch plan (V, the bound of A, keys, threads, grid) is computed by the
// caller (ops/hyper_kernels.py, launch_plan, which reads the k* bounds below
// from this file); the entry points check it, size the shared memory and
// return cudaErrorInvalidValue on a plan they cannot run.  f32 accumulation;
// stores in the carry dtype, rounded to nearest even.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes.  Each
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxAlphabet = 32;  // the compile-time bounds of the A loops: 21 and this
constexpr int kMaxKeys = 8;       // keys a block: 8 * 32 * 33 * 4 bytes = 33 KB of slabs at most
constexpr int kMaxThreads = 256;  // launch bound: up to 255 registers a thread
constexpr int kRows = 4;          // slab rows padded to a multiple of this (16 bytes)
// Bank rows a thread loads before it stores them: K2 at A <= 21 takes a
// whole column (one round trip, which K2 at two blocks an SM feels: PERF.md
// has the times); elsewhere 8, so that the held input chunks and the staged
// rows fit in registers without spills.
template <bool kK2, int AMAX>
constexpr int kStageRows = kK2 && AMAX <= 21 ? AMAX : 8;
template <bool kK2>
constexpr int kGroup = kK2 ? 4 : 2;  // output rows a thread computes together

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float from_f32(const float*, float v) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f32(const __nv_bfloat16*, float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// bf16 halves of a 32-bit word as f32.  Volatile, so that the compiler
// widens a chunk where it is used and does not hoist the widened copies of
// all A chunks (8 * A registers) out of the loop over output rows.
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  uint32_t u;
  asm volatile("shl.b32 %0, %1, 16;" : "=r"(u) : "r"(w));
  return __uint_as_float(u);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  uint32_t u;
  asm volatile("and.b32 %0, %1, 0xffff0000;" : "=r"(u) : "r"(w));
  return __uint_as_float(u);
}

// V contiguous features of one row, held as loaded.  widen() gives them as
// f32; store() writes V f32 values in the carry dtype.
template <typename T, int V>
struct Chunk;

template <>
struct Chunk<float, 4> {
  float4 q;
  __device__ __forceinline__ void load(const float* p) {
    q = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() { q = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void widen(float* v) const {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 q;  // bf16 pairs, low half first
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    q = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { q = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void widen(float* v) const {
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
    v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z); v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                              pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
};

template <typename T>
struct Chunk<T, 1> {
  T q;
  __device__ __forceinline__ void load(const T* p) { q = p[0]; }
  __device__ __forceinline__ void zero() { q = from_f32(&q, 0.0f); }
  __device__ __forceinline__ void widen(float* v) const { v[0] = to_f32(q); }
  static __device__ __forceinline__ void store(T* p, const float* v) { p[0] = from_f32(p, v[0]); }
};

struct Args {
  const void* w;    // bank [A, G, A]: w1 (K1) or w2 (K2)
  const void* in;   // product input: x as rg (K1) or as gc (K2)
  void* out;        // z [G, A, F] (K1) or out [A, G, F] (K2)
  const void* z;    // K2: z as rg [A, G, F]
  const float* d;   // K2: diagonal [A, G]
  int a, g, f;
  int keys;         // consecutive keys a block
  int ct;           // chunks of one key a block (threads per key)
  float scale, shift;
};

// AMAX: the compile-time bound of the loops over A (the alphabet itself
// where an instantiation has it: 21).  Each key's slab sits in shared memory
// as s[in][out], f32, padded with zeros to [AMAX][OP] with OP a multiple of
// kRows, so the product loops run to AMAX with no guard and read the
// weights of kGroup output rows of one input row as one vector load.
template <int AMAX>
struct Padded {
  static constexpr int OP = (AMAX + kRows - 1) / kRows * kRows;  // out-side row length
  static constexpr int SLAB = AMAX * OP;                           // floats a key
  static constexpr int BYTES = (SLAB + OP) * (int)sizeof(float);   // slab and diagonal a key
};
static_assert(kMaxKeys * Padded<kMaxAlphabet>::BYTES <= 48 * 1024,
              "the slabs of a block fit the shared memory a launch gets without opt-in");

template <typename T, int V, int AMAX, bool kK2>
__global__ void __launch_bounds__(kMaxThreads) hyper_kernel(const Args args) {
  constexpr int OP = Padded<AMAX>::OP, SLAB = Padded<AMAX>::SLAB;
  extern __shared__ __align__(16) float smem[];  // slabs [keys][AMAX][OP], then d [keys][OP]
  const int a = args.a;
  const int64_t gdim = args.g, fdim = args.f;
  const int kl = threadIdx.x / args.ct;
  const int g0 = blockIdx.x * args.keys;
  const int key = g0 + kl;
  const int64_t col = (int64_t)(blockIdx.y * args.ct + threadIdx.x - kl * args.ct) * V;
  const bool active = kl < args.keys && key < args.g && col < fdim;
  float* ws = smem;
  float* ds = smem + args.keys * SLAB;

  // The slabs' padding: rows past a (all OP entries) and, in the others, the
  // entries past a.  Disjoint from the weights, so no barrier between.
  if (a < OP) {
    for (int i = threadIdx.x; i < args.keys * AMAX; i += blockDim.x) {
      float* row = ws + i * OP;  // key i / AMAX, input row i % AMAX
      for (int e = i % AMAX < a ? a : 0; e < OP; ++e) row[e] = 0.0f;
    }
  }

  // Input rows, issued before the slab barrier: K1 reads x[r, key, :] (rg,
  // row stride G), K2 reads x_gc[key, c, :] (gc, contiguous rows).  Rows
  // past A are zero: their slab weights are zero too.
  const T* in = static_cast<const T*>(args.in);
  const int64_t in_row0 = kK2 ? (int64_t)key * a : (int64_t)key;
  const int64_t in_step = kK2 ? 1 : gdim;
  Chunk<T, V> xin[AMAX];
#pragma unroll
  for (int r = 0; r < AMAX; ++r) {
    if (active && r < a) {
      xin[r].load(in + (in_row0 + r * in_step) * fdim + col);
    } else {
      xin[r].zero();
    }
  }

  // The slabs of keys g0 .. g0+nk-1: bank row r holds w[r, g0:g0+nk, :] as
  // nk*a contiguous elements.  A thread takes columns j of those rows (key
  // j / a, entry j % a) and loads kStageRows rows of a column before it
  // stores them; K2's
  // thread j also loads d[r, g0 + kk] for r = j / nk, kk = j % nk.  K1 sums
  // over the bank's r (s[r][c]), K2 over its c (s[c][r]).
  const int nk = min(args.keys, args.g - g0);
  const int run = nk * a;
  const T* w = static_cast<const T*>(args.w) + (int64_t)g0 * a;
  const int64_t w_step = gdim * a;
  for (int j = threadIdx.x; j < run; j += blockDim.x) {
    const int dr = j / nk;
    const float dj = kK2 ? args.d[(int64_t)dr * gdim + g0 + j - dr * nk] : 0.0f;
    const int kk = j / a;
    const int c = j - kk * a;
    float* sk = ws + kk * SLAB;
#pragma unroll 1
    for (int r0 = 0; r0 < a; r0 += kStageRows<kK2, AMAX>) {
      T wc[kStageRows<kK2, AMAX>];
#pragma unroll
      for (int u = 0; u < kStageRows<kK2, AMAX>; ++u) {
        if (r0 + u < a) wc[u] = w[(r0 + u) * w_step + j];
      }
#pragma unroll
      for (int u = 0; u < kStageRows<kK2, AMAX>; ++u) {
        const int r = r0 + u;
        if (r < a) sk[kK2 ? c * OP + r : r * OP + c] = to_f32(wc[u]);
      }
    }
    if (kK2) ds[(j - dr * nk) * OP + dr] = dj;
  }
  __syncthreads();
  if (!active) return;

  const float* slab = ws + kl * SLAB;
  T* out = static_cast<T*>(args.out);
  const T* z = static_cast<const T*>(args.z);
  constexpr int R = kGroup<kK2>;
  for (int o0 = 0; o0 < a; o0 += R) {
    // K2: z and x at the rg rows o0 .. o0+R-1 of this key, issued before the
    // product of those rows (ptxas places them after it: PERF.md).
    Chunk<T, V> ze[R], xe[R];
    if (kK2) {
#pragma unroll
      for (int p = 0; p < R; ++p) {
        if (o0 + p < a) {
          const int64_t idx = ((int64_t)(o0 + p) * gdim + key) * fdim + col;
          ze[p].load(z + idx);
          xe[p].load(in + idx);
        }
      }
    }
    float acc[R][V];
#pragma unroll
    for (int p = 0; p < R; ++p) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[p][v] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < AMAX; ++r) {
      float wv[R];
      if constexpr (R == 4) {
        const float4 wr = *reinterpret_cast<const float4*>(slab + r * OP + o0);
        wv[0] = wr.x; wv[1] = wr.y; wv[2] = wr.z; wv[3] = wr.w;
      } else {
        const float2 wr = *reinterpret_cast<const float2*>(slab + r * OP + o0);
        wv[0] = wr.x; wv[1] = wr.y;
      }
      float xv[V];
      xin[r].widen(xv);
#pragma unroll
      for (int p = 0; p < R; ++p) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[p][v] = fmaf(wv[p], xv[v], acc[p][v]);
      }
    }
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const int o = o0 + p;
      if (o < a) {
        int64_t out_row;
        if (kK2) {
          const float dv = ds[kl * OP + o];
          float ev[V], zv[V];
          xe[p].widen(ev);
          ze[p].widen(zv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[p][v] = args.scale * (zv[v] + dv * ev[v] + acc[p][v]) + args.shift;
          }
          out_row = (int64_t)o * gdim + key;
        } else {
          out_row = (int64_t)key * a + o;
        }
        Chunk<T, V>::store(out + out_row * fdim + col, acc[p]);
      }
    }
  }
}

// The instantiations, by the compile-time bound of the loops over A.
template <typename T, int V, bool kK2>
void launch_bounded(const Args& args, int amax, dim3 grid, int threads, cudaStream_t stream) {
  if (amax == 21) {
    const int smem = args.keys * Padded<21>::BYTES;
    hyper_kernel<T, V, 21, kK2><<<grid, threads, smem, stream>>>(args);
  } else {
    const int smem = args.keys * Padded<kMaxAlphabet>::BYTES;
    hyper_kernel<T, V, kMaxAlphabet, kK2><<<grid, threads, smem, stream>>>(args);
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The caller's plan (ops/hyper_kernels.py, launch_plan), checked: V is the
// 16-byte width or 1, the bound of A is an instantiation's and holds A, the
// grid covers every chunk of every key once and the block fits the launch
// bound.
template <typename T, bool kK2>
int launch(const Args& args, int v, int amax, int threads, int grid_x, int grid_y,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t a = args.a, g = args.g, f = args.f;
  bool ok = a >= 1 && (amax == 21 || amax == kMaxAlphabet) && a <= amax && g >= 1 && f >= 1;
  ok = ok && (v == 1 || (v == kVec && f % v == 0 && aligned16(args.in) && aligned16(args.out) &&
                         (!kK2 || aligned16(args.z))));
  ok = ok && args.keys >= 1 && args.keys <= kMaxKeys && args.ct >= 1;
  ok = ok && threads % 32 == 0 && threads <= kMaxThreads && threads >= args.keys * args.ct;
  ok = ok && grid_x == (g + args.keys - 1) / args.keys && grid_y >= 1 && grid_y <= 65535 &&
       (int64_t)grid_y * args.ct >= f / v;
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
  if (v == 1) {
    launch_bounded<T, 1, kK2>(args, amax, grid, threads, (cudaStream_t)stream);
  } else {
    launch_bounded<T, kVec, kK2>(args, amax, grid, threads, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

#define HYPER_PLAN int v, int amax, int keys, int ct, int threads, int grid_x, int grid_y

template <typename T>
int launch_k1(const void* w1, const void* x, void* z, int a, int g, int f, HYPER_PLAN,
              void* stream) {
  const Args args{w1, x, z, nullptr, nullptr, a, g, f, keys, ct, 1.0f, 0.0f};
  return launch<T, false>(args, v, amax, threads, grid_x, grid_y, stream);
}

template <typename T>
int launch_k2(const void* d, const void* w2, const void* z, const void* x, void* out, int a,
              int g, int f, float scale, float shift, HYPER_PLAN, void* stream) {
  const Args args{w2, x, out, z, (const float*)d, a, g, f, keys, ct, scale, shift};
  return launch<T, true>(args, v, amax, threads, grid_x, grid_y, stream);
}

}  // namespace

extern "C" {

#define HYPER_PLAN_ARGS v, amax, keys, ct, threads, grid_x, grid_y

int hyper_k1_f32(const void* w1, const void* x, void* z, int a, int g, int f, HYPER_PLAN,
                 void* stream) {
  return launch_k1<float>(w1, x, z, a, g, f, HYPER_PLAN_ARGS, stream);
}

int hyper_k1_bf16(const void* w1, const void* x, void* z, int a, int g, int f, HYPER_PLAN,
                  void* stream) {
  return launch_k1<__nv_bfloat16>(w1, x, z, a, g, f, HYPER_PLAN_ARGS, stream);
}

int hyper_k2_f32(const void* d, const void* w2, const void* z, const void* x, void* out, int a,
                 int g, int f, float scale, float shift, HYPER_PLAN, void* stream) {
  return launch_k2<float>(d, w2, z, x, out, a, g, f, scale, shift, HYPER_PLAN_ARGS, stream);
}

int hyper_k2_bf16(const void* d, const void* w2, const void* z, const void* x, void* out, int a,
                  int g, int f, float scale, float shift, HYPER_PLAN, void* stream) {
  return launch_k2<__nv_bfloat16>(d, w2, z, x, out, a, g, f, scale, shift, HYPER_PLAN_ARGS,
                                  stream);
}

}  // extern "C"
