// Retile kernels for Hopper (sm_90a): pack and unpack the sub-128-wide rg
// carry of the memory tier that rematerialises per path (tier 3).
//
// Layout contract (models/directgcn.py, pack_rg_carry): with f the carry
// width (8, 16, 32 or 64) and k = 128 / f, packed row i of plane a holds
// the nodes k*i .. k*i+k-1 of that plane in consecutive f-wide segments of
// its 128 elements.
//
//   unpack  in [A, GP, 128] -> out [A, GP*k, 128]:
//           out[a, k*i + j, l] = in[a, i, j*f + l] for l < f, 0 for l >= f
//   pack    in [A, G8, L] (L = f, or L = 128 read at lanes [0:f] only)
//           -> out [A, G8/k, 128]:  out[a, i, j*f + l] = in[a, k*i + j, l]
//
// Replaces the Pallas kernels of protgram_directgcn_tpu/ops/pallas_retile.py:
// unpack is _unpack_pad_impl (:78, body _unpack_body), pack is _pack_impl
// (:109, body _pack_body).  Each is the other's backward.
//
// Bound on this card: bytes.  The kernels do no arithmetic; each reads its
// input once and writes its output once.  Design: the element type does not
// matter to a copy, so both types run one body over 16-byte chunks (4 f32 or
// 8 bf16 elements).  Every f is a multiple of a chunk, so a chunk never
// straddles a segment: one thread loads one 16-byte chunk and stores it,
// neighbouring threads on neighbouring output chunks (coalesced stores),
// and the chunks they read are neighbours too, within a row or across the
// k segments of a packed row.  Unpack writes its zero lanes in the same
// pass.  The plane index a folds into the row index: row k*i + j of plane a
// is global row k*(a*GP + i) + j of the flattened [A*GP*k, 128] output.
//
// Plain C entry points (no PyTorch headers), loaded with ctypes.  Each
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkBytes = 16;
constexpr int kThreads = 256;

// out rows of 128 elements, each kRowChunks chunks; f_chunks chunks of data.
template <int kElemBytes>
__global__ void unpack_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                              int64_t out_rows, int k, int f_chunks) {
  constexpr int kRowChunks = 128 * kElemBytes / kChunkBytes;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= out_rows * kRowChunks) return;
  const int64_t r = i / kRowChunks;
  const int c = (int)(i - r * kRowChunks);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (c < f_chunks) {
    const int64_t p = r / k;  // packed row
    const int j = (int)(r - p * k);  // segment within it
    v = in[p * kRowChunks + (int64_t)j * f_chunks + c];
  }
  out[i] = v;
}

template <int kElemBytes>
__global__ void pack_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                            int64_t out_rows, int k, int f_chunks, int in_row_chunks) {
  constexpr int kRowChunks = 128 * kElemBytes / kChunkBytes;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= out_rows * kRowChunks) return;
  const int64_t p = i / kRowChunks;
  const int c = (int)(i - p * kRowChunks);
  const int j = c / f_chunks;  // segment = source row within the group of k
  const int l = c - j * f_chunks;
  out[i] = in[(p * k + j) * in_row_chunks + l];
}

inline bool valid_width(int f, int elem_bytes) {
  return (f == 8 || f == 16 || f == 32 || f == 64) && (f * elem_bytes) % kChunkBytes == 0;
}

inline unsigned int blocks_for(int64_t chunks) {
  return (unsigned int)((chunks + kThreads - 1) / kThreads);
}

// rows: packed rows A*GP (the unpack input's, the pack output's).
template <int kElemBytes>
int launch_unpack(const void* in, void* out, int64_t rows, int f, void* stream) {
  if (rows < 0 || !valid_width(f, kElemBytes)) return (int)cudaErrorInvalidValue;
  const int k = 128 / f;
  const int64_t out_rows = rows * k;
  const int64_t chunks = out_rows * (128 * kElemBytes / kChunkBytes);
  if (chunks == 0) return (int)cudaSuccess;
  if ((chunks + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  unpack_kernel<kElemBytes><<<blocks_for(chunks), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, out_rows, k, f * kElemBytes / kChunkBytes);
  return (int)cudaGetLastError();
}

template <int kElemBytes>
int launch_pack(const void* in, void* out, int64_t rows, int f, int in_lanes, void* stream) {
  if (rows < 0 || !valid_width(f, kElemBytes) || (in_lanes != f && in_lanes != 128)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t chunks = rows * (128 * kElemBytes / kChunkBytes);
  if (chunks == 0) return (int)cudaSuccess;
  if ((chunks + kThreads - 1) / kThreads > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pack_kernel<kElemBytes><<<blocks_for(chunks), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (uint4*)out, rows, 128 / f, f * kElemBytes / kChunkBytes,
      in_lanes * kElemBytes / kChunkBytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int retile_unpack_f32(const void* in, void* out, long long rows, int f, void* stream) {
  return launch_unpack<4>(in, out, rows, f, stream);
}

int retile_unpack_bf16(const void* in, void* out, long long rows, int f, void* stream) {
  return launch_unpack<2>(in, out, rows, f, stream);
}

int retile_pack_f32(const void* in, void* out, long long rows, int f, int in_lanes,
                    void* stream) {
  return launch_pack<4>(in, out, rows, f, in_lanes, stream);
}

int retile_pack_bf16(const void* in, void* out, long long rows, int f, int in_lanes,
                     void* stream) {
  return launch_pack<2>(in, out, rows, f, in_lanes, stream);
}

}  // extern "C"
