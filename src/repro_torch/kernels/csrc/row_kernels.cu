// Row-copy kernels of the intent-managed lookup, for sm_90a.
//
// embed_gather  replaces repro/kernels/embed_gather.py::_gather_kernel:
//               out[i, :] = table[ids[i], :]; an id outside [0, V) writes a
//               zero row and reads nothing (the runtime pads id buckets
//               with V).
// pm_combine    replaces repro/kernels/pm_forward.py::_combine_kernel:
//               out[t, :] = hit[t] ? cache[cslot[t], :] : buf[bslot[t], :];
//               only the winning row is read.
// scatter_rows  replaces repro/kernels/scatter_rows.py::_scatter_kernel:
//               base[ids[i], :] = rows[i, :] in place (the lookup's
//               backward writes segment-summed gradient rows into a zero
//               (V + 1, D) buffer); an id outside [0, R) writes nothing.
//               Ids are unique apart from pads aimed at the trash row V,
//               whose rows are all zero: those writes race, but every one
//               carries the same bits, so the result is defined.
//
// All three move bytes and do no arithmetic on them: rows are copied as raw
// words, so bf16 and fp32 come out bit for bit.  They are bound by memory
// traffic (each output row is one row read plus one row written), so the
// design is about keeping many independent 16-byte loads in flight: a
// warp owns one (row, column chunk) pair, each lane issues UNROLL loads
// before its stores, and the grid's second axis splits long rows (a 6144
// wide fp32 row is 24 KiB) into chunks so enough warps exist to fill the
// card.  Row offsets are computed in 64 bits: a 256000 x 6144 fp32 table
// is 6.29 GB.
//
// The launchers take raw pointers and a cudaStream_t, so the library needs
// no PyTorch headers; each returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 8;   // warps per block, one row each
constexpr int kUnroll = 4;         // words in flight per lane
constexpr int64_t kChunk = kLanes * kUnroll;  // words per warp per row

template <typename W>
__device__ __forceinline__ void copy_row(W* __restrict__ dst,
                                         const W* __restrict__ src,
                                         int64_t c0, int64_t words) {
  W v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t c = c0 + u * kLanes;
    if (c < words) v[u] = src[c];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t c = c0 + u * kLanes;
    if (c < words) dst[c] = v[u];
  }
}

template <typename W>
__device__ __forceinline__ void zero_row(W* __restrict__ dst, int64_t c0,
                                         int64_t words) {
  const W z{};
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t c = c0 + u * kLanes;
    if (c < words) dst[c] = z;
  }
}

template <typename W>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
gather_kernel(const W* __restrict__ table, const int32_t* __restrict__ ids,
              W* __restrict__ out, int64_t n, int64_t V, int64_t words) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n) return;
  const int64_t c0 = (int64_t)blockIdx.y * kChunk + threadIdx.x;
  W* dst = out + row * words;
  const int64_t id = ids[row];
  if (id < 0 || id >= V) {
    zero_row(dst, c0, words);
    return;
  }
  copy_row(dst, table + id * words, c0, words);
}

template <typename W>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
scatter_kernel(W* __restrict__ base, const int32_t* __restrict__ ids,
               const W* __restrict__ rows, int64_t n, int64_t R,
               int64_t words) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n) return;
  const int64_t id = ids[row];
  if (id < 0 || id >= R) return;
  const int64_t c0 = (int64_t)blockIdx.y * kChunk + threadIdx.x;
  copy_row(base + id * words, rows + row * words, c0, words);
}

template <typename W>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
combine_kernel(const int32_t* __restrict__ hit,
               const int32_t* __restrict__ cslot,
               const int32_t* __restrict__ bslot,
               const W* __restrict__ cache, const W* __restrict__ buf,
               W* __restrict__ out, int64_t T, int64_t words) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= T) return;
  const int64_t c0 = (int64_t)blockIdx.y * kChunk + threadIdx.x;
  const W* src = hit[row] ? cache + (int64_t)cslot[row] * words
                          : buf + (int64_t)bslot[row] * words;
  copy_row(out + row * words, src, c0, words);
}

// The widest word (16, 8, 4 or 2 bytes) that divides the row and every
// base pointer, so each row starts aligned to it.
int word_bytes(int64_t row_bytes, uintptr_t ptrs) {
  for (int w = 16; w > 2; w /= 2)
    if (row_bytes % w == 0 && ptrs % w == 0) return w;
  return 2;
}

dim3 grid_for(int64_t rows, int64_t words) {
  return dim3((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock),
              (unsigned)((words + kChunk - 1) / kChunk));
}

const dim3 kBlock(kLanes, kRowsPerBlock);

template <typename W>
void launch_gather(const void* table, const int32_t* ids, void* out,
                   int64_t n, int64_t V, int64_t row_bytes,
                   cudaStream_t stream) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  gather_kernel<W><<<grid_for(n, words), kBlock, 0, stream>>>(
      (const W*)table, ids, (W*)out, n, V, words);
}

template <typename W>
void launch_combine(const int32_t* hit, const int32_t* cslot,
                    const int32_t* bslot, const void* cache, const void* buf,
                    void* out, int64_t T, int64_t row_bytes,
                    cudaStream_t stream) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  combine_kernel<W><<<grid_for(T, words), kBlock, 0, stream>>>(
      hit, cslot, bslot, (const W*)cache, (const W*)buf, (W*)out, T, words);
}

template <typename W>
void launch_scatter(void* base, const int32_t* ids, const void* rows,
                    int64_t n, int64_t R, int64_t row_bytes,
                    cudaStream_t stream) {
  const int64_t words = row_bytes / (int64_t)sizeof(W);
  scatter_kernel<W><<<grid_for(n, words), kBlock, 0, stream>>>(
      (W*)base, ids, (const W*)rows, n, R, words);
}

// Rows wider than 65535 chunks would overflow the grid's second axis.
bool grid_ok(int64_t rows, int64_t row_bytes) {
  return (rows + kRowsPerBlock - 1) / kRowsPerBlock <= 0x7fffffffLL &&
         (row_bytes / 2 + kChunk - 1) / kChunk <= 65535;
}

}  // namespace

extern "C" {

// table (V, D) and out (n, D), rows of row_bytes = D * elt bytes; ids (n,)
// int32.  Returns a cudaError_t.
int embed_gather_launch(const void* table, const void* ids, void* out,
                        long long n, long long V, long long row_bytes,
                        void* stream) {
  if (n == 0 || row_bytes == 0) return (int)cudaSuccess;
  if (row_bytes % 2 != 0 || !grid_ok(n, row_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* id = (const int32_t*)ids;
  switch (word_bytes(row_bytes, (uintptr_t)table | (uintptr_t)out)) {
    case 16: launch_gather<uint4>(table, id, out, n, V, row_bytes, s); break;
    case 8: launch_gather<uint2>(table, id, out, n, V, row_bytes, s); break;
    case 4: launch_gather<uint32_t>(table, id, out, n, V, row_bytes, s); break;
    default: launch_gather<uint16_t>(table, id, out, n, V, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

// hit, cslot, bslot (T,) int32; cache (C, D), buf (M + 1, D) and out
// (T, D), rows of row_bytes bytes.  Returns a cudaError_t.
int pm_combine_launch(const void* hit, const void* cslot, const void* bslot,
                      const void* cache, const void* buf, void* out,
                      long long T, long long row_bytes, void* stream) {
  if (T == 0 || row_bytes == 0) return (int)cudaSuccess;
  if (row_bytes % 2 != 0 || !grid_ok(T, row_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* h = (const int32_t*)hit;
  const int32_t* cs = (const int32_t*)cslot;
  const int32_t* bs = (const int32_t*)bslot;
  switch (word_bytes(row_bytes, (uintptr_t)cache | (uintptr_t)buf |
                                    (uintptr_t)out)) {
    case 16:
      launch_combine<uint4>(h, cs, bs, cache, buf, out, T, row_bytes, s);
      break;
    case 8:
      launch_combine<uint2>(h, cs, bs, cache, buf, out, T, row_bytes, s);
      break;
    case 4:
      launch_combine<uint32_t>(h, cs, bs, cache, buf, out, T, row_bytes, s);
      break;
    default:
      launch_combine<uint16_t>(h, cs, bs, cache, buf, out, T, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

// base (R, D) written in place and rows (n, D), rows of row_bytes bytes;
// ids (n,) int32.  Returns a cudaError_t.
int scatter_rows_launch(void* base, const void* ids, const void* rows,
                        long long n, long long R, long long row_bytes,
                        void* stream) {
  if (n == 0 || row_bytes == 0) return (int)cudaSuccess;
  if (row_bytes % 2 != 0 || !grid_ok(n, row_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* id = (const int32_t*)ids;
  switch (word_bytes(row_bytes, (uintptr_t)base | (uintptr_t)rows)) {
    case 16: launch_scatter<uint4>(base, id, rows, n, R, row_bytes, s); break;
    case 8: launch_scatter<uint2>(base, id, rows, n, R, row_bytes, s); break;
    case 4: launch_scatter<uint32_t>(base, id, rows, n, R, row_bytes, s); break;
    default: launch_scatter<uint16_t>(base, id, rows, n, R, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

const char* row_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
