// Fused sparse AdaGrad row update, for sm_90a.
//
// Replaces repro/kernels/adagrad_rows.py::_make_kernel.  For every id in
// [0, V) among ids (n,), in place:
//
//     accum[id, :] += g * g
//     table[id, :] -= lr * g / (sqrt(accum[id, :]) + eps)
//
// with g = grads[i, :], all arithmetic in fp32 and the table row cast back
// to its own type (fp32 or bf16; the accumulator is always fp32).  Ids
// outside [0, V) are skipped: nothing is read or written for them.  The
// caller pads its segment slots with V, so a pad never touches a live row.
// (The TPU kernel instead aliased pads to row 0 with a zero gradient and
// relied on its sequential grid to run them before row 0's real update;
// blocks on a GPU run in no order, so that trick would let a pad write the
// stale row 0 over the real update.)  Real ids are unique, so no two
// warps touch one element.
//
// Every operation is the correctly rounded intrinsic, in the plain
// version's order (kernels/ref.py::adagrad_row_update_ref): without them
// nvcc would contract accum + g * g into one FMA and the last bit would
// differ from PyTorch's separate multiply and add.
//
// Bound by memory traffic: per element a table, accumulator and gradient
// read and a table and accumulator write (5 * 4 bytes in fp32), against a
// handful of flops.  As in row_kernels.cu, one warp owns one (row, column
// chunk) pair and each lane keeps kUnroll independent vectors in flight;
// rows are moved as 4-element vectors (16-byte fp32 words, 8-byte bf16
// words) where the width and every base pointer allow, one element
// otherwise.  Row offsets are 64-bit: the nemotron-4-15b table is
// 256000 x 6144.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void update(float g, float& a, float& p, float lr,
                                       float eps) {
  a = __fadd_rn(a, __fmul_rn(g, g));
  const float step = __fdiv_rn(__fmul_rn(lr, g),
                               __fadd_rn(__fsqrt_rn(a), eps));
  p = __fsub_rn(p, step);
}

// One element at a time: any width, any alignment.
template <typename T>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
adagrad_scalar_kernel(T* __restrict__ table, float* __restrict__ accum,
                      const float* __restrict__ grads,
                      const int32_t* __restrict__ ids, int64_t n, int64_t V,
                      int64_t D, float lr, float eps) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n) return;
  const int64_t id = ids[row];
  if (id < 0 || id >= V) return;
  const int64_t c0 = (int64_t)blockIdx.y * (kLanes * kUnroll) + threadIdx.x;
  T* t = table + id * D;
  float* a = accum + id * D;
  const float* g = grads + row * D;
  float gv[kUnroll], av[kUnroll], pv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t c = c0 + u * kLanes;
    if (c < D) {
      gv[u] = g[c];
      av[u] = a[c];
      pv[u] = to_f32(t[c]);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t c = c0 + u * kLanes;
    if (c < D) {
      update(gv[u], av[u], pv[u], lr, eps);
      a[c] = av[u];
      from_f32(pv[u], t + c);
    }
  }
}

// Four table elements as one word.
template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using W = float4;
  __device__ static void get(const W& w, float* f) {
    f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
  }
  __device__ static W put(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using W = uint2;   // 4 x bf16
  __device__ static void get(const W& w, float* f) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = __bfloat162float(h[k]);
  }
  __device__ static W put(const float* f) {
    W w;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __float2bfloat16_rn(f[k]);
    return w;
  }
};

// D % 4 == 0 and 16-byte aligned accumulator and gradient rows, table rows
// aligned to their 4-element word.  Counts in 4-element vectors.
template <typename T>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
adagrad_vec4_kernel(T* __restrict__ table, float* __restrict__ accum,
                    const float* __restrict__ grads,
                    const int32_t* __restrict__ ids, int64_t n, int64_t V,
                    int64_t vecs, float lr, float eps) {
  using TW = typename Vec4<T>::W;
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.y;
  if (row >= n) return;
  const int64_t id = ids[row];
  if (id < 0 || id >= V) return;
  const int64_t c0 = (int64_t)blockIdx.y * (kLanes * kUnroll) + threadIdx.x;
  TW* t = reinterpret_cast<TW*>(table) + id * vecs;
  float4* a = reinterpret_cast<float4*>(accum) + id * vecs;
  const float4* g = reinterpret_cast<const float4*>(grads) + row * vecs;
  float4 gv[kUnroll], av[kUnroll];
  TW tv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t c = c0 + u * kLanes;
    if (c < vecs) {
      gv[u] = g[c];
      av[u] = a[c];
      tv[u] = t[c];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t c = c0 + u * kLanes;
    if (c < vecs) {
      float gf[4] = {gv[u].x, gv[u].y, gv[u].z, gv[u].w};
      float af[4] = {av[u].x, av[u].y, av[u].z, av[u].w};
      float pf[4];
      Vec4<T>::get(tv[u], pf);
#pragma unroll
      for (int k = 0; k < 4; ++k) update(gf[k], af[k], pf[k], lr, eps);
      a[c] = make_float4(af[0], af[1], af[2], af[3]);
      t[c] = Vec4<T>::put(pf);
    }
  }
}

template <typename T>
int launch(void* table, float* accum, const float* grads, const int32_t* ids,
           int64_t n, int64_t V, int64_t D, float lr, float eps,
           cudaStream_t stream) {
  const dim3 block(kLanes, kRowsPerBlock);
  const int64_t rows = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const int64_t per_warp = kLanes * kUnroll;
  const uintptr_t aligned16 = (uintptr_t)accum | (uintptr_t)grads;
  const bool vec4 = D % 4 == 0 && aligned16 % 16 == 0 &&
                    (uintptr_t)table % (4 * sizeof(T)) == 0;
  const int64_t units = vec4 ? D / 4 : D;
  const int64_t chunks = (units + per_warp - 1) / per_warp;
  if (rows > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, (unsigned)chunks);
  if (vec4)
    adagrad_vec4_kernel<T><<<grid, block, 0, stream>>>(
        (T*)table, accum, grads, ids, n, V, units, lr, eps);
  else
    adagrad_scalar_kernel<T><<<grid, block, 0, stream>>>(
        (T*)table, accum, grads, ids, n, V, D, lr, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table (V, D) fp32 (table_bf16 == 0) or bf16 (table_bf16 == 1), accum
// (V, D) fp32, both updated in place; grads (n, D) fp32; ids (n,) int32.
// Returns a cudaError_t.
int adagrad_rows_launch(void* table, void* accum, const void* grads,
                        const void* ids, long long n, long long V,
                        long long D, float lr, float eps, int table_bf16,
                        void* stream) {
  if (n == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  float* a = (float*)accum;
  const float* g = (const float*)grads;
  const int32_t* id = (const int32_t*)ids;
  if (table_bf16)
    return launch<__nv_bfloat16>(table, a, g, id, n, V, D, lr, eps, s);
  return launch<float>(table, a, g, id, n, V, D, lr, eps, s);
}

}  // extern "C"
