// The Mamba-1 selective scan, forward and backward, for sm_90a.
//
// Replaces no TPU kernel: the reference computes the scan in plain jnp
// (repro/models/ssm.py::mamba1_block), as the port did before this kernel
// (kernels/ref.py::selective_scan_ref, still the CPU and DTensor path).
// Added because that composition set falcon-mamba-7b's training pace on the
// card: it materialises a = exp(delta A), b = delta u B, the states h and,
// in its backward, h_{t-1} and da, each (B, S, d_inner, N) fp32 -- 1.07 GB a
// tensor at (1, 2048, 8192, 16) -- and its doubling scan reads and writes
// them log2(chunk) times.
//
// For each batch row, channel d and state n, from h_{-1} = h0 (zeros when
// absent):
//
//     h_t = exp(delta_t A) h_{t-1} + delta_t u_t B_t,
//     y_t = sum_n h_t C_t + D u_t.
//
// What bounds it: its inputs and outputs are (B, S, di) and (B, S, N)
// tensors, about 200 MB a layer's forward at that shape (60 us at 3.35
// TB/s), against S di N expf (the SFU) and a few fp32 operations per state
// and position.  Each thread keeps 4 of a channel's N = 16 states in
// registers and walks time in order: 4 lanes make a channel (their parts of
// y meet by two shuffles), 8 channels a warp, 32 a block, so a layer at that
// shape runs 256 blocks per batch row.  delta, u, B and C (and dy) stream
// through shared memory in tiles of 16 positions, the next tile's loads in
// flight while the current one is computed; nothing of size (B, S, di, N)
// reaches device memory.
//
// The forward saves the state at the start of every chunk of 256 positions,
// (B, di, ceil(S / 256), N): 4 MB a layer at that shape.  The backward walks
// the chunks from the last.  It runs the chunk forward from its saved state,
// keeping the state every 16 positions in shared memory; then, tile by tile
// from the last, it recomputes the tile's states into registers and runs the
// reverse recurrence
//
//     g_t = dy_t C_t + a_{t+1} g_{t+1}      (g_{S-1} = dy C + dh_last)
//
// forming ddelta, du, dA, dD and dh0 = a_0 g_0 in registers, and the sums
// over channels dB_t = sum_d g delta u and dC_t = sum_d dy h_t: over a warp's
// 8 channels by a reduce-scatter of shuffles, over the block's 4 warps in
// shared memory, one partial per block written out.  A second pass adds the
// partials, and dA and dD over the batch, in a fixed order: no atomics, so
// two runs give the same bits.
//
// Arithmetic: fp32 throughout, expf (not __expf), and the state update
// written once (`advance`, explicitly rounded) so that the backward's
// recomputed states equal the forward's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_args.h"

namespace {

constexpr int kN = 16;                                 // states a channel
constexpr int kPer = 4;                                // states a thread
constexpr int kWarpChannels = 32 / (kN / kPer);        // channels a warp: 8
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChannels = kWarpChannels * kWarps;      // channels a block: 32
constexpr int kTile = 16;                              // positions a tile
constexpr int kChunk = 256;                            // positions a chunk
constexpr int kTilesPerChunk = kChunk / kTile;
constexpr unsigned kFull = 0xffffffffu;

// A tile's channel operands: 4 a thread; its B and C rows: 2 a thread.
constexpr int kChanLoads = kTile * kChannels / kThreads;
constexpr int kStateLoads = kTile * kN / kThreads;
static_assert(kChanLoads * kThreads == kTile * kChannels, "tile split");
static_assert(kStateLoads * kThreads == kTile * kN, "tile split");
static_assert(kThreads / kChannels * kChanLoads == kTile, "tile rows");

struct __align__(16) Tile {
  float delta[kTile][kChannels];
  float u[kTile][kChannels];
  float dy[kTile][kChannels];   // the backward's only
  float B[kTile][kN];
  float C[kTile][kN];
};

// Where a thread sits: q picks its 4 states, c its channel in the warp.
struct Place {
  int warp, q, c, ch;           // ch: channel in the block
  int64_t b, d;
  bool live;                    // d < di; the others compute on zeros
};

__device__ __forceinline__ Place place(int64_t di) {
  Place p;
  const int lane = threadIdx.x & 31;
  p.warp = threadIdx.x >> 5;
  p.q = lane >> 3;
  p.c = lane & 7;
  p.ch = p.warp * kWarpChannels + p.c;
  p.b = blockIdx.y;
  p.d = (int64_t)blockIdx.x * kChannels + p.ch;
  p.live = p.d < di;
  return p;
}

__device__ __forceinline__ float decay(float dt, float a) {
  return expf(__fmul_rn(dt, a));
}

// h_t from h_{t-1}, the decay a_t, delta_t u_t and B_t[n].
__device__ __forceinline__ float advance(float h, float a, float dtu,
                                         float bn) {
  return __fmaf_rn(a, h, __fmul_rn(dtu, bn));
}

// One tile's operands in registers, fetched from device memory while the
// previous tile is computed, then put into shared memory.  Positions past S
// and channels past di read as zeros: a zero delta makes the step the
// identity (a = 1, nothing added), so padded positions change no state.
template <bool kGrad>
struct Fetch {
  float delta[kChanLoads], u[kChanLoads], dy[kChanLoads];
  float B[kStateLoads], C[kStateLoads];

  __device__ __forceinline__ void get(
      const float* __restrict__ delta_g, const float* __restrict__ u_g,
      const float* __restrict__ dy_g, const float* __restrict__ B_g,
      const float* __restrict__ C_g, int64_t b, int64_t t0, int64_t S,
      int64_t di, int64_t d0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t col = d0 + lane;
#pragma unroll
    for (int i = 0; i < kChanLoads; ++i) {
      const int64_t t = t0 + warp + i * kWarps;
      const bool ok = t < S && col < di;
      const int64_t at = (b * S + t) * di + col;
      delta[i] = ok ? delta_g[at] : 0.f;
      u[i] = ok ? u_g[at] : 0.f;
      if (kGrad) dy[i] = ok ? dy_g[at] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kStateLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int64_t t = t0 + e / kN;
      const int64_t at = (b * S + t) * kN + e % kN;
      B[i] = t < S ? B_g[at] : 0.f;
      C[i] = t < S ? C_g[at] : 0.f;
    }
  }

  __device__ __forceinline__ void put(Tile& s) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < kChanLoads; ++i) {
      const int r = warp + i * kWarps;
      s.delta[r][lane] = delta[i];
      s.u[r][lane] = u[i];
      if (kGrad) s.dy[r][lane] = dy[i];
    }
#pragma unroll
    for (int i = 0; i < kStateLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      s.B[e / kN][e % kN] = B[i];
      s.C[e / kN][e % kN] = C[i];
    }
  }
};

__device__ __forceinline__ void row4(const float (&row)[kN], int q,
                                     float (&out)[kPer]) {
  const float4 v = *reinterpret_cast<const float4*>(&row[q * kPer]);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// The thread's 4 states of row (b, d) of a (..., N) state tensor.
__device__ __forceinline__ void load_states(const float* __restrict__ src,
                                            const Place& p,
                                            float (&h)[kPer]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    h[j] = (p.live && src) ? src[p.q * kPer + j] : 0.f;
}

__device__ __forceinline__ void store_states(float* __restrict__ dst,
                                             const Place& p,
                                             const float (&h)[kPer]) {
  if (!p.live || !dst) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) dst[p.q * kPer + j] = h[j];
}

// Sum of x over the 4 lanes of a channel (lane bits 3 and 4); every one of
// them gets the same bits.
__device__ __forceinline__ float channel_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 8);
  return x + __shfl_xor_sync(kFull, x, 16);
}

// v[0..7] summed over the warp's 8 channels (the lanes that differ in bits
// 0 to 2); the lane of channel c returns the sum of v[c].  Seven shuffles in
// place of 8 x 3.
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int c) {
  float w[4], x[2];
  const bool hi2 = c & 4, hi1 = c & 2, hi0 = c & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi2 ? v[i] : v[i + 4];
    w[i] = (hi2 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFull, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi1 ? w[i] : w[i + 2];
    x[i] = (hi1 ? w[i + 2] : w[i]) + __shfl_xor_sync(kFull, send, 2);
  }
  const float send = hi0 ? x[0] : x[1];
  return (hi0 ? x[1] : x[0]) + __shfl_xor_sync(kFull, send, 1);
}

// Grid (ceil(di / 32), B); 128 threads.
__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, float* __restrict__ hs,
                int64_t S, int64_t di, int64_t n_chunks) {
  __shared__ Tile tile;
  const Place p = place(di);
  const int64_t d0 = (int64_t)blockIdx.x * kChannels;
  const int64_t row = p.b * di + p.d;       // (b, d) of the state tensors
  float a_coef[kPer], h[kPer];
  load_states(p.live ? A + p.d * kN : nullptr, p, a_coef);
  load_states(h0 ? h0 + row * kN : nullptr, p, h);
  const float skip = p.live ? Dv[p.d] : 0.f;

  const int64_t n_tiles = (S + kTile - 1) / kTile;
  Fetch<false> f;
  f.get(delta, u, nullptr, Bm, Cm, p.b, 0, S, di, d0);
  for (int64_t i = 0; i < n_tiles; ++i) {
    const int64_t t0 = i * kTile;
    if (t0 % kChunk == 0)
      store_states(hs + (row * n_chunks + t0 / kChunk) * kN, p, h);
    __syncthreads();                        // the last tile is read
    f.put(tile);
    __syncthreads();
    if (i + 1 < n_tiles)
      f.get(delta, u, nullptr, Bm, Cm, p.b, t0 + kTile, S, di, d0);
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const float dt = tile.delta[k][p.ch], x = tile.u[k][p.ch];
      const float dtu = __fmul_rn(dt, x);
      float bn[kPer], cn[kPer];
      row4(tile.B[k], p.q, bn);
      row4(tile.C[k], p.q, cn);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        h[j] = advance(h[j], decay(dt, a_coef[j]), dtu, bn[j]);
        acc = __fmaf_rn(h[j], cn[j], acc);
      }
      acc = channel_sum(acc);
      const int64_t t = t0 + k;
      if (p.q == 0 && p.live && t < S)
        y[(p.b * S + t) * di + p.d] = __fmaf_rn(skip, x, acc);
    }
  }
  store_states(h_last + row * kN, p, h);
}

// Grid (ceil(di / 32), B); 128 threads.  Writes du, ddelta, dh0 (when
// given), and the partials: dA_part (B, di, N) and dD_part (B, di), summed
// over the batch afterwards, and dBC_part (blocks, B, S, 2N), the block's
// sums over its channels of dB (n < N) and dC (n >= N).
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const float* __restrict__ u, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ Dv,
                const float* __restrict__ hs, const float* __restrict__ dy,
                const float* __restrict__ dh_last, float* __restrict__ du,
                float* __restrict__ ddelta, float* __restrict__ dh0,
                float* __restrict__ dA_part, float* __restrict__ dD_part,
                float* __restrict__ dBC_part, int64_t S, int64_t di,
                int64_t n_chunks) {
  __shared__ Tile tile;
  // the states at the starts of a chunk's tiles 1.. (tile 0's is in hs)
  __shared__ float4 ckpt[kTilesPerChunk - 1][kThreads];
  __shared__ float red[kWarps][kTile][2 * kN];
  const Place p = place(di);
  const int64_t d0 = (int64_t)blockIdx.x * kChannels;
  const int64_t row = p.b * di + p.d;
  float a_coef[kPer], carry[kPer], dA[kPer] = {0.f, 0.f, 0.f, 0.f};
  load_states(p.live ? A + p.d * kN : nullptr, p, a_coef);
  load_states(dh_last ? dh_last + row * kN : nullptr, p, carry);
  const float skip = p.live ? Dv[p.d] : 0.f;
  float dD = 0.f;
  Fetch<false> fwd;                         // the chunk forward's tiles
  Fetch<true> f;

  for (int64_t c = n_chunks - 1; c >= 0; --c) {
    const int64_t c0 = c * kChunk;
    const int64_t left = (S - c0 + kTile - 1) / kTile;
    const int n_sub = left < kTilesPerChunk ? (int)left : kTilesPerChunk;
    float start[kPer];
    load_states(hs + (row * n_chunks + c) * kN, p, start);

    // the chunk forward, keeping the state at each tile's start
    float h[kPer] = {start[0], start[1], start[2], start[3]};
    if (n_sub > 1) fwd.get(delta, u, nullptr, Bm, Cm, p.b, c0, S, di, d0);
    for (int s = 0; s + 1 < n_sub; ++s) {
      __syncthreads();
      fwd.put(tile);
      __syncthreads();
      if (s + 2 < n_sub)
        fwd.get(delta, u, nullptr, Bm, Cm, p.b, c0 + (s + 1) * kTile, S,
                di, d0);
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const float dt = tile.delta[k][p.ch];
        const float dtu = __fmul_rn(dt, tile.u[k][p.ch]);
        float bn[kPer];
        row4(tile.B[k], p.q, bn);
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          h[j] = advance(h[j], decay(dt, a_coef[j]), dtu, bn[j]);
      }
      ckpt[s][threadIdx.x] = make_float4(h[0], h[1], h[2], h[3]);
    }

    // the tiles from the last: their states again, then the reverse
    int64_t t0 = c0 + (int64_t)(n_sub - 1) * kTile;
    f.get(delta, u, dy, Bm, Cm, p.b, t0, S, di, d0);
    for (int s = n_sub - 1; s >= 0; --s, t0 -= kTile) {
      __syncthreads();
      f.put(tile);
      __syncthreads();
      if (s > 0) f.get(delta, u, dy, Bm, Cm, p.b, t0 - kTile, S, di, d0);
      float hist[kTile][kPer];              // h_{t-1} at each position
      if (s == 0) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) h[j] = start[j];
      } else {
        const float4 v = ckpt[s - 1][threadIdx.x];
        h[0] = v.x;
        h[1] = v.y;
        h[2] = v.z;
        h[3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const float dt = tile.delta[k][p.ch];
        const float dtu = __fmul_rn(dt, tile.u[k][p.ch]);
        float bn[kPer];
        row4(tile.B[k], p.q, bn);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          hist[k][j] = h[j];
          h[j] = advance(h[j], decay(dt, a_coef[j]), dtu, bn[j]);
        }
      }
#pragma unroll
      for (int k = kTile - 1; k >= 0; --k) {
        const float dt = tile.delta[k][p.ch], x = tile.u[k][p.ch];
        const float gy = tile.dy[k][p.ch];
        const float dtu = __fmul_rn(dt, x);
        float bn[kPer], cn[kPer], v[2 * kPer];
        row4(tile.B[k], p.q, bn);
        row4(tile.C[k], p.q, cn);
        float dd = 0.f, dx = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float a = decay(dt, a_coef[j]);
          const float hp = hist[k][j];
          const float g = __fmaf_rn(gy, cn[j], carry[j]);
          const float ga = g * a;
          carry[j] = ga;
          // d h_t / d delta_t = A a_t h_{t-1} + u_t B_t
          dd = fmaf(g, fmaf(a_coef[j] * a, hp, x * bn[j]), dd);
          dx = fmaf(g * dt, bn[j], dx);
          dA[j] = fmaf(ga * hp, dt, dA[j]);
          v[j] = g * dtu;
          v[kPer + j] = gy * advance(hp, a, dtu, bn[j]);
        }
        dd = channel_sum(dd);
        dx = channel_sum(dx);
        dD = fmaf(gy, x, dD);
        const int64_t t = t0 + k;
        if (p.q == 0 && p.live && t < S) {
          const int64_t at = (p.b * S + t) * di + p.d;
          ddelta[at] = dd;
          du[at] = fmaf(skip, gy, dx);
        }
        const int n = p.q * kPer + (p.c & 3);
        red[p.warp][k][(p.c < kPer ? 0 : kN) + n] = reduce_scatter8(v, p.c);
      }
      __syncthreads();
      // the block's sums of dB and dC over its channels, one per position
      float* part = dBC_part + ((int64_t)blockIdx.x * gridDim.y + p.b) * S
                    * (2 * kN);
      for (int e = threadIdx.x; e < kTile * 2 * kN; e += kThreads) {
        const int k = e / (2 * kN), i = e % (2 * kN);
        if (t0 + k >= S) continue;
        float sum = red[0][k][i];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) sum += red[w][k][i];
        part[(t0 + k) * (2 * kN) + i] = sum;
      }
    }
  }
  store_states(dh0 ? dh0 + row * kN : nullptr, p, carry);
  store_states(dA_part + row * kN, p, dA);
  if (p.live && p.q == 0) dD_part[row] = dD;
}

// out[i] = part[0][i] + part[1][i] + ... + part[K-1][i], in that order.
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int64_t K,
                                 int64_t M) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float s = part[i];
  for (int64_t k = 1; k < K; ++k) s += part[k * M + i];
  out[i] = s;
}

int sum_parts(const float* part, float* out, int64_t K, int64_t M,
              cudaStream_t stream) {
  const int threads = 256;
  sum_parts_kernel<<<(unsigned)((M + threads - 1) / threads), threads, 0,
                     stream>>>(part, out, K, M);
  return (int)cudaGetLastError();
}

// Checks the sizes the wrapper allocated by.
bool bad_shape(long long batch, long long S, long long di,
               long long n_chunks) {
  return batch <= 0 || batch > 65535 || S <= 0 || di <= 0 ||
         n_chunks != (S + kChunk - 1) / kChunk ||
         (di + kChannels - 1) / kChannels > 0x7fffffffLL;
}

}  // namespace

// The launchers' argument blocks (launch_args.h).
#define SCAN_FWD_ARGS(X)                                                \
  X(const float*, u, p) X(const float*, delta, p) X(const float*, A, p) \
  X(const float*, Bm, p) X(const float*, Cm, p) X(const float*, D, p)   \
  X(const float*, h0, p) X(float*, y, p) X(float*, h_last, p)           \
  X(float*, hs, p) X(long long, batch, i) X(long long, S, i)            \
  X(long long, di, i) X(long long, n_chunks, i)
LAUNCH_ARGS(ScanFwdArgs, SCAN_FWD_ARGS, selective_scan_fwd_launch_args)

#define SCAN_BWD_ARGS(X)                                                \
  X(const float*, u, p) X(const float*, delta, p) X(const float*, A, p) \
  X(const float*, Bm, p) X(const float*, Cm, p) X(const float*, D, p)   \
  X(const float*, hs, p) X(const float*, dy, p)                         \
  X(const float*, dh_last, p) X(float*, du, p) X(float*, ddelta, p)     \
  X(float*, dh0, p) X(float*, dA_part, p) X(float*, dD_part, p)         \
  X(float*, dBC_part, p) X(float*, dA, p) X(float*, dD, p)              \
  X(float*, dBC, p) X(long long, batch, i) X(long long, S, i)           \
  X(long long, di, i) X(long long, n_chunks, i) X(long long, n_parts, i)
LAUNCH_ARGS(ScanBwdArgs, SCAN_BWD_ARGS, selective_scan_bwd_launch_args)

extern "C" {

// u, delta, y (B, S, di); A (di, 16); Bm, Cm (B, S, 16); D (di,); h0 (B,
// di, 16) or null (zeros); h_last (B, di, 16); hs (B, di, n_chunks, 16), the
// state at the start of each chunk of 256 positions.  All fp32 and
// contiguous.  Returns a cudaError_t.
int selective_scan_fwd_launch(const ScanFwdArgs* a, void* stream) {
  if (bad_shape(a->batch, a->S, a->di, a->n_chunks))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((a->di + kChannels - 1) / kChannels),
                  (unsigned)a->batch);
  scan_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a->u, a->delta, a->A, a->Bm, a->Cm, a->D, a->h0, a->y, a->h_last,
      a->hs, a->S, a->di, a->n_chunks);
  return (int)cudaGetLastError();
}

// The forward's operands and hs; dy (B, S, di); dh_last (B, di, 16) or null
// (zeros).  Writes du, ddelta (B, S, di), dh0 (B, di, 16) unless null, dA
// (di, 16), dD (di,) and dBC (B, S, 32): dB in [..., :16], dC in [..., 16:].
// dA_part (B, di, 16), dD_part (B, di) and dBC_part (n_parts, B, S, 32),
// n_parts = ceil(di / 32), are scratch.  Returns a cudaError_t.
int selective_scan_bwd_launch(const ScanBwdArgs* a, void* stream) {
  if (bad_shape(a->batch, a->S, a->di, a->n_chunks) ||
      a->n_parts != (a->di + kChannels - 1) / kChannels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)a->n_parts, (unsigned)a->batch);
  scan_bwd_kernel<<<grid, kThreads, 0, s>>>(
      a->u, a->delta, a->A, a->Bm, a->Cm, a->D, a->hs, a->dy, a->dh_last,
      a->du, a->ddelta, a->dh0, a->dA_part, a->dD_part, a->dBC_part, a->S,
      a->di, a->n_chunks);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if ((err = sum_parts(a->dBC_part, a->dBC, a->n_parts,
                       a->batch * a->S * 2 * kN, s)))
    return err;
  if ((err = sum_parts(a->dA_part, a->dA, a->batch, a->di * kN, s)))
    return err;
  return sum_parts(a->dD_part, a->dD, a->batch, a->di, s);
}

}  // extern "C"
