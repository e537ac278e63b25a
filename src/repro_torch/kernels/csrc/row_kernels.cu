// Row kernels of the intent-managed lookup, for sm_90a.
//
// embed_gather  replaces repro/kernels/embed_gather.py::_gather_kernel:
//               out[i, :] = table[ids[i], :]; an id outside [0, V) writes a
//               zero row and reads nothing (the runtime pads id buckets
//               with V).
// pm_combine    replaces repro/kernels/pm_forward.py::_combine_kernel:
//               out[t, :] = hit[t] ? cache[cslot[t], :] : buf[bslot[t], :];
//               only the winning row is read.
// scatter_rows  replaces repro/kernels/scatter_rows.py::_scatter_kernel:
//               base[ids[i], :] = rows[i, :] in place; an id outside
//               [0, R) writes nothing.  Ids are unique apart from pads
//               whose rows carry equal bits, so racing writes are defined.
// segment_scatter_rows  the same scatter fused with the managed lookup's
//               backward pre-sum: for each run of equal ids in the step's
//               sorted token ids, base[id, :] = sum of grads[order[k], :]
//               over the run, in sorted order, in fp32 (__fadd_rn from
//               0.0f), rounded once to base's type.  Ids outside [0, R)
//               write nothing.  One launch replaces the index_select,
//               zeros, index_add_, full, index-put and cast of the
//               segment-sum composition plus the scatter; the sum is the
//               same in every run (no atomics).
//
// All of them are bound by memory traffic.  The gather, combine and scatter
// copy raw words, so bf16 and fp32 come out bit for bit.
//
// The gather (rows of 0.5 to 24 KiB at the serving path's shapes) uses
// Hopper's Tensor Memory Accelerator when the row's byte width and both
// base pointers are multiples of 16 and it writes at most kTmaMaxBytes:
// persistent one-warp blocks, three per
// SM, each with a ring of kStages shared-memory stages.  A work item is
// one row chunk (rows wider than kStageBytes are split into equal 16-byte
// multiples) or up to 32 whole rows; one lane per row issues
// cp.async.bulk global->shared on the stage's mbarrier, lane 0 waits on it
// and issues one cp.async.bulk shared->global of the item (the item's
// output rows are contiguous), then refills the stage of the previous item
// once that item's store has read it (bulk_group wait_group.read).  No data
// passes through registers, kStages - 1 loads stay in flight per block,
// and the table reads carry an L2 evict-first hint.  Larger gathers and
// rows of any other width or alignment take the word path: one warp per
// (row, 128-word chunk), the widest word (16, 8, 4 or 2 bytes) that
// divides the row and both pointers, kUnroll words in flight per lane.
// The choice depends on size and alignment only (embed_gather_path).
// pm_combine and scatter_rows use the word path.
//
// Bound on the H100 (3.35 TB/s): a gather of 4096 rows of 24 KiB moves
// 201 MB, 0.060 ms.  No design timed reached it: the TMA ring, the word
// path and index_select all took 0.074 to 0.079 ms there (about 2.6 TB/s
// for random row reads with sequential writes).  The two paths timed in
// turns on the same rows in one call (PERF.md): the ring was about 4 %
// faster at the serving runs' 1024-row buckets (25 MB written), the most
// frequent large gather, and the word path 2 to 4 % faster at 2048 and
// 4096 rows (50 and 100 MB); hence kTmaMaxBytes between the two.
//
// The segmented scatter moves about (T + runs) x D x 4 bytes: 2.4 MB at
// smollm-135m's step (512 tokens of 576), under a microsecond at the HBM
// rate, so shared memory, TMA and tensor cores buy nothing there.  What it
// saves is launches and host work: one warp per (sorted position, column
// chunk) exits unless its position starts a run, so no segment-start pass
// and no host round trip is needed; the run's token rows are loaded in
// batches so their latencies overlap; 16-byte stores where the width and
// alignment allow.
//
// Row offsets are computed in 64 bits: a 256000 x 6144 fp32 table is
// 6.29 GB.  The launchers take a block of raw pointers and counts
// (launch_args.h) and a cudaStream_t, so the library needs no PyTorch
// headers; each returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_args.h"

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 8;   // warps per block, one row each
constexpr int kUnroll = 4;         // words in flight per lane
constexpr int64_t kChunk = kLanes * kUnroll;  // words per warp per row

// ---------------------------------------------------------------- word path

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

// ----------------------------------------------------------------- TMA path

// Ring depth, largest work item and blocks per SM: among the fastest of
// the settings tried on an H100 across the smoke's gather (4096 rows of
// 24 KiB) and the serving runs' bucket sizes (1024 and 2048 rows), which
// all lay within a few per cent of each other; 3 x 72 KiB of ring fits an
// SM's 227 KB of shared memory.
constexpr int kStages = 6;
constexpr int kStageBytes = 12 * 1024;
constexpr int kBlocksPerSM = 3;
constexpr int kMaxRowsPerItem = kLanes;    // one issuing lane per row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// An L2 policy that evicts the lines it reads first: a gathered table row
// is read once, and the L2 is better spent on the output, which the
// combine reads next.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// global -> shared, completion counted in bytes on the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// shared -> global, tracked by the issuing thread's bulk groups
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Make this thread's ordinary shared-memory writes visible to the bulk
// copies (the async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Work item t covers output rows [i0, i0 + rcount) and bytes [off, off +
// len) of each of them: either one chunk of one row (chunks > 1, rows == 1)
// or up to 32 whole rows (chunks == 1).  In both cases its output is one
// contiguous range of rcount * len bytes.
struct Item {
  int64_t i0, off;
  int rcount;
  uint32_t len;
};

__device__ __forceinline__ Item item_at(int64_t t, int64_t n,
                                        int64_t row_bytes, int rows,
                                        int64_t chunks, int64_t chunk_bytes) {
  Item it;
  const int64_t c = t % chunks;
  it.i0 = (t / chunks) * rows;
  it.off = c * chunk_bytes;
  const int64_t left = row_bytes - it.off;
  it.len = (uint32_t)(left < chunk_bytes ? left : chunk_bytes);
  const int64_t r = n - it.i0;
  it.rcount = (int)(r < rows ? r : rows);
  return it;
}

// Fill one stage with item t: lane j < rcount issues the bulk load of row
// i0 + j's piece; rows whose id is outside [0, V) are zeroed by the whole
// warp with ordinary stores instead.  Lane 0 arms the stage's barrier with
// the bytes the loads will bring.
__device__ __forceinline__ void fill_stage(
    unsigned char* stage, uint32_t bar, const unsigned char* table,
    const int32_t* ids, int64_t V, int64_t row_bytes, const Item& it,
    uint64_t policy) {
  const int lane = threadIdx.x;
  int64_t id = -1;
  if (lane < it.rcount) id = ids[it.i0 + lane];
  const bool valid = lane < it.rcount && id >= 0 && id < V;
  const unsigned valid_mask = __ballot_sync(0xffffffffu, valid);
  if (lane == 0) mbar_arrive_expect_tx(bar, __popc(valid_mask) * it.len);
  __syncwarp();
  if (valid)
    bulk_load(smem_addr(stage + (int64_t)lane * it.len),
              table + id * row_bytes + it.off, it.len, bar, policy);
  const unsigned rows_mask =
      it.rcount >= 32 ? 0xffffffffu : ((1u << it.rcount) - 1u);
  unsigned zero_mask = rows_mask & ~valid_mask;
  if (zero_mask) {
    while (zero_mask) {
      const int j = __ffs(zero_mask) - 1;
      zero_mask &= zero_mask - 1;
      uint4* dst = reinterpret_cast<uint4*>(stage + (int64_t)j * it.len);
      for (uint32_t w = lane; w < it.len / 16; w += kLanes)
        dst[w] = make_uint4(0, 0, 0, 0);
    }
    fence_async_shared();
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kLanes)
gather_tma_kernel(const unsigned char* __restrict__ table,
                  const int32_t* __restrict__ ids,
                  unsigned char* __restrict__ out, int64_t n, int64_t V,
                  int64_t row_bytes, int rows, int64_t chunks,
                  int64_t chunk_bytes, int64_t items, int stage_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int lane = threadIdx.x;
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_async_shared();
  }
  __syncwarp();
  const uint64_t policy = evict_first_policy();
  // this block's items: t = blockIdx.x + j * gridDim.x (the grid is no
  // larger than the item count)
  const int64_t mine =
      (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto item_of = [&](int64_t j) {
    return item_at(blockIdx.x + j * (int64_t)gridDim.x, n, row_bytes, rows,
                   chunks, chunk_bytes);
  };
  auto stage_of = [&](int64_t j) {
    return ring + (j % kStages) * stage_bytes;
  };
  auto bar_of = [&](int64_t j) { return smem_addr(&full[j % kStages]); };
  for (int64_t j = 0; j < kStages && j < mine; ++j)
    fill_stage(stage_of(j), bar_of(j), table, ids, V, row_bytes, item_of(j),
               policy);
  for (int64_t j = 0; j < mine; ++j) {
    if (lane == 0) {
      const uint32_t parity = (uint32_t)((j / kStages) & 1);
      // a load that never lands is a fault: trap (the launch then fails
      // and the wrapper raises) rather than spin forever
      for (uint32_t spins = 0; !mbar_try_wait(bar_of(j), parity);)
        if (++spins == (1u << 30)) __trap();
      fence_async_shared();
      const Item it = item_of(j);
      bulk_store(out + it.i0 * row_bytes + it.off, smem_addr(stage_of(j)),
                 (uint32_t)it.rcount * it.len);
    }
    // refill the previous item's stage once its store has read it
    const int64_t next = j - 1 + kStages;
    if (j >= 1 && next < mine) {
      if (lane == 0)
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      __syncwarp();
      fill_stage(stage_of(next), bar_of(next), table, ids, V, row_bytes,
                 item_of(next), policy);
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

bool tma_ok(int64_t row_bytes, uintptr_t ptrs) {
  return row_bytes % 16 == 0 && ptrs % 16 == 0;
}

// Gathers that write more than this take the word path (see the note at
// the top: measured faster at 50 MB and above, slower at 25 MB).
constexpr int64_t kTmaMaxBytes = 32LL << 20;

bool tma_chosen(int64_t n, int64_t row_bytes, uintptr_t ptrs) {
  return tma_ok(row_bytes, ptrs) && n * row_bytes <= kTmaMaxBytes;
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

int launch_gather_tma(const void* table, const int32_t* ids, void* out,
                      int64_t n, int64_t V, int64_t row_bytes,
                      cudaStream_t stream) {
  static bool attr_set[64] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const int ring_bytes = kStages * kStageBytes;
  if (dev >= 0 && dev < 64 && !attr_set[dev]) {
    e = cudaFuncSetAttribute(gather_tma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  int rows = 1;
  int64_t chunks = 1, chunk_bytes = row_bytes;
  if (row_bytes > kStageBytes) {
    chunks = (row_bytes + kStageBytes - 1) / kStageBytes;
    chunk_bytes = ((row_bytes + chunks - 1) / chunks + 15) / 16 * 16;
    chunks = (row_bytes + chunk_bytes - 1) / chunk_bytes;
  } else {
    const int64_t fit = kStageBytes / row_bytes;
    rows = (int)(fit < kMaxRowsPerItem ? fit : kMaxRowsPerItem);
  }
  const int64_t items = (n + rows - 1) / rows * chunks;
  const int stage_bytes = (int)(rows * chunk_bytes);
  const int64_t slots = (int64_t)kBlocksPerSM * sm_count();
  const unsigned grid = (unsigned)(items < slots ? items : slots);
  gather_tma_kernel<<<grid, kLanes, kStages * stage_bytes, stream>>>(
      (const unsigned char*)table, ids, (unsigned char*)out, n, V, row_bytes,
      rows, chunks, chunk_bytes, items, stage_bytes);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- segmented scatter

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// N consecutive elements moved as one access (two 16-byte words when the
// pack is 32 bytes).
template <typename E, int N>
struct alignas(N * sizeof(E) >= 16 ? 16 : N * sizeof(E)) Pack {
  E e[N];
};

// One warp per (sorted position k, chunk of 32 * N columns); each lane owns
// N consecutive columns.  G: the gradients' type, B: base's.  The warp
// reads positions k - 1 .. k + 31 of the sort at once (coalesced); unless
// k starts a run it exits.  It then walks its run 32 positions at a time:
// lane l holds position j0 + l's token row, the warp loads kBatch of the
// run's token rows at once (independent loads, in flight together) and
// adds them in sorted order, while the next 32 positions are read.  A long
// run (the Zipf head: a seventh of a smollm batch is one token) thus costs
// about one load latency per kBatch tokens: the sum must be taken in
// order, so the run is one dependent chain and bounds the kernel's time.
// One warp per block, so a short run's warp leaves the SM as soon as it
// is done, and kBatch = 32 / N rows in flight per lane (8 16-byte loads):
// about 64 registers, so all of a step's warps fit on the card at once.
// Larger batches, with their registers, and blocks of eight warps both
// timed slower on an H100.
template <typename G, typename B, int N>
__global__ void __launch_bounds__(kLanes)
segment_scatter_kernel(B* __restrict__ base,
                       const int32_t* __restrict__ order,
                       const int32_t* __restrict__ sorted_ids,
                       const G* __restrict__ grads, int64_t T, int64_t R,
                       int64_t D) {
  constexpr int kBatch = 32 / N < kLanes ? 32 / N : kLanes;
  const int64_t k = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t j = k + lane;
  const int32_t sid = j < T ? sorted_ids[j] : 0;
  int32_t row = j < T ? order[j] : 0;
  const int32_t prev = k > 0 ? sorted_ids[k - 1] : 0;
  const int32_t id = __shfl_sync(0xffffffffu, sid, 0);
  if ((k > 0 && prev == id) || id < 0 || id >= R) return;
  const int64_t c = ((int64_t)blockIdx.y * kLanes + lane) * N;
  const bool active = c < D;   // lanes past the row still read indices
  const G* col = grads + (active ? c : 0);
  float acc[N];
#pragma unroll
  for (int u = 0; u < N; ++u) acc[u] = 0.0f;
  int64_t j0 = k;
  bool in_run = j < T && sid == id;
  for (;;) {
    const unsigned mask = __ballot_sync(0xffffffffu, in_run);
    const int len = mask == 0xffffffffu ? kLanes : __ffs(~mask) - 1;
    bool next_in = false;
    int32_t next_row = 0;
    if (len == kLanes) {
      const int64_t jn = j0 + kLanes + lane;
      if (jn < T) {
        next_in = sorted_ids[jn] == id;
        next_row = order[jn];
      }
    }
    for (int u0 = 0; u0 < len; u0 += kBatch) {
      Pack<G, N> p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int32_t r = __shfl_sync(0xffffffffu, row, u0 + u);
        if (active && u0 + u < len)
          p[u] = *reinterpret_cast<const Pack<G, N>*>(col + (int64_t)r * D);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (active && u0 + u < len) {
#pragma unroll
          for (int e = 0; e < N; ++e)
            acc[e] = __fadd_rn(acc[e], to_f32(p[u].e[e]));
        }
    }
    if (len < kLanes) break;
    j0 += kLanes;
    in_run = next_in;
    row = next_row;
  }
  if (!active) return;
  Pack<B, N> o;
#pragma unroll
  for (int u = 0; u < N; ++u) from_f32(acc[u], &o.e[u]);
  *reinterpret_cast<Pack<B, N>*>(base + (int64_t)id * D + c) = o;
}

template <typename G, typename B>
int launch_segment_scatter(void* base, const int32_t* order,
                           const int32_t* sorted_ids, const void* grads,
                           int64_t T, int64_t R, int64_t D,
                           cudaStream_t stream) {
  constexpr int N = 16 / (int)sizeof(B);      // a 16-byte store per lane
  constexpr int kLoadAlign = N * sizeof(G) >= 16 ? 16 : N * sizeof(G);
  const bool vec = D % N == 0 && (uintptr_t)base % 16 == 0 &&
                   (uintptr_t)grads % kLoadAlign == 0;
  const int64_t per_warp = vec ? (int64_t)kLanes * N : kLanes;
  const int64_t chunks = (D + per_warp - 1) / per_warp;
  if (T > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)T, (unsigned)chunks);
  if (vec)
    segment_scatter_kernel<G, B, N><<<grid, kLanes, 0, stream>>>(
        (B*)base, order, sorted_ids, (const G*)grads, T, R, D);
  else
    segment_scatter_kernel<G, B, 1><<<grid, kLanes, 0, stream>>>(
        (B*)base, order, sorted_ids, (const G*)grads, T, R, D);
  return (int)cudaGetLastError();
}

}  // namespace

// The launchers' argument blocks (launch_args.h).
#define GATHER_ARGS(X)                                                  \
  X(const void*, table, p) X(const int32_t*, ids, p) X(void*, out, p)   \
  X(long long, n, i) X(long long, V, i) X(long long, row_bytes, i)      \
  X(long long, path, i)
#define COMBINE_ARGS(X)                                                 \
  X(const int32_t*, hit, p) X(const int32_t*, cslot, p)                 \
  X(const int32_t*, bslot, p) X(const void*, cache, p)                  \
  X(const void*, buf, p) X(void*, out, p) X(long long, T, i)            \
  X(long long, row_bytes, i)
#define SCATTER_ARGS(X)                                                 \
  X(void*, base, p) X(const int32_t*, ids, p) X(const void*, rows, p)   \
  X(long long, n, i) X(long long, R, i) X(long long, row_bytes, i)
#define SEGMENT_SCATTER_ARGS(X)                                         \
  X(void*, base, p) X(const int32_t*, order, p)                         \
  X(const int32_t*, sorted_ids, p) X(const void*, grads, p)             \
  X(long long, T, i) X(long long, R, i) X(long long, D, i)              \
  X(long long, base_bf16, i) X(long long, grads_bf16, i)
LAUNCH_ARGS(GatherArgs, GATHER_ARGS, embed_gather_launch_args)
LAUNCH_ARGS(CombineArgs, COMBINE_ARGS, pm_combine_launch_args)
LAUNCH_ARGS(ScatterArgs, SCATTER_ARGS, scatter_rows_launch_args)
LAUNCH_ARGS(SegmentScatterArgs, SEGMENT_SCATTER_ARGS,
            segment_scatter_rows_launch_args)

extern "C" {

// 1 when embed_gather_launch, left to choose, takes the TMA path for a
// gather of n rows of row_bytes bytes, 0 for the word path.
int embed_gather_path(const void* table, const void* out, long long n,
                      long long row_bytes) {
  return tma_chosen(n, row_bytes, (uintptr_t)table | (uintptr_t)out) ? 1
                                                                     : 0;
}

// table (V, D) and out (n, D), rows of row_bytes = D * elt bytes; ids (n,)
// int32.  path 0 chooses by size and alignment; 1 takes the TMA path (an
// error where rows or pointers are not 16-byte aligned), 2 the word path,
// to time and check one against the other.  Returns a cudaError_t.
int embed_gather_launch(const GatherArgs* a, void* stream) {
  const int64_t n = a->n, V = a->V, row_bytes = a->row_bytes;
  if (n == 0 || row_bytes == 0) return (int)cudaSuccess;
  if (row_bytes % 2 != 0 || !grid_ok(n, row_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* table = a->table;
  const int32_t* id = a->ids;
  void* out = a->out;
  const uintptr_t ptrs = (uintptr_t)table | (uintptr_t)out;
  if (a->path == 1 && !tma_ok(row_bytes, ptrs))
    return (int)cudaErrorInvalidValue;
  if (a->path == 1 || (a->path == 0 && tma_chosen(n, row_bytes, ptrs)))
    return launch_gather_tma(table, id, out, n, V, row_bytes, s);
  switch (word_bytes(row_bytes, ptrs)) {
    case 16: launch_gather<uint4>(table, id, out, n, V, row_bytes, s); break;
    case 8: launch_gather<uint2>(table, id, out, n, V, row_bytes, s); break;
    case 4: launch_gather<uint32_t>(table, id, out, n, V, row_bytes, s); break;
    default: launch_gather<uint16_t>(table, id, out, n, V, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

// hit, cslot, bslot (T,) int32; cache (C, D), buf (M + 1, D) and out
// (T, D), rows of row_bytes bytes.  Returns a cudaError_t.
int pm_combine_launch(const CombineArgs* a, void* stream) {
  const int64_t T = a->T, row_bytes = a->row_bytes;
  if (T == 0 || row_bytes == 0) return (int)cudaSuccess;
  if (row_bytes % 2 != 0 || !grid_ok(T, row_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t *h = a->hit, *cs = a->cslot, *bs = a->bslot;
  const void *cache = a->cache, *buf = a->buf;
  void* out = a->out;
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
int scatter_rows_launch(const ScatterArgs* a, void* stream) {
  const int64_t n = a->n, R = a->R, row_bytes = a->row_bytes;
  if (n == 0 || row_bytes == 0) return (int)cudaSuccess;
  if (row_bytes % 2 != 0 || !grid_ok(n, row_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  void* base = a->base;
  const int32_t* id = a->ids;
  const void* rows = a->rows;
  switch (word_bytes(row_bytes, (uintptr_t)base | (uintptr_t)rows)) {
    case 16: launch_scatter<uint4>(base, id, rows, n, R, row_bytes, s); break;
    case 8: launch_scatter<uint2>(base, id, rows, n, R, row_bytes, s); break;
    case 4: launch_scatter<uint32_t>(base, id, rows, n, R, row_bytes, s); break;
    default: launch_scatter<uint16_t>(base, id, rows, n, R, row_bytes, s);
  }
  return (int)cudaGetLastError();
}

// base (R, D) written in place, fp32 (base_bf16 == 0) or bf16; order and
// sorted_ids (T,) int32, the step's sort (sorted_ids = ids[order]); grads
// (T, D) fp32 (grads_bf16 == 0) or bf16.  Returns a cudaError_t.
int segment_scatter_rows_launch(const SegmentScatterArgs* a, void* stream) {
  const int64_t T = a->T, R = a->R, D = a->D;
  if (T == 0 || D == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  void* base = a->base;
  const int32_t *o = a->order, *si = a->sorted_ids;
  const void* g = a->grads;
  using bf16 = __nv_bfloat16;
  if (a->base_bf16 && a->grads_bf16)
    return launch_segment_scatter<bf16, bf16>(base, o, si, g, T, R, D, s);
  if (a->base_bf16)
    return launch_segment_scatter<float, bf16>(base, o, si, g, T, R, D, s);
  if (a->grads_bf16)
    return launch_segment_scatter<bf16, float>(base, o, si, g, T, R, D, s);
  return launch_segment_scatter<float, float>(base, o, si, g, T, R, D, s);
}

const char* row_kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
