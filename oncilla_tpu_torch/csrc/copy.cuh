// Shared pieces of the port's copy kernels (dma.cu, fabric.cu, ceiling.cu,
// copy_loops.cu): the 16-byte register copy loop of the copy loops (K7,
// K9, K10), the TMA bulk-copy helpers and the one-shot bulk copy built on
// them, the card's SM count, and the system-scope loads, stores and clock
// the fabric's completion flags use.
//
// Each .cu that includes this file is built into a library of its own, so
// everything here has internal linkage.
//
// The one-shot bulk copy (bulk_copy_cta / bulk_copy_kernel): every one-shot
// copy of the port runs it, K1's put, K2's get, K3's same-device copy and
// K4 (its send and its same-row path). Bound: a copy of n bytes moves 2*n
// bytes of HBM traffic (n read, n written), 2*n over 3.35 TB/s on an H100
// SXM.
// Design: a register copy (copy_words) spends a thread's registers and
// instructions on every 16 bytes, and its stores trail its loads inside
// each thread. Here one thread a CTA hands whole tiles to the Tensor Memory
// Accelerator: a bulk load (cp.async.bulk) of a tile from global into a
// slot of a shared-memory ring, whose arrival completes the slot's
// mbarrier, then a bulk store of the slot to the destination. On an H100
// (PERF.md) it took 1.5 % less device time than a 16-byte register copy at
// 1 GiB and 5 % less at one 16 MiB page with a cold L2; dealing the tiles
// round robin took 0.5-0.9 % more off at 1 GiB and 2.5 % at a cold page,
// where an L2 evict-first policy and read batches gained nothing (PERF.md,
// the lever table). At a cold page it takes less device time than
// Tensor.copy_; at 1 GiB it is 4.4 % behind it, though that memcpy runs on
// the SMs too.
//   - Grid: a persistent grid, kept under one CTA a SM (the caller's plan,
//     ops/dma.py bulk_plan); the T tiles are dealt round robin, CTA b of G
//     copying tiles b, b+G, b+2G, ..., so that at any moment the grid reads
//     one window of about G tiles and writes one, as a grid-stride copy
//     does, instead of G read fronts and G write fronts spread over the
//     whole extent. Every tile is read once, so no CTA finds another's
//     bytes in L2 (as K6's repeated sweeps would: K6 keeps a contiguous
//     slice a CTA).
//   - Tiles: at most kTileMax bytes; the last tile of a copy may be shorter
//     (a size is a multiple of 4096, not of the tile). Sizes and addresses
//     are multiples of 16, as cp.async.bulk requires.
//   - The ring: `slots` tiles a CTA, one mbarrier a slot; a slot's k-th use
//     completes its barrier's phase k, so the wait passes on parity k & 1.
//   - One thread drives it: it waits for tile k's load, posts tile k's bulk
//     store, then, once every store but tile k's has read its slot
//     (cp.async.bulk.wait_group.read 1), loads tile k-1+depth into tile
//     k-1's slot. Within one copy no tile is loaded after it is stored, so
//     a slot is free once its store has read it; K8 waits for the stores
//     to complete only because it reloads bytes it stored. The CTA ends
//     with cp.async.bulk.wait_group 0: its stores have completed.
//   - Source and destination do not overlap (every caller's contract), so
//     no store lands on a byte still to be read.
// The tile, the slots and the CTAs a SM were chosen on an H100 by
// `python3 scripts/tune_bulk_plan.py` (PERF.md: the table of every
// candidate at one cold 16 MiB page and at 1 GiB).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The copy loops' register body: threads a CTA, and at most CTAs a SM.
constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
// A flag wait that has not been satisfied after this long traps, so a lost
// completion becomes a CUDA error at the next synchronise, not a hang.
constexpr unsigned long long kSpinLimitNs = 10ull * 1000 * 1000 * 1000;
// The largest TMA tile, and the most ring slots a CTA may have.
constexpr long long kTileMax = 32 << 10;
constexpr int kMaxSlots = 16;

// Copies n 16-byte words src -> dst. Thread t of nt cooperating threads
// takes words t, t+nt, ...: four loads in flight before their stores.
// The pointers are not __restrict__: the copy loops read in one copy what
// other CTAs wrote in the previous one, so no load may take the
// non-coherent read-only path.
__device__ __forceinline__ void copy_words(const uint4* src, uint4* dst,
                                           long long n, long long t,
                                           long long nt) {
  long long i = t;
  for (; i + 3 * nt < n; i += 4 * nt) {
    uint4 a = src[i];
    uint4 b = src[i + nt];
    uint4 c = src[i + 2 * nt];
    uint4 d = src[i + 3 * nt];
    dst[i] = a;
    dst[i + nt] = b;
    dst[i + 2 * nt] = c;
    dst[i + 3 * nt] = d;
  }
  for (; i < n; i += nt) dst[i] = src[i];
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ long long ld_acquire_sys(const long long* p) {
  long long v;
  asm volatile("ld.acquire.sys.global.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(long long* p, long long v) {
  asm volatile("st.release.sys.global.s64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// Spins until *flag >= want (acquire at system scope), or traps after
// kSpinLimitNs.
__device__ __forceinline__ void wait_flag_sys(const long long* flag,
                                              long long want) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire_sys(flag) < want) {
    if (now_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// -- TMA bulk copies ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// Posts a bulk load of `bytes` from global `src` into shared `dst`; it
// completes the current phase of `bar` (one arrival that expects the bytes).
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Posts a bulk store of `bytes` from shared `src` to global `dst` as one
// bulk group.
__device__ __forceinline__ void store_tile(uint8_t* dst, const uint8_t* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until phase `parity` of `bar` has completed, or traps.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const unsigned long long t0 = now_ns();
  uint32_t done = 0;
  for (;;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (now_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// This CTA's share of the one-shot copy dst[0, n) <- src[0, n) in tiles of
// `tile` bytes (the header's design note). Called by one thread; `ring`
// holds `slots` tiles, `bars` `slots` mbarriers. Returns once the CTA's
// stores have completed.
__device__ __forceinline__ void bulk_copy_cta(const uint8_t* src, uint8_t* dst,
                                              long long n, long long tile,
                                              int slots, uint8_t* ring,
                                              uint64_t* bars) {
  const long long tiles = (n + tile - 1) / tile;
  const long long G = gridDim.x, b = blockIdx.x;
  const long long per = (tiles - b + G - 1) / G;  // >= 1: G <= tiles
  const long long depth = per < slots ? per : slots;
  // The byte offset of this CTA's k-th tile.
  auto at = [&](long long k) { return (b + k * G) * tile; };
  auto bytes = [&](long long k) {
    const long long left = n - at(k);
    return static_cast<uint32_t>(left < tile ? left : tile);
  };
  for (int s = 0; s < depth; ++s) mbar_init(&bars[s]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (long long k = 0; k < depth; ++k) {
    load_tile(ring + k * tile, src + at(k), bytes(k), &bars[k]);
  }
  for (long long k = 0; k < per; ++k) {
    const long long s = k % depth;
    mbar_wait(&bars[s], static_cast<uint32_t>((k / depth) & 1));
    store_tile(dst + at(k), ring + s * tile, bytes(k));
    const long long j = k - 1 + depth;  // the next load, into tile k-1's slot
    if (k >= 1 && j < per) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load_tile(ring + (j % depth) * tile, src + at(j), bytes(j),
                &bars[j % depth]);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// The one-shot bulk copy alone (K1-K3, K4 within a row). One warp a CTA,
// of which thread 0 works.
__global__ void __launch_bounds__(32)
bulk_copy_kernel(const uint8_t* src, uint8_t* dst, long long n,
                 long long tile, int slots) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t bars[kMaxSlots];
  if (threadIdx.x == 0) bulk_copy_cta(src, dst, n, tile, slots, ring, bars);
}

// The tile for a chunk: kTileMax, or the largest power of two dividing it.
inline long long tile_for(long long chunk) {
  long long tile = kTileMax;
  while (chunk % tile) tile >>= 1;
  return tile;
}

template <typename K>
inline int set_smem(K kernel, long long smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline int sm_count(int device) {
  static int cache[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cache[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
    cache[device] = n;
  }
  return cache[device];
}

// Checks a bulk copy's plan (grid, tile, slots: ops/dma.py bulk_plan) for a
// copy of n bytes, and raises `kernel`'s dynamic shared-memory limit on
// `device` to the ring's slots * tile bytes when it is below that; `allowed`
// keeps the limit set on each device, so a steady launch makes no runtime
// call for it. A ring too large for the card is refused by the launch.
template <typename K>
int bulk_setup(K kernel, int device, long long n, int grid, long long tile,
               int slots, long long (&allowed)[64]) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // At least two slots: with one, the refill of tile k would be posted only
  // after the wait for it (bulk_copy_cta).
  if (n <= 0 || n % 16 || tile <= 0 || tile % 16 || tile > kTileMax ||
      slots < 2 || slots > kMaxSlots || grid < 1 ||
      grid > (n + tile - 1) / tile || device < 0 || device >= 64) {
    return (int)cudaErrorInvalidValue;
  }
  const long long smem = slots * tile;
  if (allowed[device] < smem) {
    const int rc = set_smem(kernel, smem);
    if (rc != 0) return rc;
    allowed[device] = smem;
  }
  return (int)cudaSuccess;
}

// Launches bulk_copy_kernel: dst[0, n) <- src[0, n) on `grid` CTAs.
inline int launch_bulk(int device, const void* src, void* dst, long long n,
                       int grid, long long tile, int slots,
                       cudaStream_t stream) {
  static long long allowed[64] = {0};
  const int rc = bulk_setup(bulk_copy_kernel, device, n, grid, tile, slots,
                            allowed);
  if (rc != 0) return rc;
  bulk_copy_kernel<<<grid, 32, slots * tile, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n, tile,
      slots);
  return (int)cudaGetLastError();
}

}  // namespace
