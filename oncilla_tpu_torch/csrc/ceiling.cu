// The HBM ceiling probes for Hopper (sm_90a): K6 ocm_read_stream and K8
// ocm_vmem_roundtrip.
//
// Replaces two Pallas TPU kernels of oncilla_tpu/benchmarks/ceiling.py:
//   K6 ocm_read_stream    <- _read_stream_loop    (pallas_call at :91): `iters`
//       sweeps over the buffer, chunk by chunk, each chunk DMA'd into a
//       2-slot on-chip ring with the next chunk's DMA posted before the
//       current one is waited on; nothing is written back (ceiling.py:58-109);
//   K8 ocm_vmem_roundtrip <- _vmem_roundtrip_loop (pallas_call at :259): the
//       one-stream ping-pong copy of the first 2*nbytes, every chunk staged
//       HBM -> on-chip -> HBM (ceiling.py:216-277).
// K7 (_copy_stream_loop, :175) is K9's kernel in copy_loops.cu, launched at
// 1, 2, 4 and 8 streams.
//
// Design. The TPU's on-chip scratch is shared memory here, and its DMA engine
// the Tensor Memory Accelerator: one thread issues 1-D bulk copies
// (cp.async.bulk) of whole tiles, and a load's arrival is its mbarrier's
// transaction count reaching zero. A 2 MiB chunk is far larger than a CTA's
// 227 KB of shared memory, so a chunk is not staged whole: the buffer is cut
// into tiles of kTileMax bytes (or of the largest power of two dividing the
// chunk, if that is smaller), and a persistent grid of one CTA per SM shares
// the tiles out. Each CTA owns a ring of kSlots tile slots with one
// mbarrier each; a slot's k-th use completes the barrier's phase k, so a
// wait passes on parity k & 1 and the parity flips on every reuse.
//   - K6: each CTA streams a contiguous slice of the buffer (at the default
//     sizes about one chunk) in every sweep. Dealt round robin instead, the
//     tiles read faster than the memory can deliver (3617-4379 GB/s on an
//     H100 at 3.35 TB/s): CTAs drift apart, and one re-reads a tile that
//     another has just pulled into L2. Thread 0 keeps every slot loading:
//     it waits on the oldest load and posts the load kSlots positions ahead
//     into the same slot. Nothing is
//     stored. So that a run proves the bytes landed, in the last sweep only
//     every thread adds up the bytes of each landed tile (__vsadu4 against 0)
//     and one atomic a warp adds them into a 64-bit sum, which the caller
//     holds against a sum of the buffer; the timed sweeps before it are pure
//     streams.
//   - K8: each CTA takes the same tiles of each half in every iteration, so
//     iteration i+1 loads only bytes that the same CTA stored in iteration i
//     and no grid barrier is needed. One thread per CTA: wait for tile k's
//     load, post its bulk store from the slot, then (after
//     cp.async.bulk.wait_group 1: every store but tile k's has completed, so
//     tile k-1's slot is free and the bytes the next load reads are written)
//     post the load of tile k-1+depth into tile k-1's slot. So up to
//     depth-1 loads and two stores are in flight: a store overlaps the next
//     tiles' loads, where the TPU kernel runs each chunk's down and up legs
//     one after the other.
// The bulk-copy and mbarrier helpers are copy.cuh's, shared with the one-shot
// bulk copy of K2 and K4. Every mbarrier wait traps after ~10 s (copy.cuh's
// limit), so a lost arrival is a CUDA error at the next synchronise, not a
// hang.
//
// Bound: K6 reads total*iters bytes and writes none; K8 moves 2*nbytes of
// HBM traffic per iteration (nbytes read, nbytes written). Both are bound
// by the card's memory rate (3.35 TB/s on an H100 SXM): 48.1 ms and 16.0 ms
// at ceiling.py's defaults.
//
// Interface: plain C, loaded with ctypes; each entry point launches on the
// given stream, does not synchronise, and returns the launch's error (a
// refused shared-memory size or grid included). The caller passes 16-byte
// aligned pointers and, for K6, a zeroed int64 sum.

#include "copy.cuh"

namespace {

constexpr int kSlots = 6;  // 6 slots of kTileMax (copy.cuh): 192 KiB of shared memory
constexpr int kStreamThreads = 256;

// K6. CTA b owns the contiguous tiles [lo, lo + per) of a sweep (`tiles`
// tiles in all) and reads them in order, `iters` times: its position k is
// tile lo + k % per. A tile is read again only after every CTA has read its
// whole slice once more, so no read can be served by a copy that another
// CTA left in L2 a moment earlier.
__global__ void __launch_bounds__(kStreamThreads)
read_stream_kernel(const uint8_t* buf, long long tile, long long tiles,
                   int iters, unsigned long long* sum) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t bars[kSlots];
  const long long G = gridDim.x, b = blockIdx.x;
  const long long lo = b * tiles / G;
  const long long per = (b + 1) * tiles / G - lo;  // >= 1: G <= tiles
  const long long mine = per * iters;
  const long long k_last = mine - per;  // the first position of the last sweep
  const uint32_t bytes = static_cast<uint32_t>(tile);
  auto src = [&](long long k) { return buf + (lo + k % per) * tile; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long k = 0; k < mine && k < kSlots; ++k) {
      load_tile(ring + k * tile, src(k), bytes, &bars[k]);
    }
    // The pure stream: every sweep but the last.
    for (long long k = 0; k < k_last; ++k) {
      const int s = static_cast<int>(k % kSlots);
      mbar_wait(&bars[s], static_cast<uint32_t>((k / kSlots) & 1));
      if (k + kSlots < mine) load_tile(ring + s * tile, src(k + kSlots), bytes, &bars[s]);
    }
  }
  __syncthreads();
  // The last sweep: every thread waits for each tile and adds up its share
  // of the tile's bytes before thread 0 reuses the slot.
  unsigned long long acc = 0;
  for (long long k = k_last; k < mine; ++k) {
    const int s = static_cast<int>(k % kSlots);
    mbar_wait(&bars[s], static_cast<uint32_t>((k / kSlots) & 1));
    const uint4* w = reinterpret_cast<const uint4*>(ring + s * tile);
    for (long long i = threadIdx.x; i < tile / 16; i += blockDim.x) {
      const uint4 v = w[i];
      acc += __vsadu4(v.x, 0u) + __vsadu4(v.y, 0u) + __vsadu4(v.z, 0u) +
             __vsadu4(v.w, 0u);
    }
    __syncthreads();
    if (threadIdx.x == 0 && k + kSlots < mine) {
      load_tile(ring + s * tile, src(k + kSlots), bytes, &bars[s]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0 && acc != 0) atomicAdd(sum, acc);
}

// K8. Tile t of a half (`tiles` tiles of `tile` bytes) belongs to CTA t % G
// in every iteration; position k of a CTA is its (k % per)-th tile in
// iteration k / per. Launched with one warp, of which thread 0 works.
__global__ void __launch_bounds__(32)
roundtrip_kernel(uint8_t* buf, long long tile, long long tiles,
                 long long half, int iters) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t bars[kSlots];
  if (threadIdx.x != 0) return;
  const long long G = gridDim.x, b = blockIdx.x;
  const long long per = (tiles - 1 - b) / G + 1;  // >= 2: the grid is sized so
  const long long mine = per * iters;
  const long long depth = per < kSlots ? per : kSlots;
  const uint32_t bytes = static_cast<uint32_t>(tile);
  auto at = [&](long long k, bool dst) {
    const bool fwd = ((k / per) % 2) == 0;
    return buf + ((fwd != dst) ? 0 : half) + (b + (k % per) * G) * tile;
  };

  for (int s = 0; s < kSlots; ++s) mbar_init(&bars[s]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  for (long long k = 0; k < depth; ++k) {
    load_tile(ring + k * tile, at(k, false), bytes, &bars[k]);
  }
  for (long long k = 0; k < mine; ++k) {
    const long long s = k % depth;
    mbar_wait(&bars[s], static_cast<uint32_t>((k / depth) & 1));
    store_tile(at(k, true), ring + s * tile, bytes);
    const long long j = k - 1 + depth;  // the next load, into tile k-1's slot
    if (k >= 1 && j < mine) {
      // Every store but tile k's is complete: tile k-1's slot has been read
      // out, and tile j's source (stored by this CTA per tiles earlier,
      // j - per <= k - 1) is written.
      asm volatile("cp.async.bulk.wait_group 1;" ::: "memory");
      load_tile(ring + (j % depth) * tile, at(j, false), bytes, &bars[j % depth]);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

extern "C" {

// K6: `iters` sweeps over buf[0, total_bytes) in chunks of chunk_bytes;
// *sum += the sum of the buffer's bytes, taken in the last sweep.
int ocm_read_stream(int device, const void* buf, long long total_bytes,
                    long long chunk_bytes, int iters, void* sum,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (iters <= 0 || chunk_bytes <= 0 || chunk_bytes % 4096 ||
      total_bytes <= 0 || total_bytes % chunk_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tile = tile_for(chunk_bytes);
  const long long tiles = total_bytes / tile;
  const long long smem = kSlots * tile;
  int rc = set_smem(read_stream_kernel, smem);
  if (rc != 0) return rc;
  const long long grid = tiles < sm_count(device) ? tiles : sm_count(device);
  read_stream_kernel<<<(int)grid, kStreamThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), tile, tiles, iters,
      static_cast<unsigned long long*>(sum));
  return (int)cudaGetLastError();
}

// K8: `iters` ping-pong copies of buf[0, nbytes) <-> buf[nbytes, 2*nbytes),
// every chunk_bytes chunk staged through shared memory.
int ocm_vmem_roundtrip(int device, void* buf, long long nbytes, int iters,
                       long long chunk_bytes, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (iters <= 0 || chunk_bytes <= 0 || chunk_bytes % 4096 || nbytes <= 0 ||
      nbytes % (2 * chunk_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tile = tile_for(chunk_bytes);
  const long long tiles = nbytes / tile;  // >= 2: nbytes holds two chunks
  const long long smem = kSlots * tile;
  int rc = set_smem(roundtrip_kernel, smem);
  if (rc != 0) return rc;
  // At least two tiles a CTA, so that a load is in flight while a store is.
  const long long grid = tiles / 2 < sm_count(device) ? tiles / 2 : sm_count(device);
  roundtrip_kernel<<<(int)grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(buf), tile, tiles, nbytes, iters);
  return (int)cudaGetLastError();
}

const char* ocm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
