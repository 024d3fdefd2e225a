// The one-sided device fabric for Hopper (sm_90a): K4, a row-to-row copy
// that one process issues into any row of the fabric.
//
// Replaces the Pallas TPU kernel K4 of oncilla_tpu/ops/pallas_ici.py,
// pallas_ici_copy (_one_sided_protocol / _make_copy_kernel /
// _make_copy_call, pallas_call at :145), and with it K5
// (_cached_window_copy, the same protocol over <=96 KiB windows for the
// CPU interpret machine), which needs no kernel of its own here.
//
// The TPU kernel runs on every chip of the mesh under one controller: the
// source chip posts a remote DMA (make_async_remote_copy) and waits on its
// send semaphore, the destination chip waits on its recv semaphore, and a
// same-chip copy takes a local DMA. The controlling process here holds a
// pointer into every row, so the counterpart is:
//   - local fast path (source row == destination row, not force_remote):
//     ocm_onesided_local, copy.cuh's one-shot bulk copy alone, K3's kernel
//     (the extents are disjoint, as the wrapper asserts);
//   - send (ocm_onesided_send), on the source row's device: copy.cuh's
//     one-shot TMA bulk copy storing through the destination row's
//     pointer, on a persistent grid of at most one CTA a SM (the wrapper's
//     plan, ops/dma.py bulk_plan). Then each CTA's one working thread
//     counts the CTA out on the source row's CTA counter, and the last one
//     release-stores the transfer's sequence number into the destination
//     row's recv flag (a small int64 tensor beside the row, the counterpart
//     of the semaphore scratch, scratch_shapes :152-156) and resets the
//     counter for the next send from that row;
//   - recv (ocm_onesided_wait), one thread on the destination row's
//     device: acquire-spins on the recv flag until it reaches the
//     transfer's number, so work queued after it on that device sees the
//     bytes. Sequence numbers only grow, so no flag is ever reset. The spin
//     traps after ~10 s (kSpinLimitNs): a lost flag becomes a CUDA error.
//     The wrapper launches it only where the destination's stream is not
//     the one the send went on, i.e. for a row on another card. On one card
//     every row uses the device's current stream, and stream order already
//     is the wait; the flag still rises to the transfer's number on every
//     send (force_remote is the TPU kernel's loopback).
//
// Memory order of the bulk send. A CTA's stores are issued by the async
// proxy (the TMA unit). cp.async.bulk.wait_group 0 returns once they have
// completed, and fence.proxy.async.global orders them before the working
// thread's later generic-proxy accesses. That thread then counts the CTA
// out with one atom.acq_rel add on the counter: its release half orders
// the CTA's stores before the add. The adds of one send form one chain of
// read-modify-writes, so the last CTA's add, whose acquire half reads that
// chain, synchronizes with every CTA's release; its release store of the
// flag is then ordered after all the send's bytes, and an acquire load that
// sees the flag sees them, on this card or a peer. The scope is the
// reader's: system scope when the destination row lies on another card,
// device scope on one card (where only this card, or the host after a
// synchronise, reads the flag). That is one atomic a CTA, at most 132 a
// send on an H100, and no full fence.
//
// Across cards. A bulk store into a row on another card is a store through
// a peer-mapped pointer, over NVLink. On four H100s it is byte-equal and no
// slower than a send on the register body was from cuda:0 to cuda:1 (2.874
// against 2.909 ms at 1 GiB, equal at one 16 MiB page; PERF.md), so every
// copy of the fabric, within a row or not, takes the bulk body.
// `python3 chip_smoke.py --across-cards` holds it byte for byte against the
// plain version and times it beside that version and Tensor.copy_.
//
// Bound: 2*n bytes of HBM traffic (n read at the source, n written at the
// destination): 2*n over the card's memory rate (3.35 TB/s on an H100
// SXM); across cards n over NVLink (450 GB/s each way) binds first. The
// protocol adds one atomic a CTA, and across cards one tiny kernel a
// transfer.
//
// Interface: plain C, loaded with ctypes; each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include "copy.cuh"

namespace {

// Release-add of 1 to *p, at system or device scope; returns the old value.
// The acquire half makes the last CTA's later release store cumulative over
// every earlier add in the counter's chain of read-modify-writes.
template <bool kSys>
__device__ __forceinline__ unsigned long long add_acq_rel(unsigned long long* p) {
  unsigned long long old;
  if constexpr (kSys) {
    asm volatile("atom.acq_rel.sys.global.add.u64 %0, [%1], 1;"
                 : "=l"(old) : "l"(p) : "memory");
  } else {
    asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], 1;"
                 : "=l"(old) : "l"(p) : "memory");
  }
  return old;
}

// The send's completion, run by one thread of a CTA once the CTA's stores
// are complete and ordered before it: count the CTA out with a release
// add, and if it is the last of the send, reset the counter and
// release-store `seq` into the destination's recv flag. kSys: the flag is
// read on another card (system scope); else on this one (device scope).
template <bool kSys>
__device__ __forceinline__ void count_out(unsigned long long* count,
                                          long long* flag, long long seq) {
  const unsigned long long done = add_acq_rel<kSys>(count);
  if (done + 1 == gridDim.x) {  // the last CTA of this send
    atomicExch(count, 0ull);
    if constexpr (kSys) {
      st_release_sys(flag, seq);
    } else {
      asm volatile("st.release.gpu.global.s64 [%0], %1;" ::"l"(flag), "l"(seq)
                   : "memory");
    }
  }
}

template <bool kSys>
__global__ void __launch_bounds__(32)
send_bulk_kernel(const uint8_t* src, uint8_t* dst, long long n, long long tile,
                 int slots, unsigned long long* count, long long* flag,
                 long long seq) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t bars[kMaxSlots];
  if (threadIdx.x != 0) return;
  bulk_copy_cta(src, dst, n, tile, slots, ring, bars);
  // The bulk stores are complete; order them (async proxy) before this
  // thread's release add (generic proxy).
  asm volatile("fence.proxy.async.global;" ::: "memory");
  count_out<kSys>(count, flag, seq);
}

__global__ void recv_wait_kernel(const long long* flag, long long seq) {
  wait_flag_sys(flag, seq);
}

template <bool kSys>
int launch_send(int device, const void* src, void* dst, long long nbytes,
                int grid, long long tile, int slots, void* count, void* flag,
                long long seq, cudaStream_t stream) {
  static long long allowed[64] = {0};
  const int rc = bulk_setup(send_bulk_kernel<kSys>, device, nbytes, grid, tile,
                            slots, allowed);
  if (rc != 0) return rc;
  send_bulk_kernel<kSys><<<grid, 32, slots * tile, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes,
      tile, slots, static_cast<unsigned long long*>(count),
      static_cast<long long*>(flag), seq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Local fast path: row[dst_off, +nbytes) <- row[src_off, +nbytes), disjoint,
// by bulk copy on the plan (grid, tile, slots).
int ocm_onesided_local(int device, void* row, long long src_off,
                       long long dst_off, long long nbytes, int grid,
                       long long tile, int slots, void* stream) {
  uint8_t* base = static_cast<uint8_t*>(row);
  return launch_bulk(device, base + src_off, base + dst_off, nbytes, grid,
                     tile, slots, static_cast<cudaStream_t>(stream));
}

// Send half: dst[0, nbytes) <- src[0, nbytes) by bulk copy (the plan:
// `grid` CTAs, tiles of `tile` bytes, `slots` a ring), then *flag = seq.
// `count` is the source row's CTA counter (0 between sends); `device` is
// the source's. `across`: the destination row lies on another card, so the
// completion is released at system scope (else at device scope).
int ocm_onesided_send(int device, const void* src, void* dst, long long nbytes,
                      int grid, long long tile, int slots, void* count,
                      void* flag, long long seq, int across, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return across ? launch_send<true>(device, src, dst, nbytes, grid, tile, slots,
                                    count, flag, seq, s)
                : launch_send<false>(device, src, dst, nbytes, grid, tile,
                                     slots, count, flag, seq, s);
}

// Recv half, on the destination's device: wait until *flag >= seq.
int ocm_onesided_wait(int device, const void* flag, long long seq,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  recv_wait_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(flag), seq);
  return (int)cudaGetLastError();
}

// Lets kernels on `device` load and store through pointers into `peer`'s
// memory. Enabling it twice is not an error.
int ocm_enable_peer(int device, int peer) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    return (int)cudaSuccess;
  }
  return (int)err;
}

const char* ocm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
