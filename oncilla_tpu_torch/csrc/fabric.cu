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
//     ocm_onesided_local, the same kernel as K3 (copy.cuh);
//   - send (ocm_onesided_send), on the source row's device: the copy kernel
//     storing through the destination row's pointer (peer-mapped over
//     NVLink when that row lies on another card). Each CTA, after its
//     barrier, fences at system scope and counts itself out on the source
//     row's CTA counter, and the last one release-stores the
//     transfer's sequence number into the destination row's recv flag (a
//     small int64 tensor beside the row, the counterpart of the semaphore
//     scratch, scratch_shapes :152-156) and resets the counter for the
//     next send from that row;
//   - recv (ocm_onesided_wait), one thread on the destination row's
//     device: acquire-spins on the recv flag until it reaches the
//     transfer's number, so work queued after it on that device sees the
//     bytes. Sequence numbers only grow, so no flag is ever reset. The spin
//     traps after ~10 s (kSpinLimitNs): a lost flag becomes a CUDA error.
// On one card every row uses the device's current stream, so the recv is
// satisfied in order; the protocol still runs whole (force_remote is the
// TPU kernel's loopback).
//
// Bound: 2*n bytes of HBM traffic (n read at the source, n written at the
// destination): 2*n over the card's memory rate (3.35 TB/s on an H100
// SXM); across cards n over NVLink (450 GB/s each way) binds first. The
// protocol adds one atomic per CTA and one tiny kernel per transfer.
//
// Interface: plain C, loaded with ctypes; each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include "copy.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
send_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
            long long n16, unsigned long long* count, long long* flag,
            long long seq) {
  copy_words(src, dst, n16, (long long)blockIdx.x * blockDim.x + threadIdx.x,
             (long long)gridDim.x * blockDim.x);
  __syncthreads();
  if (threadIdx.x == 0) {
    // After the barrier, one fence makes the whole CTA's stores visible to
    // every device before the CTA counts itself out.
    __threadfence_system();
    const unsigned long long done = atomicAdd(count, 1ull);
    if (done + 1 == gridDim.x) {  // the last CTA of this send
      atomicExch(count, 0ull);
      __threadfence_system();
      st_release_sys(flag, seq);
    }
  }
}

__global__ void recv_wait_kernel(const long long* flag, long long seq) {
  wait_flag_sys(flag, seq);
}

}  // namespace

extern "C" {

// Local fast path: row[dst_off, +nbytes) <- row[src_off, +nbytes), disjoint.
int ocm_onesided_local(int device, void* row, long long src_off,
                       long long dst_off, long long nbytes, void* stream) {
  uint8_t* base = static_cast<uint8_t*>(row);
  return launch_copy(device, base + src_off, base + dst_off, nbytes,
                     static_cast<cudaStream_t>(stream));
}

// Send half: dst[0, nbytes) <- src[0, nbytes), then *flag = seq. `count` is
// the source row's CTA counter (0 between sends); `device` is the source's.
int ocm_onesided_send(int device, const void* src, void* dst, long long nbytes,
                      void* count, void* flag, long long seq, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n16 = nbytes / 16;
  if (n16 <= 0) return (int)cudaErrorInvalidValue;
  send_kernel<<<copy_grid(device, n16), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16,
      static_cast<unsigned long long*>(count), static_cast<long long*>(flag),
      seq);
  return (int)cudaGetLastError();
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
