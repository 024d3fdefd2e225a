// bench.py's copy loops for Hopper (sm_90a): K9 ocm_copy_loop and K10
// ocm_remote_loop, each all `iters` ping-pong copies in one launch.
//
// Replaces two Pallas TPU kernels of bench.py:
//   K9  ocm_copy_loop   <- _pallas_copy_loop   (pallas_call at :150): `streams`
//       independent segment pairs, stream s ping-ponging
//       [s*2q, s*2q+q) <-> [s*2q+q, s*2q+2q) with q = nbytes/streams, each
//       stream's copy i+1 queued behind its copy i (bench.py:126-146);
//   K10 ocm_remote_loop <- _pallas_remote_loop (pallas_call at :223): the same
//       schedule at 2 streams, every copy a loopback remote copy whose
//       completion is a wait_send + wait_recv (bench.py:204-221).
//
// Design: the TPU kernel keeps one DMA descriptor per stream in flight. On
// the card the copies are the SMs' loads and stores, so the CTAs split into
// `streams` groups (CTA b serves stream b % streams) and group s runs its
// copies one after another with copy.cuh's 16-byte loop over its own
// threads. Copy i+1 reads what copy i wrote, so a group waits at a barrier
// of its own between copies:
//   - K9: a per-stream arrival counter, fenced and acquired at device scope
//     (the shape of a cooperative-groups grid sync, over one group);
//   - K10: each CTA, after its barrier, fences at system scope
//     (wait_send), the group's last CTA to arrive release-stores the
//     copy's number into the
//     stream's recv flag, and every CTA acquire-spins at system scope on
//     that flag (wait_recv): the fabric's protocol (fabric.cu), in a loop.
// Every CTA of a group must be resident while the others wait, so both are
// launched with cudaLaunchCooperativeKernel at a grid the occupancy allows
// (at most kCtasPerSm a SM), rounded down to a multiple of `streams`: the
// runtime refuses a grid that cannot be co-resident instead of letting it
// deadlock. Every wait traps after ~10 s (copy.cuh).
//
// Bound: 2*nbytes of HBM traffic per iteration (each stream reads and
// writes q bytes), 2*nbytes*iters in all, over the card's memory rate
// (3.35 TB/s on an H100 SXM). The barriers add a few microseconds to each
// ~40 us copy of 64 MiB.
//
// Interface: plain C, loaded with ctypes; each entry point launches on the
// given stream, does not synchronise, and returns the launch's error. The
// caller passes zeroed counters: `arrive` (int64 per stream) and, for K10,
// `flag` (int64 per stream).

#include "copy.cuh"

namespace {

__device__ __forceinline__ long long ld_acquire_gpu(const long long* p) {
  long long v;
  asm volatile("ld.acquire.gpu.global.s64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Spins until *p >= want (acquire at device scope), or traps after
// kSpinLimitNs.
__device__ __forceinline__ void spin_gpu(const long long* p, long long want) {
  const unsigned long long t0 = now_ns();
  while (ld_acquire_gpu(p) < want) {
    if (now_ns() - t0 > kSpinLimitNs) __trap();
  }
}

template <bool kRemote>
__global__ void __launch_bounds__(kThreads)
copy_loop_kernel(uint4* buf, long long q16, int streams, int iters,
                 long long* arrive, long long* flag) {
  const int s = blockIdx.x % streams;
  const long long group = gridDim.x / streams;  // CTAs serving stream s
  const long long t = (long long)(blockIdx.x / streams) * blockDim.x + threadIdx.x;
  const long long nt = group * blockDim.x;
  uint4* lo = buf + (long long)s * 2 * q16;
  uint4* hi = lo + q16;
  for (int i = 0; i < iters; ++i) {
    const bool fwd = (i % 2) == 0;
    copy_words(fwd ? lo : hi, fwd ? hi : lo, q16, t, nt);
    const long long arrived = (long long)(i + 1) * group;
    if constexpr (kRemote) {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence_system();  // wait_send: the CTA's stores are out
        const long long before = (long long)atomicAdd(
            reinterpret_cast<unsigned long long*>(arrive + s), 1ull);
        if (before + 1 == arrived) {
          __threadfence_system();
          st_release_sys(flag + s, i + 1);
        }
        wait_flag_sys(flag + s, i + 1);  // wait_recv
        __threadfence_system();
      }
    } else {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(reinterpret_cast<unsigned long long*>(arrive + s), 1ull);
        spin_gpu(arrive + s, arrived);
        __threadfence();
      }
    }
    __syncthreads();
  }
}

template <bool kRemote>
int launch_loop(int device, void* buf, long long q_bytes, int streams,
                int iters, void* arrive, void* flag, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (streams <= 0 || iters <= 0 || q_bytes <= 0 || q_bytes % 16) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = copy_loop_kernel<kRemote>;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm > kCtasPerSm) per_sm = kCtasPerSm;
  int grid = per_sm * sm_count(device);
  grid -= grid % streams;
  if (grid < streams) return (int)cudaErrorInvalidConfiguration;
  uint4* b = static_cast<uint4*>(buf);
  long long q16 = q_bytes / 16;
  long long* a = static_cast<long long*>(arrive);
  long long* f = static_cast<long long*>(flag);
  void* args[] = {&b, &q16, &streams, &iters, &a, &f};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(kThreads), args, 0,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K9: `iters` ping-pong copies of q_bytes per stream over buf[0, 2*streams*q).
int ocm_copy_loop(int device, void* buf, long long q_bytes, int streams,
                  int iters, void* arrive, void* stream) {
  return launch_loop<false>(device, buf, q_bytes, streams, iters, arrive,
                            nullptr, static_cast<cudaStream_t>(stream));
}

// K10: the same at 2 streams, each copy completed by wait_send + wait_recv.
int ocm_remote_loop(int device, void* buf, long long q_bytes, int iters,
                    void* arrive, void* flag, void* stream) {
  return launch_loop<true>(device, buf, q_bytes, 2, iters, arrive, flag,
                           static_cast<cudaStream_t>(stream));
}

const char* ocm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
