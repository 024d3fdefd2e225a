// Shared pieces of the port's copy kernels (dma.cu, fabric.cu, copy_loops.cu):
// the 16-byte copy loop every kernel is built on, the grid sizing, and the
// system-scope loads, stores and clock the fabric's completion flags use.
//
// Each .cu that includes this file is built into a library of its own, so
// everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
// A flag wait that has not been satisfied after this long traps, so a lost
// completion becomes a CUDA error at the next synchronise, not a hang.
constexpr unsigned long long kSpinLimitNs = 10ull * 1000 * 1000 * 1000;

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

__global__ void __launch_bounds__(kThreads)
copy_u4(const uint4* __restrict__ src, uint4* __restrict__ dst, long long n) {
  copy_words(src, dst, n, (long long)blockIdx.x * blockDim.x + threadIdx.x,
             (long long)gridDim.x * blockDim.x);
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

// CTAs for a copy of n16 words: enough for the work, at most kCtasPerSm a SM.
inline int copy_grid(int device, long long n16) {
  const long long want = (n16 + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count(device) * kCtasPerSm;
  return (int)(want < cap ? want : cap);
}

inline int launch_copy(int device, const void* src, void* dst, long long nbytes,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n16 = nbytes / 16;
  if (n16 <= 0) return (int)cudaSuccess;
  copy_u4<<<copy_grid(device, n16), kThreads, 0, stream>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n16);
  return (int)cudaGetLastError();
}

}  // namespace
