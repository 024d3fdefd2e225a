// Arena copy kernels for Hopper (sm_90a): put, get and same-device copy.
//
// Replaces three Pallas TPU kernels of oncilla_tpu/ops/pallas_ici.py:
//   K1 ocm_write_rows  <- pallas_write_rows  (_make_rows_write_kernel): put,
//                         a dense buffer -> arena bytes [dst, dst+n)
//   K2 ocm_read_rows   <- pallas_read_rows   (_make_rows_read_kernel): get,
//                         arena bytes [src, src+n) -> a fresh dense buffer
//   K3 ocm_local_copy  <- pallas_local_copy  (_make_local_copy_kernel):
//                         arena extent -> non-overlapping arena extent
//
// Bound: each is a pure copy, so it moves 2*n bytes of HBM traffic (n read,
// n written) and does no arithmetic; the least time is 2*n over the card's
// memory rate (3.35 TB/s on an H100 SXM). Below ~1 MiB the launch itself
// dominates.
//
// Design: the TPU kernels handed the copy to the DMA engine as two
// overlapped descriptors. Here all three hand it to the Tensor Memory
// Accelerator: copy.cuh's one-shot bulk copy, tiles of up to 32 KiB
// bulk-loaded into a ring of shared memory and bulk-stored out of it by one
// thread a CTA, on a persistent grid of at most one CTA a SM. The wrapper
// passes the grid, the tile and the ring's slots (ops/dma.py bulk_plan);
// the design, and how the three were chosen, is in copy.cuh.
// The caller guarantees 16-byte aligned pointers and a size that is a
// multiple of 16 (offsets and sizes are 4096-byte aligned), as the bulk
// copy needs. K3's ranges are disjoint (the wrapper asserts it), so no
// store lands on a byte still to be read.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream (PyTorch's current stream), does not synchronise, and
// returns cudaGetLastError() so the caller raises on a refused launch.

#include "copy.cuh"

extern "C" {

// Each entry point is a bulk copy on `grid` CTAs in tiles of `tile` bytes
// through a ring of `slots` tiles a CTA.

// K1: arena[dst_off, dst_off+nbytes) <- rows[0, nbytes)
int ocm_write_rows(int device, void* arena, const void* rows,
                   long long dst_off, long long nbytes, int grid,
                   long long tile, int slots, void* stream) {
  return launch_bulk(device, rows, static_cast<uint8_t*>(arena) + dst_off,
                     nbytes, grid, tile, slots,
                     static_cast<cudaStream_t>(stream));
}

// K2: out[0, nbytes) <- arena[src_off, src_off+nbytes)
int ocm_read_rows(int device, const void* arena, void* out,
                  long long src_off, long long nbytes, int grid,
                  long long tile, int slots, void* stream) {
  return launch_bulk(device, static_cast<const uint8_t*>(arena) + src_off, out,
                     nbytes, grid, tile, slots,
                     static_cast<cudaStream_t>(stream));
}

// K3: arena[dst_off, +nbytes) <- arena[src_off, +nbytes), ranges disjoint
int ocm_local_copy(int device, void* arena, long long src_off,
                   long long dst_off, long long nbytes, int grid,
                   long long tile, int slots, void* stream) {
  uint8_t* base = static_cast<uint8_t*>(arena);
  return launch_bulk(device, base + src_off, base + dst_off, nbytes, grid,
                     tile, slots, static_cast<cudaStream_t>(stream));
}

const char* ocm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
