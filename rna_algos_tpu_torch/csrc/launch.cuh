// Launch shape of the wavefront kernels (inside and outside, both models)
// at every N they serve: 32 to 1024 in steps of 32, and 2048 (CONTRA).
// CONTRA past N = 256 (K8/K9) runs a cluster of blocks per sequence
// (cluster.cuh); everything else here runs one block per sequence.
//
// A block has at most 1,024 threads, so T = min(N, 1024) threads, each
// holding LPT = N / T lanes, strided (lane = threadIdx.x + k * T).  Each
// Turner kernel's body is one __forceinline__ template behind two entry
// kernels, and each CONTRA source keeps the narrow one:
//
// - narrow, N <= 256: no launch bound, so a thread keeps every register
//   the body wants (Turner's take 80-96), and the window rings first in
//   dynamic shared memory;
// - wide, N > 256 (Turner): __launch_bounds__(1024), a thread held to 64
//   registers, the rings after the fixed shared arrays where they fit and
//   in a global scratch (one slice per sequence, L1/L2-resident) where they
//   do not: Turner's four rings are 104 x (N + 33) floats, 227 KB alone
//   at N = 512.  Either way the body addresses them through one pointer.
//
// ptxas allocates and schedules the two very differently; both are kept
// as the separate stacked and long kernels had them (PERF.md: the same
// body with other bounds or ring placements ran up to 1.4x slower,
// bitwise equal).  For the same reason a narrow body strides by N, as
// those kernels did, not by blockDim.x (which cost K2 4% at N = 256).
#pragma once

#include "common.cuh"

#define RNA_NARROW 256
#define RNA_MAX_THREADS 1024
#define RNA_MAX_LPT 2
// Dynamic shared memory a block may use on the H100 (227 KB).
#define RNA_SMEM_LIMIT 232448

static inline bool rna_shape_ok(int N) {
  return N >= 32 && N % 32 == 0 &&
         (N <= RNA_MAX_THREADS ||
          (N % RNA_MAX_THREADS == 0 && N / RNA_MAX_THREADS <= RNA_MAX_LPT));
}

// Shared-memory bytes of a wide launch whose fixed arrays take `fixed`
// bytes: the rings' `ring` bytes are added (and *smem_ring set) when they
// fit.
static inline size_t rna_smem(size_t fixed, size_t ring, int* smem_ring) {
  *smem_ring = fixed + ring <= RNA_SMEM_LIMIT;
  return fixed + (*smem_ring ? ring : 0);
}

// The rings of sequence b in a wide launch: after the fixed shared arrays,
// or its slice of the global scratch (`slice` floats per sequence).
__device__ __forceinline__ float* rna_rings(float* smem_after, float* ring_g,
                                            int b, long long slice,
                                            int smem_ring) {
  return smem_ring ? smem_after : ring_g + (long long)b * slice;
}

// Launch `kernel` on B blocks of T threads with `shmem` bytes of dynamic
// shared memory (raising the kernel's limit first); returns the CUDA
// error, 0 on success.
template <typename Kernel, typename... Args>
static int rna_launch(Kernel kernel, int B, int T, size_t shmem, void* stream,
                      Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, T, shmem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
