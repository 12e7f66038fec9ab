// Launch shape of the narrow wavefront kernels K4/K5 (Turner inside and
// outside) at N = 32-256 in steps of 32: one block per sequence.  K1/K2
// (CONTRA) take narrow.cuh's block of 256-1,024 threads a sequence instead,
// and past N = 256 every wavefront (K8/K9 for CONTRA, K12/K13 for Turner)
// runs a cluster of blocks per sequence (cluster.cuh).
//
// A narrow block has T = N threads, one a lane, no launch bound, so a
// thread keeps every register the body wants (Turner's take 80-96), and
// the window rings first in dynamic shared memory.  A narrow body strides
// by N, as the stacked kernels did, not by blockDim.x (which cost K2 4% at
// N = 256 in its one-thread-a-lane form): ptxas allocates and schedules
// these bodies very differently for edits that keep their output bitwise
// equal (PERF.md: up to 1.4x on an H100 80GB HBM3 at 700 W), so their code
// is kept as it was measured.
#pragma once

#include "common.cuh"

#define RNA_NARROW 256
#define RNA_MAX_THREADS 1024
// The N of the wavefront entry points: 32-1024 in steps of 32, and 2048.
static inline bool rna_shape_ok(int N) {
  return N >= 32 && N % 32 == 0 &&
         (N <= RNA_MAX_THREADS || N == 2 * RNA_MAX_THREADS);
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
