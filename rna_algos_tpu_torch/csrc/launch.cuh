// Launch helpers of the wavefront kernels.  At N <= 256 (RNA_NARROW) the
// probability wavefronts K1/K2 (CONTRA) and K4/K5 (Turner) run one block
// of 256-1,024 threads a sequence (narrow.cuh), and the parity tier's
// K16-K19 one block of 1,024 (fold_log.cuh); past N = 256 every
// probability wavefront (K8/K9 for CONTRA, K12/K13 for Turner) runs a
// cluster of blocks per sequence (cluster.cuh).
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
