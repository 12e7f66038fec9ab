// Shared definitions of the rna_algos_tpu_torch kernels.
//
// Every C entry point launches on the stream it is given, allocates
// nothing, does not synchronise, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

// CONTRAfold 2-loop window: loop lengths a, b in [0, 30], a + b <= 30,
// kept as the 32 x 32 banded matrix K[a][r] = LEN[r - a - 1][a]
// (pallas_fold_prob._banded_window_kernel), whose column r = a + b + 1
// is the window age of the inner pair.
#define RNA_WIN 32
// MIN_HAIRPIN_LEN + 2 (constants.MIN_SPAN_HAIRPIN_CLOSE)
#define RNA_MIN_SPAN_HAIRPIN_CLOSE 5
// The per-sequence scalar row (pallas_fold_prob._scal_rows):
// [eu1, ebp, mbu1, mbbp]
#define RNA_SCAL 4
