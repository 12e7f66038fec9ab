// CONTRAfold's piecewise-cubic log-add on the device (numerics/logsumexp.py),
// shared by the log-space kernels: K15 (pairhmm.cu), K16-K19 (*_log.cu)
// and K22 (pairhmm_rows.cu); and the hardware log-add of the "fast" mode
// (rna_lse_pair_fast).
//
// Every add and multiply is a round-to-nearest intrinsic, so nvcc contracts
// nothing into an FMA: the cubic's Horner steps and lse_pair's lo + f(z)
// round exactly as the plain PyTorch versions (and the reference) round.
#pragma once

#include <math.h>

// ln(1 + e^x) cubics, float32 values written exactly: segment k covers
// [breaks[k-1], breaks[k]).  Static: each source that includes the header
// keeps its own copy, so separately compiled objects link.
static __constant__ float kLnBreaks[7] = {
    0x1.52b4f2p-1f, 0x1.a1cbcap+0f, 0x1.3ee192p+1f, 0x1.b08b44p+1f,
    0x1.1b465ap+2f, 0x1.728024p+2f, 0x1.f43dd0p+2f};
static __constant__ float kLnCoeffs[8][4] = {
    {-0x1.addc70p-8f, 0x1.056a5cp-3f, 0x1.ffa5aep-2f, 0x1.62e51cp-1f},
    {-0x1.fc6b98p-7f, 0x1.284cb6p-3f, 0x1.f40356p-2f, 0x1.64411ep-1f},
    {-0x1.a668eap-7f, 0x1.0a735ap-3f, 0x1.07b34ep-1f, 0x1.5bef1ap-1f},
    {-0x1.d8cb46p-8f, 0x1.6770d4p-4f, 0x1.3de2c8p-1f, 0x1.2e934ep-1f},
    {-0x1.9c4aa8p-9f, 0x1.7ec11ep-5f, 0x1.84bcd6p-1f, 0x1.bd510ap-2f},
    {-0x1.090bbep-10f, 0x1.30a652p-6f, 0x1.c42f42p-1f, 0x1.026d2ap-2f},
    {-0x1.9b9ff2p-13f, 0x1.2e04cep-8f, 0x1.ed486ep-1f, 0x1.92b2a2p-4f},
    {-0x1.7e801ap-17f, 0x1.879d6cp-12f, 0x1.fde802p-1f, 0x1.eb0b88p-7f}};
// constants.LOGSUMEXP_THRESHOLD_UPPER as float32 (11.862479)
#define RNA_LSE_THRESHOLD 0x1.7b996ep+3f

__device__ __forceinline__ float rna_ln_exp_1p(float x) {
  float c3 = kLnCoeffs[0][0], c2 = kLnCoeffs[0][1];
  float c1 = kLnCoeffs[0][2], c0 = kLnCoeffs[0][3];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    if (x >= kLnBreaks[k]) {
      c3 = kLnCoeffs[k + 1][0];
      c2 = kLnCoeffs[k + 1][1];
      c1 = kLnCoeffs[k + 1][2];
      c0 = kLnCoeffs[k + 1][3];
    }
  }
  const float h = __fadd_rn(__fmul_rn(c3, x), c2);
  return __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(h, x), c1), x), c0);
}

// numerics.lse_pair: the survivor (or -inf) when an operand is -inf.
__device__ __forceinline__ float rna_lse_pair(float a, float b) {
  const float lo = fminf(a, b);
  const float hi = fmaxf(a, b);
  const float z = __fsub_rn(hi, lo);  // NaN or +inf when an operand is -inf
  if (z < RNA_LSE_THRESHOLD) return __fadd_rn(lo, rna_ln_exp_1p(z));
  return lo > -INFINITY ? __fadd_rn(lo, z) : hi;
}

// numerics.lse_pair in "fast" mode (torch.logaddexp): max + log1p(exp(-|a -
// b|)) with the device's expf and log1pf, the survivor (or -inf) when an
// operand is -inf.  Not bitwise the plain version's: the card's exp and
// log1p round differently from the CPU's.
__device__ __forceinline__ float rna_lse_pair_fast(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return __fadd_rn(m, log1pf(expf(-fabsf(__fsub_rn(a, b)))));
}
