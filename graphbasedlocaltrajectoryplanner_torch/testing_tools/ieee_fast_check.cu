// The check of csrc/ieee_fast.cuh (the velocity scans' branch-free
// division and square root) against the plain operators, bit for bit, on
// 2^32 operands a case.  Built and run by testing_tools/ieee_fast_check.py;
// nothing in the package calls it.
#include <cuda_runtime.h>
#include <math.h>

#include "../csrc/ieee_fast.cuh"

namespace {

__device__ __forceinline__ unsigned mix(unsigned long long i, unsigned salt) {
  unsigned long long z = (i + salt) * 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return (unsigned)(z ^ (z >> 31));
}

// kind 0: the root of every float32.  kind 1: every float32 over y_fixed.
// kind 2: 2^32 pairs of random bits.  kind 3: 2^32 pairs of random sign and
// mantissa with exponents drawn from the accepted window, its edges
// included.  res[0] counts operands the fast function accepted (ok stayed
// set), res[1] those of them whose bits differ from the plain operator's.
__global__ void check_ieee_fast_kernel(int kind, float y_fixed,
                                       unsigned long long* res) {
  unsigned long long accepted = 0, wrong = 0;
  const unsigned long long n = 1ull << 32;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x
                              + threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    bool ok = true;
    float fast, plain;
    if (kind == 0) {
      const float x = __uint_as_float((unsigned)i);
      fast = ieee_fast::sqrt(x, ok);
      plain = sqrtf(x);
    } else {
      unsigned xb = kind == 1 ? (unsigned)i : mix(i, 1), yb = mix(i, 2);
      if (kind == 3) {        // exponents 67..187: 2^-60 .. 2^60
        xb = (xb & 0x807fffffu) | ((67u + mix(i, 3) % 121u) << 23);
        yb = (yb & 0x807fffffu) | ((67u + mix(i, 4) % 121u) << 23);
      }
      const float x = __uint_as_float(xb);
      const float y = kind == 1 ? y_fixed : __uint_as_float(yb);
      fast = ieee_fast::div(x, ieee_fast::make_recip(y), ok);
      plain = x / y;
    }
    if (ok) {
      ++accepted;
      wrong += __float_as_uint(fast) != __float_as_uint(plain);
    }
  }
  atomicAdd(res, accepted);
  atomicAdd(res + 1, wrong);
}

}  // namespace

extern "C" int check_ieee_fast(int kind, float y_fixed,
                               unsigned long long* res, void* stream) {
  check_ieee_fast_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      kind, y_fixed, res);
  return (int)cudaGetLastError();
}
