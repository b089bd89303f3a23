// Measurement variants of the ADMM kernel (where does the time of a solve
// go?).  Built and timed by testing_tools/admm_variants.py and chip_smoke.py
// beside the kernel in csrc/admm_vel.cu, whose device code they share;
// nothing in the package calls them.
//
// admm_variant_launch(variant, rows, <the arguments of admm_vel_launch>):
//   0  baseline: the block design, the kernel's first (one block a row,
//      the PCR tables in shared memory, one __syncthreads() an exchange)
//      at any n.
//   1  the warp design, cyclic layout, PCR tables in registers;
//   2  the warp design, cyclic layout, tables in the warp's slice of
//      shared memory;
//   3  the warp design, blocked layout (point i at lane i / K, slot
//      i % K), tables in registers;
//   4  blocked layout, tables in shared memory;
//   5  chain_only: the kernel's own layout and placement, the steps'
//      exchanges and PCR sweeps without the relaxation, projection and
//      dual update (its outputs are not the solve's).
// Variants 1-5 take `rows` rows (warps) a block, 1 to 8, and n in
// 97 .. 128 (K = 4 points a lane, as the planner's n = 115).
#include <cuda_runtime.h>
#include <stdint.h>

#include "../csrc/admm_vel.cu"

extern "C" int admm_variant_launch(
    int variant, int rows, const float* e, const float* f,
    const float* rho_b, const float* rho_a, const float* rho_d,
    const float* q, const float* x0, const float* lb, const float* ub,
    const float* ua, const float* ud, float* x, float* r_prim,
    float* r_dual, float* y, int R, int n, int iters, float sigma,
    float alpha, float one_m_alpha, float w_smooth, void* stream) {
  if (n < 2 || n > admm::N_MAX || iters < 0 || R < 0) return -1;
  if (variant != 0 && (n + 31) / 32 != 4) return -1;
  if (R == 0) return 0;
  admm::Args a{e, f, rho_b, rho_a, rho_d, q, x0, lb, ub, ua, ud,
               x, r_prim, r_dual, y, R, n, iters, admm::levels_of(n),
               sigma, alpha, one_m_alpha, w_smooth};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace admm;
  switch (variant) {
    case 0: return launch_block(a, st);
    case 1: return launch_warp_k<4, true, true, false>(a, rows, st);
    case 2: return launch_warp_k<4, true, false, false>(a, rows, st);
    case 3: return launch_warp_k<4, false, true, false>(a, rows, st);
    case 4: return launch_warp_k<4, false, false, false>(a, rows, st);
    case 5:
      return launch_warp_k<4, WARP_CYCLIC, WARP_TBL_REGS, true>(a, rows, st);
    default: return -1;
  }
}
