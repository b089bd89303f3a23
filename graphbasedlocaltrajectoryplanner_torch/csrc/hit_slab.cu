// Object -> edge slab hit masks for the batched fleet tick.
//
// Replaces the TPU kernel graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_collision.py:_kernel (via hit_slab_pallas).  Semantics of
// planner/pathgen.window_prelude: per (scenario b, object o, slab j, edge
// n->m) the minimum over the edge's S samples of the squared distance to the
// object, compared with the inflated radius ref2 and masked with obj_app.
// The slab layer is slab_layers[b, o, j] (obj_layer-1 or obj_layer), clipped
// to [0, L-1].
//
// Bound on the H100: operations (about 6 flops per sample; the sample table
// of (L, N, N, S, 2) float32 is a few MB and stays in the 50 MB L2, the
// output is one byte per edge).  Design: one thread per output edge, a
// plain loop over S with the running minimum in a register, no shared
// memory; the (L, 2S, N*N) transpose the TPU kernel used for its lanes is
// not needed.  Compiled with -fmad=false so dx*dx + dy*dy rounds exactly
// as the plain PyTorch version does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__global__ void hit_slab_kernel(const float* __restrict__ samples,
                                const int* __restrict__ slab_layers,
                                const float* __restrict__ obj_pos,
                                const float* __restrict__ ref2,
                                const uint8_t* __restrict__ obj_app,
                                uint8_t* __restrict__ out,
                                long long total, int L, int NN, int S) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    long long e = i % NN;
    long long boj = i / NN;          // (b * O + o) * 2 + j
    long long bo = boj >> 1;
    uint8_t hit = 0;
    if (obj_app[bo]) {
      int layer = slab_layers[boj];
      layer = layer < 0 ? 0 : (layer > L - 1 ? L - 1 : layer);
      const float ox = obj_pos[2 * bo];
      const float oy = obj_pos[2 * bo + 1];
      const float* p = samples + ((long long)layer * NN + e) * S * 2;
      float dmin = INFINITY;
      for (int s = 0; s < S; ++s) {
        float dx = p[2 * s] - ox;
        float dy = p[2 * s + 1] - oy;
        float d2 = dx * dx + dy * dy;
        dmin = fminf(dmin, d2);
      }
      hit = dmin <= ref2[bo];
    }
    out[i] = hit;
  }
}

extern "C" int hit_slab_launch(const float* samples, const int* slab_layers,
                               const float* obj_pos, const float* ref2,
                               const uint8_t* obj_app, uint8_t* out, int B,
                               int O, int L, int N, int S, void* stream) {
  long long total = (long long)B * O * 2 * N * N;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  hit_slab_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      samples, slab_layers, obj_pos, ref2, obj_app, out, total, L, N * N, S);
  return (int)cudaGetLastError();
}
