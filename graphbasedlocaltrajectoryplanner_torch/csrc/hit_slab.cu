// Object -> edge slab hit masks for the batched fleet tick and the
// interactive facade.
//
// Replaces the TPU kernel graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_collision.py:_kernel (via hit_slab_pallas).  Semantics of
// planner/pathgen.window_prelude: per (scenario b, object o, slab j, edge
// n->m) the minimum over the edge's S samples of the squared distance to the
// object, compared with the inflated radius ref2 and masked with obj_app.
// The slab layer is slab_layers[b, o, j] (obj_layer-1 or obj_layer), clipped
// to [0, L-1].  An "entry" below is one (b, o, j): one plane of N*N bytes.
//
// Bound on the H100: operations (about 6 flops per sample of an active
// entry) against the bytes of the output, one per edge, most of them zeros
// of padded objects.  What costs is neither: it is how often a layer's
// samples (N*N*S*2 floats, 64.5 KB at N=24) travel from the L2 cache to an
// SM, and how narrow the stores are.
//
//   * A block owns one layer, one range of RANGE entries and one part of
//     the layer's edges (grid L x P x Q).  It scans its range, keeps the
//     active entries whose clipped layer is its own (with their object's
//     position and radius, so that nothing is fetched per edge later), and
//     leaves if there are none.  Otherwise it stages its part of the
//     layer's samples in shared memory once, by coalesced 8-byte cp.async,
//     and computes its edges of all its entries from there.  So a layer's
//     samples cross once per (layer, range) that needs them, not once per
//     entry.  Parts of about 32 KB let an SM hold several blocks, whose
//     phases (scan, copy, compute) then overlap.
//   * A fleet that stands on few layers would leave most blocks without
//     work and a few with all of it.  So a block counts its range's
//     entries for every layer, and where a layer has more than HEAVY, the
//     blocks of the layers that have none take shares of it (role_of).
//   * A call of one car's few entries (the facade) has a kernel of its own
//     without lists, copies or barriers: a warp per 32 edges of an entry
//     reads the samples where they lie, since no layer is needed twice.
//   * A lane takes one edge and loads its samples 7 at a time before it
//     uses them, so that a warp waits once per 7 samples, not once each.
//   * In shared memory an edge's samples are S float2 with a pitch of
//     S | 1 float2: odd, so the 8-byte loads of neighbouring lanes (one
//     edge each) fall on different banks.
//   * A warp takes 32 consecutive edges of one entry, a ballot packs their
//     32 hit bits, and 8 lanes store them as 4 bytes each (one full 32-byte
//     sector a warp; single bytes only where N*N is no multiple of 4).
//   * The zero planes of inactive entries are dealt evenly over all blocks
//     and written in 16-byte stores, a thread per 16 bytes, before the
//     scan, so they are in flight while the block works.
//   * dx*dx + dy*dy is compiled with -fmad=false and rounds as the plain
//     PyTorch version does; the minimum is exact in any order.
//
// The (L, 2S, N*N) transpose the TPU kernel used for its lanes, and its
// one-grid-step-per-scenario stream of 2*O slabs, are not needed.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hs {

constexpr int THREADS = 512;
constexpr int RANGE = 2048;     // entries a block scans (see PERF.md)
constexpr int MAX_RANGE = 2048; // the most a launch may ask for
constexpr int SMALL_E = 64;     // a call of so few entries: the small kernel
constexpr int BATCH = 7;        // samples a lane loads before it uses them
constexpr int PART_BYTES = 32 * 1024;   // of a layer's samples, per block
constexpr int HEAVY = 32;       // entries of a layer and range that get help

struct __align__(16) Match {    // an entry of the block's layer
  int entry;
  float ox, oy, r2;
};

// The slab layers as the caller has them, int32 or int64 (a conversion
// before the launch would be a kernel of its own).
struct Ints {
  const void* p;
  int wide;         // 1: int64
  __device__ __forceinline__ int operator[](long long i) const {
    return wide ? (int)static_cast<const long long*>(p)[i]
                : static_cast<const int*>(p)[i];
  }
};

struct Args {
  const float* samples;
  Ints slab_layers;
  const float* obj_pos;
  const float* ref2;
  const uint8_t* obj_app;
  uint8_t* out;
  int E, L, NN, S;     // E = B * O * 2 entries
  int range;           // entries per block range
  int part_chunks;     // 32-edge chunks of a layer per block part
  int heavy;           // entries of a layer and range above which it gets help
};

// float2 between two edges in shared memory: odd
__host__ __device__ inline int pitch_of(int S) { return S | 1; }

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Zeros for the inactive entries among entries first .. last-1, by all
// threads of the block: a thread per aligned 16 bytes of the planes (out
// is 16-byte aligned), single bytes where 16 bytes straddle two entries
// of which one is active, or the ends of the range.
__device__ __forceinline__ void zero_inactive(const Args& a, int first,
                                              int last) {
  if (first >= last) return;
  const long long z0 = (long long)first * a.NN;
  const int len = (last - first) * a.NN;        // the launcher bounds it
  const int skew = (int)(z0 & 15);
  uint8_t* base = a.out + (z0 - skew);          // 16-byte aligned
  for (int c = 16 * threadIdx.x; c < skew + len; c += 16 * blockDim.x) {
    const int lo = max(c, skew), hi = min(c + 16, skew + len);
    const int e0 = first + (lo - skew) / a.NN;
    const int e1 = first + (hi - 1 - skew) / a.NN;
    if (hi - lo == 16 && e0 == e1) {
      if (!a.obj_app[e0 >> 1])
        *reinterpret_cast<uint4*>(base + c) = make_uint4(0, 0, 0, 0);
    } else {
      for (int i = lo; i < hi; ++i)
        if (!a.obj_app[(first + (i - skew) / a.NN) >> 1]) base[i] = 0;
    }
  }
}

// The samples of a layer's edges e_lo .. e_hi-1 into shared memory: edge e
// at (e - e_lo) * pitch float2.
__device__ __forceinline__ void stage_layer(const Args& a, int layer,
                                            int e_lo, int e_hi,
                                            float2* slab) {
  const float2* src = reinterpret_cast<const float2*>(a.samples)
                      + ((long long)layer * a.NN + e_lo) * a.S;
  const int pitch = pitch_of(a.S);
  // c / S for c < NN * S by one multiply (the launcher checks the range)
  const unsigned magic = (unsigned)(0x100000000ull / (unsigned)a.S + 1ull);
  for (int c = threadIdx.x; c < (e_hi - e_lo) * a.S; c += blockDim.x) {
    const int e = a.S == 1 ? c : (int)__umulhi((unsigned)c, magic);
    cp_async8(slab + e * pitch + (c - e * a.S), src + c);
  }
}

// 32 consecutive edges of one entry's plane (chunk * 32 ...), a lane each,
// from a layer's samples with pitch float2 between edges, the first of
// them edge e_lo's (staged, or where they lie in global memory).  Every
// lane of the warp calls it.  An entry that is not active gets its zeros.
__device__ __forceinline__ void hit_edges(const Args& a,
                                          const float2* __restrict__ slab,
                                          int e_lo, int pitch, const Match mt,
                                          int chunk, int lane,
                                          bool active = true) {
  const int e = chunk * 32 + lane;
  bool hit = false;
  if (e < a.NN && active) {
    const float2* p = slab + (long long)(e - e_lo) * pitch;
    float dmin = INFINITY;
    for (int s0 = 0; s0 < a.S; s0 += BATCH) {
      float2 v[BATCH];          // past the last sample: the last once more
#pragma unroll
      for (int u = 0; u < BATCH; ++u) v[u] = p[min(s0 + u, a.S - 1)];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const float dx = v[u].x - mt.ox, dy = v[u].y - mt.oy;
        dmin = fminf(dmin, dx * dx + dy * dy);
      }
    }
    hit = dmin <= mt.r2;
  }
  uint8_t* plane = a.out + (long long)mt.entry * a.NN;
  if ((a.NN & 3) == 0) {
    const unsigned bits = __ballot_sync(0xffffffffu, hit);
    const int e4 = chunk * 32 + 4 * lane;
    if (lane < 8 && e4 < a.NN) {
      const unsigned nib = bits >> (4 * lane);
      *reinterpret_cast<uint32_t*>(plane + e4) =
          (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14)
          | ((nib & 8u) << 21);
    }
  } else if (e < a.NN) {
    plane[e] = hit;
  }
}

// Which layer's entries a block computes, and which share of them.  A
// block counts the active entries of its range for every layer.  Where a
// layer has more than limit of them (a fleet that stands on few layers),
// the blocks of the layers that have none in this range help: the idle
// layers are dealt over the heavy ones in their order, and a heavy layer's
// entries are split between its own block (share 0) and its helpers by
// (object index) mod shares.  Every block of the range derives the same
// assignment from the same counts.  Called where some layer is heavy.
struct Role {
  int layer;        // the layer whose entries this block computes, or -1
  int share, shares;
};

__device__ __forceinline__ Role role_of(const int* hist, int* heavy, int L,
                                        int layer, int limit) {
  // warp 0: the heavy layers in order, and this layer's rank among the
  // heavy and among the idle ones
  __shared__ int n_heavy, n_idle, my_rank;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int nh = 0, ni = 0, rank = 0;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      const int h = l < L ? hist[l] : 1;
      const unsigned hv = __ballot_sync(0xffffffffu, h > limit);
      const unsigned id = __ballot_sync(0xffffffffu, h == 0);
      const unsigned below = (1u << lane) - 1;
      if (h > limit) heavy[nh + __popc(hv & below)] = l;
      if (l == layer) rank = h > limit ? nh + __popc(hv & below)
                                       : ni + __popc(id & below);
      nh += __popc(hv);
      ni += __popc(id);
    }
    rank = __shfl_sync(0xffffffffu, rank, layer & 31);  // from who met it
    if (lane == 0) {
      n_heavy = nh;
      n_idle = ni;
      my_rank = rank;
    }
  }
  __syncthreads();
  const int h = hist[layer], nh = n_heavy, ni = n_idle, r = my_rank;
  if (h > 0 && h <= limit) return Role{layer, 0, 1};
  if (h > limit)    // helpers: the idle ranks r, r + nh, ... below ni
    return Role{layer, 0, 1 + (ni > r ? (ni - r + nh - 1) / nh : 0)};
  const int j = r % nh;                     // idle: helps heavy layer j
  return Role{heavy[j], 1 + r / nh, 1 + (ni - j + nh - 1) / nh};
}

__global__ void __launch_bounds__(THREADS) hit_slab_kernel(Args a) {
  extern __shared__ __align__(16) Match list[];     // range matches, then
  float2* slab = reinterpret_cast<float2*>(list + a.range);   // the part,
  int* hist = reinterpret_cast<int*>(                // and 2 L counters
      slab + (size_t)a.part_chunks * 32 * pitch_of(a.S));
  int* heavy = hist + a.L;
  __shared__ int n_list;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_blocks = gridDim.x * gridDim.y * gridDim.z;
  const int g = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;

  if (tid == 0) n_list = 0;
  for (int l = tid; l < a.L; l += THREADS) hist[l] = 0;
  // this block's share of the zero planes
  const int per = (a.E + n_blocks - 1) / n_blocks;
  zero_inactive(a, min(a.E, g * per), min(a.E, (g + 1) * per));
  __syncthreads();

  // the active entries of the range by layer, those of this block's layer
  // with their object's position and radius
  const int lo = blockIdx.y * a.range;
  const int hi = min(a.E, lo + a.range);
  for (int i = lo + tid; i < hi; i += THREADS) {
    const int bo = i >> 1;
    int l = a.slab_layers[i];
    const bool app = a.obj_app[bo] != 0;
    l = l < 0 ? 0 : (l > a.L - 1 ? a.L - 1 : l);
    if (app) atomicAdd(&hist[l], 1);
    if (app && l == (int)blockIdx.x)
      list[atomicAdd(&n_list, 1)] =
          Match{i, a.obj_pos[2 * bo], a.obj_pos[2 * bo + 1], a.ref2[bo]};
  }
  __syncthreads();
  bool heavy_here = false;
  for (int l = tid; l < a.L; l += THREADS) heavy_here |= hist[l] > a.heavy;
  const Role role = __syncthreads_or(heavy_here)
                        ? role_of(hist, heavy, a.L, blockIdx.x, a.heavy)
                        : Role{n_list > 0 ? (int)blockIdx.x : -1, 0, 1};
  if (role.layer < 0) return;
  if (role.shares > 1) {        // a heavy layer: this block's share only
    if (tid == 0) n_list = 0;
    __syncthreads();
    for (int i = lo + tid; i < hi; i += THREADS) {
      const int bo = i >> 1;
      int l = a.slab_layers[i];
      l = l < 0 ? 0 : (l > a.L - 1 ? a.L - 1 : l);
      if (l == role.layer && a.obj_app[bo] && bo % role.shares == role.share)
        list[atomicAdd(&n_list, 1)] =
            Match{i, a.obj_pos[2 * bo], a.obj_pos[2 * bo + 1], a.ref2[bo]};
    }
    __syncthreads();
  }
  const int n = n_list;
  if (n == 0) return;

  // this block's part of the layer: chunks of 32 edges c_lo .. c_hi-1
  const int c_lo = blockIdx.z * a.part_chunks;
  const int c_hi = min((a.NN + 31) / 32, c_lo + a.part_chunks);
  const int n_ch = c_hi - c_lo;
  const int e_lo = c_lo * 32;
  stage_layer(a, role.layer, e_lo, min(a.NN, c_hi * 32), slab);
  cp_async_wait_all();
  __syncthreads();
  for (int it = warp; it < n * n_ch; it += THREADS / 32) {
    const int k = it / n_ch;
    hit_edges(a, slab, e_lo, pitch_of(a.S), list[k], c_lo + it - k * n_ch,
              lane);
  }
}

// The kernel of a call with few entries: a warp per (entry, 32 edges).
__global__ void __launch_bounds__(THREADS) hit_slab_small_kernel(Args a) {
  const int chunks = (a.NN + 31) / 32;
  const int item = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (item >= a.E * chunks) return;
  const int entry = item / chunks, bo = entry >> 1;
  int l = a.slab_layers[entry];
  l = l < 0 ? 0 : (l > a.L - 1 ? a.L - 1 : l);
  const Match mt{entry, a.obj_pos[2 * bo], a.obj_pos[2 * bo + 1], a.ref2[bo]};
  hit_edges(a, reinterpret_cast<const float2*>(a.samples)
                   + (long long)l * a.NN * a.S,
            0, a.S, mt, item - entry * chunks, threadIdx.x & 31,
            a.obj_app[bo] != 0);
}

// Returns 0, a CUDA error, or -1 for a shape the kernel's index arithmetic
// does not cover (or tensors that are not aligned: samples to 8 bytes, out
// to 16).  range: entries a block scans (<= MAX_RANGE); part_bytes: of a
// layer's samples, per block.
inline int launch(const float* samples, const void* slab_layers,
                  const float* obj_pos, const float* ref2,
                  const uint8_t* obj_app, uint8_t* out, int B, int O, int L,
                  int N, int S, int wide, int range, int part_bytes,
                  int heavy, cudaStream_t stream) {
  const long long E = (long long)B * O * 2;
  if (E == 0 || N == 0) return 0;
  if (L < 1 || S < 1 || S > 1024 || N > 4096 || range < 1
      || range > MAX_RANGE || E >= (1ll << 31))
    return -1;
  // parts of whole 32-edge chunks, about part_bytes of samples each
  const int chunks = (N * N + 31) / 32;
  const int chunk_bytes = 32 * pitch_of(S) * (int)sizeof(float2);
  const int part_chunks =
      part_bytes / chunk_bytes < 1 ? 1 : min(chunks, part_bytes / chunk_bytes);
  const int Q = (chunks + part_chunks - 1) / part_chunks;
  const long long P = (E + range - 1) / range;
  const long long shmem = (long long)range * sizeof(Match)
                          + (long long)part_chunks * chunk_bytes
                          + 2ll * L * sizeof(int);
  // a block's share of the planes, in bytes, is indexed by int
  const long long share = (E / (L * P * Q) + 1) * N * N;
  if ((reinterpret_cast<uintptr_t>(samples) & 7)
      || (reinterpret_cast<uintptr_t>(out) & 15) || share >= (1ll << 30)
      || P > 65535 || Q > 65535 || L * P * Q >= (1ll << 30)
      || shmem > 227 * 1024 - 16)
    return -1;
  const Args a{samples, Ints{slab_layers, wide}, obj_pos, ref2, obj_app, out,
               (int)E, L, N * N, S, range, part_chunks, heavy};
  if (E <= SMALL_E) {               // one car's objects: no layer is reused
    const int warps = THREADS / 32;
    hit_slab_small_kernel<<<(unsigned)((E * chunks + warps - 1) / warps),
                            THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        hit_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  hit_slab_kernel<<<dim3(L, (unsigned)P, Q), THREADS, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace hs

// wide: 1 if slab_layers is int64, 0 if int32.
extern "C" int hit_slab_launch(const float* samples, const void* slab_layers,
                               const float* obj_pos, const float* ref2,
                               const uint8_t* obj_app, uint8_t* out, int B,
                               int O, int L, int N, int S, int wide,
                               void* stream) {
  return hs::launch(samples, slab_layers, obj_pos, ref2, obj_app, out, B, O,
                    L, N, S, wide, hs::RANGE, hs::PART_BYTES, hs::HEAVY,
                    (cudaStream_t)stream);
}
