// Masked 4-slot min-plus window DP for the batched fleet tick and the
// interactive facade.
//
// Replaces the TPU kernel graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_window.py:_kernel (via fused_window_dp).  Semantics of the scan
// step of planner/pathgen.plan_window_kernel: per scenario and window step h
// the cost slab of layer (start_layer + h) mod L, blocked on an open track
// once start_layer + h >= L - 1; zone rows/cols (every slot); the one-edge
// w_last discount; object blocks (straight/left/right); the overtake splits
// at p_obs - 1 / p_obs (left/right); then for all 4 slots
// best'[m] = min_n best[n] + w[n, m] with the lowest n on ties, clamped to
// INF.  Slots: 0 straight, 1 follow, 2 left, 3 right.
//
// Bound on the H100: neither bytes nor operations (a few MB in, about
// 8 * N^2 flops per step and scenario).  The H steps are a chain: a step
// needs the frontier of the step before.  So the time of a launch is H
// times the latency of one step, and the design keeps everything that does
// not depend on the frontier out of that step.
//
//   * One block per scenario, two kinds of warps.  STAGES producer warps
//     build the masked slabs: warp p takes steps p, p + STAGES, ... and
//     writes the follow slab (zones, off-end, discount) and the default
//     slab (object blocks on top) of its step into its stage of a ring in
//     shared memory.  Global latency (the cost slab, the hit planes) is
//     theirs, several steps ahead of the chain.  Where N is a multiple of
//     4 a lane moves 4 edges at a time (16-byte loads and stores).
//   * The slab match is resolved once a step and warp, not once an edge: a
//     ballot over the 2*O slab layers gives the hit planes of the step's
//     layer, and only those are read (most steps have none).  Zone rows
//     of the H + 1 window layers are gathered once, in the prologue.
//   * The consumer warps relax.  Four lanes share a target node m and
//     split the sources n between them (n = q, q + 4, ...); each lane
//     carries all 4 slots, so one load of the two slabs and one 16-byte
//     load of the frontier (stored node-major, the 4 slots side by side)
//     serve 4 independent chains of N/4 compare-selects.  The four lanes
//     merge (value, n) lexicographically by two xor-shuffles: minima and
//     the single add are exact, so this gives the plain version's bits
//     with ties to the lowest n.  The split masks of slots 2 and 3 sit in
//     a second copy of the loop that only the two steps at the obstacle
//     run.  The slab rows are pitched so that the four lanes' rows fall on
//     different banks.
//   * One barrier a step on the chain: the named barrier on which the
//     consumers wait for the step's stage is also the one that orders the
//     double-buffered frontier between them.  Handing a stage back is a
//     bar.arrive, which does not wait.
//   * Frontier and backpointers leave by plain stores from the lane that
//     holds them, four 32-byte runs a warp and array.  Keeping the
//     (4, H+1, N) rows in shared memory until the end was measured and is
//     no faster, for 21.5 KB more shared memory a block at H=27, N=24.
//   * The index tensors are read as the caller has them, int32 or int64:
//     each conversion before the launch would be a kernel of its own.
//
// The TPU's sequential grid axis with its VMEM carry became the loop in
// the block; the bf16x3 select, the replicate dot, the power-of-two node
// padding and the step-major tables were TPU workarounds and are gone.
#include <cuda_runtime.h>
#include <stdint.h>

#define WDP_INF 1e30f
#define WDP_FEAS 1e29f

namespace wdp {

constexpr int STAGES = 4;       // producer warps, and stages of the ring
constexpr int BAR_FULL = 1;     // named barriers 1 .. STAGES: stage filled
constexpr int BAR_EMPTY = 1 + STAGES;   // the next STAGES: stage read

// An index tensor as the caller has it, int32 or int64.
struct Ints {
  const void* p;
  int wide;         // 1: int64
  __device__ __forceinline__ int operator[](long long i) const {
    return wide ? (int)static_cast<const long long*>(p)[i]
                : static_cast<const int*>(p)[i];
  }
};

struct Args {
  const float* w;
  const uint8_t* zone;
  long long zone_bstride;
  Ints start_layer;
  Ints start_node;
  Ints slab_layers;
  const uint8_t* hit_slab;
  Ints p_obs;
  const uint8_t* in_win;
  Ints obs_node;
  Ints last_nodes;
  const float* w_fac;
  float* best_out;
  int* bp_out;
  int L, N, O, H, n_last, closed;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// rows of a slab, padded to the 4 lanes that share a target node
__host__ __device__ inline int rows_of(int N) { return round_up(N, 4); }
// floats between two rows: N rounded up to 8 mod 16, so that rows n .. n+3
// of 8 neighbouring targets fall on 32 different banks
__host__ __device__ inline int pitch_of(int N) {
  return (N + 7) / 16 * 16 + 8;
}
__host__ __device__ inline int consumer_threads(int N) {
  return 4 * round_up(N, 8);
}

// The block's shared memory, carved in one place for kernel and launcher.
struct Smem {
  float4* front;    // 2 frontiers of rows_of(N) nodes, the 4 slots each
  float* ring;      // STAGES x {follow slab, default slab}
  float* w_fac;     // n_last - 1 discount factors
  int* slab;        // 2*O slab layers of this scenario
  int* last;        // n_last nodes of the last solution
  uint8_t* zone;    // (H + 1, N): zone rows of the window's layers
  int slab_floats;  // floats of one slab
  size_t bytes;

  __host__ __device__ Smem(float* base, int N, int O, int H, int n_last) {
    const int n4 = rows_of(N);
    slab_floats = n4 * pitch_of(N);
    front = reinterpret_cast<float4*>(base);
    ring = base + 2 * n4 * 4;
    w_fac = ring + (size_t)STAGES * 2 * slab_floats;
    slab = reinterpret_cast<int*>(w_fac + (n_last > 1 ? n_last - 1 : 0));
    last = slab + 2 * O;
    zone = reinterpret_cast<uint8_t*>(last + n_last);
    bytes = (size_t)(zone - reinterpret_cast<uint8_t*>(base))
            + (size_t)round_up((H + 1) * N, 16);
  }
  __device__ float* fol(int stage) const {
    return ring + (size_t)stage * 2 * slab_floats;
  }
  __device__ float* def(int stage) const { return fol(stage) + slab_floats; }
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// bar.arrive orders the thread's earlier shared-memory stores before the
// barrier's completion, as bar.sync does, and does not wait.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// x / d by one multiply, exact while x * d < 2^32
struct Div {
  unsigned d, magic;
  __device__ explicit Div(int d_)
      : d((unsigned)d_),
        magic((unsigned)(0x100000000ull / (unsigned)d_ + 1ull)) {}
  __device__ __forceinline__ int operator()(int x) const {
    return d == 1 ? x : (int)__umulhi((unsigned)x, magic);
  }
};

// What every thread of the block does before the roles part: the
// scenario's small tables into shared memory, both frontiers, the padding
// rows of every stage, row 0 of the outputs.  Ends with a __syncthreads().
__device__ __forceinline__ void prologue(const Args& a, const Smem& s,
                                         int b, int sl) {
  const int N = a.N, n4 = rows_of(N), pitch = pitch_of(N);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = tid; k < 2 * a.O; k += nt)
    s.slab[k] = a.slab_layers[(long long)b * 2 * a.O + k];
  for (int k = tid; k < a.n_last; k += nt)
    s.last[k] = a.last_nodes[(long long)b * a.n_last + k];
  for (int k = tid; k < a.n_last - 1; k += nt) s.w_fac[k] = a.w_fac[k];
  const uint8_t* zb = a.zone + a.zone_bstride * b;
  for (int i = tid; i < (a.H + 1) * N; i += nt) {
    const int hh = i / N;
    s.zone[i] = zb[(long long)((sl + hh) % a.L) * N + (i - hh * N)];
  }
  const int sn = a.start_node[b];
  float* f = reinterpret_cast<float*>(s.front);
  for (int i = tid; i < n4 * 4; i += nt) {
    const int n = i >> 2;
    f[i] = (n == sn) ? 0.0f : WDP_INF;      // start_node < N: pads stay INF
    f[n4 * 4 + i] = WDP_INF;
  }
  // rows N .. n4-1 of every slab: sources that do not exist
  const int pad = (n4 - N) * pitch;
  for (int i = tid; i < STAGES * 2 * pad; i += nt)
    s.ring[(size_t)(i / pad) * s.slab_floats + N * pitch + i % pad] = WDP_INF;
  const long long out_base = (long long)b * 4 * (a.H + 1) * N;
  for (int i = tid; i < 4 * N; i += nt) {
    const int sidx = i / N, m = i - sidx * N;
    const long long o = out_base + (long long)sidx * (a.H + 1) * N + m;
    a.best_out[o] = (m == sn) ? 0.0f : WDP_INF;
    a.bp_out[o] = -1;
  }
  __syncthreads();
}

// How a producer walks a layer's edges.  Set up once a warp: the divider's
// magic number is a 64-bit division, dozens of dependent instructions.
struct Edges {
  bool quads;       // 4 edges a lane: rows, planes and the table aligned
  Div row_of;       // row of an edge, or of a quad of edges
  __device__ explicit Edges(const Args& a)
      : quads((a.N & 3) == 0
              && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0
              && (reinterpret_cast<uintptr_t>(a.hit_slab) & 3) == 0),
        row_of(quads ? a.N >> 2 : a.N) {}
};

// One warp builds the masked slabs of window step h into fol and def.
__device__ __forceinline__ void produce_step(const Args& a, const Smem& s,
                                             const Edges& eg, int b, int sl,
                                             int h, float* __restrict__ fol,
                                             float* __restrict__ def,
                                             int lane) {
  const int N = a.N, NN = N * N, pitch = pitch_of(N);
  const int layer = (sl + h) % a.L;
  const bool off_end = !a.closed && (sl + h >= a.L - 1);
  const uint8_t* zrow = s.zone + h * N;     // the step's layer
  const uint8_t* zcol = zrow + N;           // the layer after it
  const float* wl = a.w + (long long)layer * NN;
  const uint8_t* hit = a.hit_slab + (long long)b * 2 * a.O * NN;
  const bool quads = eg.quads;
  const Div row_of = eg.row_of;

  if (quads) {
    constexpr int U = 5;                    // 16-byte loads in flight a lane
    for (int j0 = lane; j0 < (NN >> 2); j0 += 32 * U) {
      float4 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        wv[u] = (j < (NN >> 2) && !off_end)
                    ? __ldg(reinterpret_cast<const float4*>(wl) + j)
                    : make_float4(WDP_INF, WDP_INF, WDP_INF, WDP_INF);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + 32 * u;
        if (j < (NN >> 2)) {
          const int n = row_of(j), m = 4 * j - n * N;
          const unsigned zc = *reinterpret_cast<const uint32_t*>(zcol + m);
          float4 v = wv[u];
          if (zrow[n]) {
            v = make_float4(WDP_INF, WDP_INF, WDP_INF, WDP_INF);
          } else {
            if (zc & 0x000000ffu) v.x = WDP_INF;
            if (zc & 0x0000ff00u) v.y = WDP_INF;
            if (zc & 0x00ff0000u) v.z = WDP_INF;
            if (zc & 0xff000000u) v.w = WDP_INF;
          }
          *reinterpret_cast<float4*>(fol + n * pitch + m) = v;
          *reinterpret_cast<float4*>(def + n * pitch + m) = v;
        }
      }
    }
  } else {
    constexpr int U = 6;                    // cost loads in flight a lane
    for (int e0 = lane; e0 < NN; e0 += 32 * U) {
      float wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + 32 * u;
        wv[u] = (e < NN && !off_end) ? __ldg(wl + e) : WDP_INF;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + 32 * u;
        if (e < NN) {
          const int n = row_of(e), m = e - n * N;
          const float v = (zrow[n] | zcol[m]) ? WDP_INF : wv[u];
          fol[n * pitch + m] = v;
          def[n * pitch + m] = v;
        }
      }
    }
  }
  // object blocks: only the hit planes whose slab layer is this layer
  for (int k0 = 0; k0 < 2 * a.O; k0 += 32) {
    const int k = k0 + lane;
    unsigned bits = __ballot_sync(0xffffffffu,
                                  k < 2 * a.O && s.slab[k] == layer);
    while (bits) {
      const int kk = k0 + __ffs(bits) - 1;
      bits &= bits - 1;
      const uint8_t* plane = hit + (long long)kk * NN;
      if (quads) {
#pragma unroll 5
        for (int j = lane; j < (NN >> 2); j += 32) {
          const unsigned word =
              __ldg(reinterpret_cast<const uint32_t*>(plane) + j);
          if (word) {
            const int n = row_of(j), m = 4 * j - n * N;
            float* d = def + n * pitch + m;
            if (word & 0x000000ffu) d[0] = WDP_INF;
            if (word & 0x0000ff00u) d[1] = WDP_INF;
            if (word & 0x00ff0000u) d[2] = WDP_INF;
            if (word & 0xff000000u) d[3] = WDP_INF;
          }
        }
      } else {
#pragma unroll 6
        for (int e = lane; e < NN; e += 32) {
          if (__ldg(plane + e)) {
            const int n = row_of(e), m = e - n * N;
            def[n * pitch + m] = WDP_INF;
          }
        }
      }
    }
  }
  __syncwarp();
  // the discount on the last solution's edge of this step: one edge
  if (lane == 0 && h < a.n_last - 1) {
    const int na = s.last[h], nb = s.last[h + 1];
    if (na >= 0 && nb >= 0 && na < N && nb < N) {
      const int i = na * pitch + nb;
      float v = fol[i];
      if (v < WDP_FEAS) {
        v = v * s.w_fac[h];
        fol[i] = v;
        if (def[i] < WDP_FEAS) def[i] = v;   // not blocked: the same edge
      }
    }
  }
}

// The producer warp pw: its steps into its stage, a stage taken back only
// after every consumer has arrived at its "read" barrier.
__device__ __forceinline__ void producer_loop(const Args& a, const Smem& s,
                                              int b, int sl, int pw,
                                              int lane, int n_cons) {
  const Edges eg(a);
  for (int h = pw; h < a.H; h += STAGES) {
    if (h >= STAGES) bar_sync(BAR_EMPTY + pw, n_cons + 32);
    produce_step(a, s, eg, b, sl, h, s.fol(pw), s.def(pw), lane);
    bar_arrive(BAR_FULL + pw, n_cons + 32);
  }
}

// The sources n = q, q + 4, ... of target m, all 4 slots.  SPLIT adds the
// overtake masks of slots 2 (left) and 3 (right).  NC: the node count where
// the caller knows it at compile time (the loop unrolls, its offsets become
// immediates), else 0.
template <bool SPLIT, int NC>
__device__ __forceinline__ void relax_sources(
    const float* __restrict__ fol, const float* __restrict__ def,
    const float4* __restrict__ front, int N, int mc, int q,
    bool into_l, bool into_r, bool outof, int obs, float (&v)[4],
    int (&ix)[4]) {
  const int n4 = NC ? rows_of(NC) : rows_of(N);
  const int pitch = NC ? pitch_of(NC) : pitch_of(N);
#pragma unroll(NC ? 8 : 3)
  for (int n = q; n < n4; n += 4) {
    const float wf = fol[n * pitch + mc];
    const float wd = def[n * pitch + mc];
    const float4 f = front[n];
    float wl = wd, wr = wd;
    if (SPLIT) {
      if (into_l || (outof && n >= obs)) wl = WDP_INF;
      if (into_r || (outof && n < obs)) wr = WDP_INF;
    }
    const float t0 = f.x + wd, t1 = f.y + wf, t2 = f.z + wl, t3 = f.w + wr;
    if (t0 < v[0]) { v[0] = t0; ix[0] = n; }
    if (t1 < v[1]) { v[1] = t1; ix[1] = n; }
    if (t2 < v[2]) { v[2] = t2; ix[2] = n; }
    if (t3 < v[3]) { v[3] = t3; ix[3] = n; }
  }
}

// (v, i) <- the lexicographically smaller of (v, i) and the partner lane's
// (sv, si): the smaller value, on a tie the lower source
__device__ __forceinline__ void merge_with(float& v, int& i, float sv, int si,
                                           int off) {
  const float ov = __shfl_xor_sync(0xffffffffu, sv, off);
  const int oi = __shfl_xor_sync(0xffffffffu, si, off);
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// The slot whose result relax_step leaves in lane q of a target's 4 lanes.
__device__ __forceinline__ int slot_of_lane(int q) {
  return ((q & 1) << 1) | (q >> 1);
}

// One relax step of a consumer thread (target m = ctid / 4, sources
// n = ctid % 4 mod 4): leaves the new frontier value (clamped) and the
// backpointer of target m and slot slot_of_lane(q).  The 4 lanes halve
// what they carry with each exchange: after the first, a lane holds 2
// slots over 2 lanes' sources, after the second, 1 slot over all.
template <int NC = 0>
__device__ __forceinline__ void relax_step(
    const float* __restrict__ fol, const float* __restrict__ def,
    const float4* __restrict__ front, int N, int m, int q, bool into,
    bool outof, int obs, float& val, int& idx) {
  const int mc = m < N ? m : N - 1;         // idle lanes read a real column
  float v[4] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000),
                __int_as_float(0x7f800000), __int_as_float(0x7f800000)};
  int ix[4] = {0, 0, 0, 0};
  if (into || outof)
    relax_sources<true, 0>(fol, def, front, N, mc, q, into && m >= obs,
                           into && m < obs, outof, obs, v, ix);
  else
    relax_sources<false, NC>(fol, def, front, N, mc, q, false, false, false,
                             obs, v, ix);
  const bool odd = q & 1, high = q & 2;
  // even lanes go on with slots 0 and 1, odd lanes with 2 and 3
  float va = odd ? v[2] : v[0], vb = odd ? v[3] : v[1];
  int ia = odd ? ix[2] : ix[0], ib = odd ? ix[3] : ix[1];
  merge_with(va, ia, odd ? v[0] : v[2], odd ? ix[0] : ix[2], 1);
  merge_with(vb, ib, odd ? v[1] : v[3], odd ? ix[1] : ix[3], 1);
  // lanes 0 and 1 go on with the first of their two, lanes 2 and 3 with
  // the second
  val = high ? vb : va;
  idx = high ? ib : ia;
  merge_with(val, idx, high ? va : vb, high ? ia : ib, 2);
  val = fminf(val, WDP_INF);
}

}  // namespace wdp

__global__ void window_dp_kernel(wdp::Args a) {
  using namespace wdp;
  extern __shared__ __align__(16) float smem[];
  const Smem s(smem, a.N, a.O, a.H, a.n_last);
  const int N = a.N, H = a.H, n4 = rows_of(N);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_cons = consumer_threads(N);
  const int sl = a.start_layer[b];
  prologue(a, s, b, sl);

  if (tid >= n_cons) {
    producer_loop(a, s, b, sl, (tid - n_cons) >> 5, lane, n_cons);
    return;
  }
  const int m = tid >> 2, q = tid & 3, slot = slot_of_lane(q);
  const int obs = a.obs_node[b], po = a.p_obs[b];
  const bool iw = a.in_win[b] != 0;
  float* front = reinterpret_cast<float*>(s.front);
  // element (slot, h + 1, m) of the scenario's outputs
  const long long out0 = ((long long)b * 4 + slot) * (H + 1) * N + m;
  int stage = 0;
  for (int h = 0; h < H; ++h) {
    bar_sync(BAR_FULL + stage, n_cons + 32);
    float val;
    int idx;
    const bool into = iw && h == po - 1, outof = iw && h == po;
    const float4* fr = s.front + (h & 1) * n4;
    if (N == 24)            // the planner's lattices: 24 and 32 nodes a layer
      relax_step<24>(s.fol(stage), s.def(stage), fr, N, m, q, into, outof,
                     obs, val, idx);
    else if (N == 32)
      relax_step<32>(s.fol(stage), s.def(stage), fr, N, m, q, into, outof,
                     obs, val, idx);
    else
      relax_step(s.fol(stage), s.def(stage), fr, N, m, q, into, outof, obs,
                 val, idx);
    if (h + STAGES < H) bar_arrive(BAR_EMPTY + stage, n_cons + 32);
    if (m < N) {
      front[((h + 1) & 1) * n4 * 4 + m * 4 + slot] = val;
      a.best_out[out0 + (long long)(h + 1) * N] = val;
      a.bp_out[out0 + (long long)(h + 1) * N] = idx;
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
}

namespace wdp {

// Shared memory of one block.
inline size_t smem_bytes(int N, int O, int H, int n_last) {
  return Smem(nullptr, N, O, H, n_last).bytes;
}

}  // namespace wdp

namespace wdp {

// wide: bit i set if the i-th index tensor (start_layer, start_node,
// slab_layers, p_obs, obs_node, last_nodes) is int64, else int32.
inline Args make_args(const float* w, const uint8_t* zone,
                      long long zone_bstride, const void* start_layer,
                      const void* start_node, const void* slab_layers,
                      const uint8_t* hit_slab, const void* p_obs,
                      const uint8_t* in_win, const void* obs_node,
                      const void* last_nodes, const float* w_fac,
                      float* best_out, int* bp_out, int L, int N, int O,
                      int H, int n_last, int closed, int wide) {
  return Args{w, zone, zone_bstride,
              Ints{start_layer, wide & 1}, Ints{start_node, (wide >> 1) & 1},
              Ints{slab_layers, (wide >> 2) & 1}, hit_slab,
              Ints{p_obs, (wide >> 3) & 1}, in_win,
              Ints{obs_node, (wide >> 4) & 1},
              Ints{last_nodes, (wide >> 5) & 1}, w_fac, best_out, bp_out,
              L, N, O, H, n_last, closed};
}

}  // namespace wdp

// Returns 0, a CUDA error, or -1 for a shape that needs more threads or
// shared memory than a block has.
extern "C" int window_dp_launch(
    const float* w, const uint8_t* zone, long long zone_bstride,
    const void* start_layer, const void* start_node, const void* slab_layers,
    const uint8_t* hit_slab, const void* p_obs, const uint8_t* in_win,
    const void* obs_node, const void* last_nodes, const float* w_fac,
    float* best_out, int* bp_out, int B, int L, int N, int O, int H,
    int n_last, int closed, int wide, void* stream) {
  if (B == 0) return 0;
  const wdp::Args a = wdp::make_args(
      w, zone, zone_bstride, start_layer, start_node, slab_layers, hit_slab,
      p_obs, in_win, obs_node, last_nodes, w_fac, best_out, bp_out, L, N, O,
      H, n_last, closed, wide);
  const int threads = wdp::consumer_threads(N) + 32 * wdp::STAGES;
  const size_t shmem = wdp::smem_bytes(N, O, H, n_last);
  if (threads > 1024 || shmem > 227 * 1024 || N >= 1600) return -1;
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  window_dp_kernel<<<B, threads, shmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
