// Backpointer walk for the batched fleet tick, the interactive facade and
// the dense-window search.
//
// Replaces the TPU kernel graphbasedlocaltrajectoryplanner_tpu/ops/
// pallas_backtrace.py:_kernel (via _walk_flat / make_backtrace_walk).
// Semantics of ops/search.backtrace, per row: node[h_eff] = goal,
// node[h] = bp[min(h+1, H)][max(node[h+1], 0)] below it, -1 above it.
// Optionally per row a slot: bp is then the unselected (R0, S, H+1, N)
// table of the window DP and row r walks bp[r / k, slot[r]], k = R / R0,
// so that no caller copies the chosen slots' tables out first.
//
// Bound on the H100: neither bytes nor operations (4 bytes and one compare
// a walked layer), but the chain: each step needs the node of the step
// above.  Walked through L2, a step is one dependent global load (0.3 to
// 0.6 us), so the first design, one thread a row, took H of them.  This
// one takes the row's whole (H+1, N) table on chip in one step, then walks
// it there: a warp per row copies the layers the walk reads
// (1 .. min(h_eff, H)) into shared memory by cp.async, every copy in
// flight at once, and every lane then walks them with broadcast reads;
// lane h % 32 stores node[h].  Four rows a block (fewer where four tables
// do not fit), so that the fleet's 4,096 rows fill every SM in one wave.
// The index tensors (goal, h_eff, slot) are read as the caller has them,
// int32 or int64: each conversion before the launch would be a kernel of
// its own.
//
// The TPU's one-hot select-reduce over the N sublanes (it had no gather)
// and its rows-on-lanes transpose are gone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace bt {

constexpr int WARPS = 4;        // rows a block

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
  const int* bp;
  Ints goal, h_eff, slot;   // slot.p null: no slot form
  int* nodes;
  int R, Hp1, N;
  int S, k;                 // slots a table row, rows a table row
};

// The row's (H+1, N) table.
__device__ __forceinline__ const int* row_table(const Args& a, int r) {
  const long long t = (long long)(r / a.k) * a.S + (a.slot.p ? a.slot[r] : 0);
  return a.bp + t * a.Hp1 * a.N;
}

// Steps: step h (0 <= h < hi = min(he, H + 1)) takes node[h] from
// node[h + 1] through layer min(h + 1, H) of the table; node[he] = goal,
// and every node above he is -1.

// node[h] of the row's output, from what the walk left there.
__device__ __forceinline__ int node_at(int h, int hi, int he, int g,
                                       int walked) {
  return h < hi ? walked : (h == he ? g : -1);
}

// The layers the walk reads (1 .. min(he, H), or layer 0 alone for H = 0)
// into the warp's Hp1 * N ints of shared memory at the same offsets: every
// lane issues its 4-byte cp.async copies, none waits for another, then
// the warp waits for all of them.
__device__ __forceinline__ void load_smem(int* tbl, const int* b, int Hp1,
                                          int N, int he, int lane) {
  const int top = min(he, Hp1 - 1);
  const int low = Hp1 > 1 ? 1 : 0;
  for (int i = low * N + lane; i < (top + 1) * N; i += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(tbl + i)),
                 "l"(b + i)
                 : "memory");
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
}

// The walk over the staged table, by every lane with broadcast reads, from
// node g down through steps hi - 1 .. 0; lane h % 32 stores node[h] to out
// (if out is not null; the nodes from hi up are stored by the caller).
// Leaves the last carried node in carry.
__device__ __forceinline__ void walk_smem(const int* tbl, int Hp1, int N,
                                          int hi, int g, int lane, int* out,
                                          int& carry) {
  carry = g;
  for (int h = hi - 1; h >= 0; --h) {
    carry = tbl[min(h + 1, Hp1 - 1) * N + max(carry, 0)];
    if (out && lane == (h & 31)) out[h] = carry;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
    walk_kernel(Args a, int warps) {
  extern __shared__ int tbl_all[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * warps + warp;
  if (r >= a.R) return;
  int* tbl = tbl_all + (long long)warp * a.Hp1 * a.N;
  const int he = a.h_eff[r];
  const int g = a.goal[r];
  const int hi = min(he, a.Hp1);
  int* out = a.nodes + (long long)r * a.Hp1;
  load_smem(tbl, row_table(a, r), a.Hp1, a.N, he, lane);
  for (int h = max(hi, 0) + lane; h < a.Hp1; h += 32)
    out[h] = node_at(h, hi, he, g, 0);
  int carry;
  walk_smem(tbl, a.Hp1, a.N, hi, g, lane, out, carry);
}

// Rows a block for a table of Hp1 x N, and the block's bytes of shared
// memory (0 rows: not even one table fits).
inline int block_rows(int Hp1, int N, size_t* bytes) {
  const size_t per_warp = (size_t)Hp1 * N * sizeof(int);
  const size_t limit = 227 * 1024;
  int warps = WARPS;
  while (warps > 1 && warps * per_warp > limit) --warps;
  *bytes = warps * per_warp;
  return *bytes <= limit ? warps : 0;
}

// Let a kernel take up to 227 KB of shared memory.  Once a kernel, at its
// first launch.
template <typename K>
inline int allow_smem(K kernel, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  *done = err == cudaSuccess;
  return (int)err;
}

// (static: the flag below is this library's own; a function-local static
// of an inline function is one object for every library in the process)
static int launch(const Args& a, cudaStream_t stream) {
  if (a.R == 0) return 0;
  size_t bytes;
  const int warps = block_rows(a.Hp1, a.N, &bytes);
  if (warps == 0) return -1;
  static bool ready = false;
  const int err = allow_smem(walk_kernel, &ready);
  if (err) return err;
  walk_kernel<<<(a.R + warps - 1) / warps, warps * 32, bytes, stream>>>(
      a, warps);
  return (int)cudaGetLastError();
}

}  // namespace bt

// goal, h_eff, slot: int32 or int64 by bits 0, 1, 2 of wide; slot null for
// rows that each have their own (R, H+1, N) table (then S = k = 1).
extern "C" int backtrace_launch(const int* bp, const void* goal,
                                const void* h_eff, const void* slot,
                                int* nodes, int R, int Hp1, int N, int S,
                                int k, int wide, void* stream) {
  const bt::Args a{bp, bt::Ints{goal, wide & 1},
                   bt::Ints{h_eff, (wide >> 1) & 1},
                   bt::Ints{slot, (wide >> 2) & 1}, nodes, R, Hp1, N, S, k};
  return bt::launch(a, (cudaStream_t)stream);
}
