// Slots to runs, for Hopper (sm_90a): each slot's covering run id, for runs
// laid out from exclusive-prefix starts.  The pairs stage calls it twice a
// frame: chunk slot -> Gaussian and aligned block -> tile.
//
// Replaces no Pallas kernel: the JAX package writes it with XLA ops
// (gaussiansplatting_tpu/ops/pairs.py _run_ids: a scatter-max of run ids at
// the live runs' starts, then lax.cummax), and the port ran the same two as
// torch ops until this file: a scatter_reduce into an int64 seed, then
// torch.cummax, whose with-indices scan runs one row of millions of slots on
// a sliver of one SM (~0.36 G slots/s, 42 ms at 14.7M slots).  Python
// wrapper and plain PyTorch version: gaussiansplatting_tpu_torch/ops/runs.py
// (the contract is documented there).
//
// Two kernels and a memset, all on the caller's stream:
//   memset   the result and the per-tile maxima to -1 (0xFF bytes);
//   seed     one thread per run: a live run whose start lies in [0, S)
//            writes its id at its start by atomicMax (the amax of JAX's
//            .at[dst].max(..., mode="drop"), which holds even if two live
//            runs shared a start), and the tile of kTile slots that holds
//            the start takes the id by atomicMax too, gathered per CUDA
//            block first: a warp's highest lane of each tile (the largest
//            id: ids are thread indices) into a table in shared memory of
//            the kSpan tiles from the block's first, then one atomic per
//            tile a block touches.  Runs of the same tile arrive together
//            from every resident warp, so an atomic per warp and tile left
//            ~30 tiles taking a few hundred each at once: 0.20 ms of
//            serialized atomics at 5.8M runs, 0.047 ms with the table;
//   scan     one CUDA block per tile of kTile slots: the carry into the tile
//            is the maximum of the earlier tiles' maxima (a block reads at
//            most S / kTile ints of them), then an inclusive max-scan of the
//            tile in registers (int4 loads, warp shuffles, one pass through
//            shared memory for the (vector, warp) maxima), written in place.
// Every value is an int32 run id or -1, and max over integers is exact and
// idempotent: the result is the same bits in any launch order, and the
// atomics only ever meet equal or ordered values.
//
// What bounds it on the H100: HBM.  S slots are written by the memset, read
// and written by the scan (12 bytes a slot), and each run's start and flag
// are read once (5 bytes a run): at garden_mip360's 14.7M slots and 5.8M
// runs a frame ~206 MB, 61 us at 3.35 TB/s.  The scan's block keeps kVecs
// int4 loads in flight a thread before any is used (35 us at 14.7M slots),
// and the tiles are small enough (8,192 slots) that the 380k-slot frame
// still spreads over ~47 blocks.  Measured in a CUDA graph: a frame's two
// calls take 0.013 / 0.023 / 0.100 ms at 380k / 1.64M / 14.7M slots; at the
// largest the memset takes 0.019, the seed 0.047 (its writes land one
// start a sector or so apart) and the scan 0.035.
//
// No kernel name here may hold "blend_fwd_win" or "blend_bwd_win": the
// benchmark's blend rooflines match those substrings.

#include <cuda_runtime.h>

namespace {

constexpr int kSeedThreads = 1024;
constexpr int kSpan = 8;                          // tiles of a seed block's table
constexpr int kThreads = 256;                     // scan block
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;                          // int4 a thread
constexpr int kLogTile = 13;
constexpr int kTile = 1 << kLogTile;              // slots a scan block
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kTile == kThreads * 4 * kVecs, "a tile is every thread's vectors");
static_assert(kVecs * kWarps == 64, "warp 0 scans the (vector, warp) maxima two a lane");

__global__ void __launch_bounds__(kSeedThreads)
run_ids_seed_kernel(const int* __restrict__ starts, const unsigned char* __restrict__ live,
                    int n_runs, int num_slots, int* __restrict__ out,
                    int* __restrict__ tile_max) {
  __shared__ int table[kSpan];  // the block's maxima of tiles first .. first + kSpan - 1
  __shared__ int first;
  const int i = blockIdx.x * kSeedThreads + threadIdx.x;
  int start = -1;  // runs that are dead or start outside [0, S) drop
  if (i < n_runs && live[i]) {
    const int s = starts[i];
    if (s >= 0 && s < num_slots) start = s;
  }
  if (start >= 0) atomicMax(out + start, i);
  const int key = start >= 0 ? start >> kLogTile : -1;
  if (threadIdx.x < kSpan) table[threadIdx.x] = -1;
  if (threadIdx.x == 0) first = 0x7fffffff;
  __syncthreads();
  const unsigned peers = __match_any_sync(kFullMask, key);
  const bool leader = key >= 0 && (threadIdx.x & 31) == 31 - __clz(peers);
  if (leader) atomicMin(&first, key);
  __syncthreads();
  const int lo = first;
  if (leader) {
    if (key - lo < kSpan)
      atomicMax(table + (key - lo), i);
    else
      atomicMax(tile_max + key, i);
  }
  __syncthreads();
  if (threadIdx.x < kSpan && table[threadIdx.x] >= 0)
    atomicMax(tile_max + lo + threadIdx.x, table[threadIdx.x]);
}

__device__ __forceinline__ int4 load_slots(const int* __restrict__ p, int idx, int n) {
  if (idx + 3 < n) return *reinterpret_cast<const int4*>(p + idx);
  int4 v = make_int4(-1, -1, -1, -1);  // -1 is max's identity here
  if (idx < n) v.x = p[idx];
  if (idx + 1 < n) v.y = p[idx + 1];
  if (idx + 2 < n) v.z = p[idx + 2];
  return v;
}

__device__ __forceinline__ void store_slots(int* __restrict__ p, int idx, int n, int4 v) {
  if (idx + 3 < n) {
    *reinterpret_cast<int4*>(p + idx) = v;
    return;
  }
  if (idx < n) p[idx] = v.x;
  if (idx + 1 < n) p[idx + 1] = v.y;
  if (idx + 2 < n) p[idx + 2] = v.z;
}

// Slots of a tile in order: vector k of thread t holds slots
// (k * kThreads + t) * 4 .. + 3, so vector k of warp w precedes vector k of
// warp w + 1, and vector k + 1 of warp 0 follows vector k of the last warp.
__global__ void __launch_bounds__(kThreads)
run_ids_scan_kernel(int* __restrict__ out, const int* __restrict__ tile_max, int num_slots) {
  __shared__ int part[kVecs * kWarps];   // each (vector, warp)'s maximum, in slot order
  __shared__ int before[kVecs * kWarps]; // the maximum over every earlier slot
  __shared__ int carry[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kTile;

  int4 v[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    v[k] = load_slots(out, base + (k * kThreads + (int)threadIdx.x) * 4, num_slots);

  // the carry into the tile: the earlier tiles' maxima
  int c = -1;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += kThreads) c = max(c, tile_max[j]);
  c = __reduce_max_sync(kFullMask, c);
  if (lane == 0) carry[warp] = c;

  int excl[kVecs];  // the maximum of the warp's earlier lanes in vector k
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    v[k].y = max(v[k].y, v[k].x);
    v[k].z = max(v[k].z, v[k].y);
    v[k].w = max(v[k].w, v[k].z);
    int x = v[k].w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, x, d);
      if (lane >= d) x = max(x, y);
    }
    const int e = __shfl_up_sync(kFullMask, x, 1);
    excl[k] = lane == 0 ? -1 : e;
    if (lane == 31) part[k * kWarps + warp] = x;
  }
  __syncthreads();

  if (warp == 0) {
    const int a = part[2 * lane], b = part[2 * lane + 1];
    int x = max(a, b);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullMask, x, d);
      if (lane >= d) x = max(x, y);
    }
    const int tile_carry = __reduce_max_sync(kFullMask, lane < kWarps ? carry[lane] : -1);
    const int e = __shfl_up_sync(kFullMask, x, 1);
    const int first = lane == 0 ? tile_carry : max(tile_carry, e);
    before[2 * lane] = first;
    before[2 * lane + 1] = max(first, a);
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int pre = max(before[k * kWarps + warp], excl[k]);
    int4 r = v[k];
    r.x = max(r.x, pre);
    r.y = max(r.y, pre);
    r.z = max(r.z, pre);
    r.w = max(r.w, pre);
    store_slots(out, base + (k * kThreads + (int)threadIdx.x) * 4, num_slots, r);
  }
}

int num_tiles(int num_slots) { return (num_slots + kTile - 1) / kTile; }

}  // namespace

// Ints of workspace gs_run_ids needs after the result: the tiles' maxima.
extern "C" int gs_run_ids_workspace(int num_slots) {
  return num_slots > 0 ? num_tiles(num_slots) : 0;
}

// out [num_slots + gs_run_ids_workspace(num_slots)] int32: the first
// num_slots receive each slot's run id (-1 before the first live run), the
// rest is the tiles' maxima.  starts [n_runs] int32, live [n_runs] bool.
extern "C" int gs_run_ids(const int* starts, const unsigned char* live, int n_runs,
                          int num_slots, int* out, void* stream) {
  if (num_slots <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = num_tiles(num_slots);
  int* tile_max = out + num_slots;
  cudaError_t err = cudaMemsetAsync(out, 0xff, sizeof(int) * ((size_t)num_slots + tiles), s);
  if (err != cudaSuccess) return (int)err;
  if (n_runs > 0)
    run_ids_seed_kernel<<<(n_runs + kSeedThreads - 1) / kSeedThreads, kSeedThreads, 0, s>>>(
        starts, live, n_runs, num_slots, out, tile_max);
  run_ids_scan_kernel<<<tiles, kThreads, 0, s>>>(out, tile_max, num_slots);
  return (int)cudaGetLastError();
}
