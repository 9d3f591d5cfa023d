// Connected-component heatmap decode (kernel K2) for Hopper: one
// thread-block cluster per heatmap, all propagation state in shared memory.
//
// Replaces: padel_analytics_tpu/ops/pallas_cc.py::decode_heatmaps_pallas
// (`_make_kernel`; the same function as the jnp rollprop decode,
// ops/heatmap.py::_decode_single_rollprop): threshold, then num_iters
// synchronous rounds of 3x3 min/max propagation of each mask pixel's
// component extrema (min/max row and column, raster-first index), then the
// largest-area box, ties to the largest first index, and its centre.
//
// What bounds it on the H100: not bytes (one fp32 read per pixel) but the
// latency of num_iters dependent rounds over every mask pixel. The TPU kernel
// keeps five int32 maps of the whole heatmap (2.95 MB at 288x512) in VMEM,
// which one SM's 227 KB cannot hold. One block per heatmap over global
// scratch used 8 of the 132 SMs at batch 8 and re-read 45 words per mask
// pixel through L2 in every round.
//
// Design:
// 1. One cluster of CLUSTER blocks (8 or 16) per heatmap, grid (CLUSTER, B).
//    Rank r owns the band of rows [r * R, r * R + R), R = rows_per_block;
//    the last bands may be short or empty, and every block takes part in
//    every cluster barrier.
// 2. The band's state lives in shared memory for all rounds: a pixel's five
//    fields packed into one 64-bit word, mr | mc | xr | xc | fp from the low
//    bit, with bit_length(H) bits per row field, bit_length(W) per column
//    field and bit_length(H * W) for the first index (56 bits at 288x512),
//    plus a uint16 list of the band's mask pixels: 10 B/px, 184 KB a block
//    at cluster 8, 92 KB at cluster 16. A non-mask pixel holds the identity
//    word (min fields all ones, max fields 0; a mask pixel's own maxima are
//    >= 0 and it lies in its own 3x3), so a neighbour outside the mask needs
//    no test. Fields are seeded with GLOBAL coordinates. The heatmap is read
//    once, coalesced; there is no global scratch.
// 3. A round: the threads take the listed mask pixels in turn (by pixel, a
//    tall component would fall on the few threads owning its columns) and
//    compute their new words from the current state into registers;
//    interior rows use shared loads, a band's edge rows read the neighbour
//    band's row in place through distributed shared memory (no halo copy).
//    Cluster barrier, write phase, cluster barrier. The rounds stay
//    synchronous (Jacobi): an in-place update would propagate further per
//    round and change the result for components wider than num_iters. A warp
//    that changed a word ORs a flag in rank 0's shared memory; the flags
//    alternate between rounds so that a reset cannot race a read. A round
//    that changed nothing is the fixed point: the whole cluster stops there,
//    which leaves the result as it is.
// 4. The pick: warp max-reductions, then DSMEM atomicMax into rank 0, in
//    three stages (largest area; largest first index among those; each
//    winner field's max, as the reference takes them), each closed by a
//    cluster barrier. The third barrier is also the one every block passes
//    before it exits: after it no block reads another's shared memory. Rank 0
//    writes (cx, cy, vis); an empty mask gives (0, 0, 0).
// The rounds are latency bound (dependent shared loads and min/max chains),
// so a block runs 1024 threads at <= 64 registers, each keeping the new
// words of up to PPT = 18 listed pixels: a band holds at most 18,432 pixels.
// The wrapper's plan (ops/heatmap.py::cc_plan) picks the cluster size and
// refuses larger heatmaps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;  // at most 64 registers a thread
constexpr int PPT = 18;  // listed pixels per thread: 18,432 per block
constexpr int SMEM_MAX = THREADS * PPT * 10;  // 8 B of state + 2 B of list a pixel
enum { RED_AREA, RED_FIRST, RED_MC, RED_MR, RED_BW, RED_BH, RED_N };

struct Layout {
  int s_mc, s_xr, s_xc, s_fp;  // shifts; mr sits at bit 0
  uint64_t m_r, m_c;           // row and column field masks
  uint64_t ident;              // a non-mask pixel's word
};

struct Fields {
  int mr, mc, xr, xc, fp;
};

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

__device__ __forceinline__ Layout make_layout(int H, int W) {
  const int rb = bit_length(H), cb = bit_length(W), fb = bit_length(H * W);
  Layout L;
  L.s_mc = rb;
  L.s_xr = rb + cb;
  L.s_xc = 2 * rb + cb;
  L.s_fp = 2 * rb + 2 * cb;
  L.m_r = (1ull << rb) - 1;
  L.m_c = (1ull << cb) - 1;
  L.ident = L.m_r | (L.m_c << L.s_mc) | (((1ull << fb) - 1) << L.s_fp);
  return L;
}

__device__ __forceinline__ uint64_t pack(const Layout& L, const Fields& f) {
  return static_cast<uint64_t>(f.mr) | (static_cast<uint64_t>(f.mc) << L.s_mc) |
         (static_cast<uint64_t>(f.xr) << L.s_xr) | (static_cast<uint64_t>(f.xc) << L.s_xc) |
         (static_cast<uint64_t>(f.fp) << L.s_fp);
}

__device__ __forceinline__ Fields unpack(const Layout& L, uint64_t v) {
  return {static_cast<int>(v & L.m_r), static_cast<int>((v >> L.s_mc) & L.m_c),
          static_cast<int>((v >> L.s_xr) & L.m_r), static_cast<int>((v >> L.s_xc) & L.m_c),
          static_cast<int>(v >> L.s_fp)};
}

__device__ __forceinline__ void fold(Fields& a, const Layout& L, uint64_t v) {
  const Fields b = unpack(L, v);
  a.mr = min(a.mr, b.mr);
  a.mc = min(a.mc, b.mc);
  a.xr = max(a.xr, b.xr);
  a.xc = max(a.xc, b.xc);
  a.fp = min(a.fp, b.fp);
}

// Folds the 3x3 neighbours of column c (the pixel itself excepted) into f;
// `up` and `down` are read only where has_up / has_down.
__device__ __forceinline__ void fold_3x3(Fields& f, const Layout& L, const uint64_t* up,
                                         const uint64_t* mid, const uint64_t* down, bool has_up,
                                         bool has_down, int c, int W) {
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    if (c + dx < 0 || c + dx >= W) continue;
    if (has_up) fold(f, L, up[c + dx]);
    if (dx != 0) fold(f, L, mid[c + dx]);
    if (has_down) fold(f, L, down[c + dx]);
  }
}

__device__ __forceinline__ int warp_max(int v) { return __reduce_max_sync(0xffffffffu, v); }

template <int CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
heatmap_cc_cluster_kernel(const float* __restrict__ heatmaps, int* __restrict__ out, int H, int W,
                          int R, float threshold, int num_iters) {
  extern __shared__ uint64_t state[];  // the band: R rows x W words, then the mask list
  uint16_t* const list = reinterpret_cast<uint16_t*>(state + R * W);
  __shared__ int s_count;              // mask pixels in this band
  __shared__ int s_flag[2];            // rank 0's: round `it` changed a word (it & 1)
  __shared__ int s_red[RED_N];         // rank 0's: the pick's maxima
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const Layout L = make_layout(H, W);
  const int row0 = rank * R;
  const int rows = max(0, min(R, H - row0));
  const int n = rows * W;
  const float* hm = heatmaps + static_cast<int64_t>(blockIdx.y) * H * W +
                    static_cast<int64_t>(row0) * W;
  if (tid == 0) s_count = 0;
  if (rank == 0 && tid < RED_N) s_red[tid] = -1;
  if (rank == 0 && tid < 2) s_flag[tid] = 0;
  __syncthreads();

  // Seed: one coalesced read of the band, and the list of its mask pixels
  // (warp-aggregated slots; their order does not matter). The loop bound is
  // uniform across the warp so that __ballot_sync sees every lane.
  for (int p0 = 0; p0 < n; p0 += THREADS) {
    const int p = p0 + tid;
    const bool in = p < n && hm[p] > threshold;
    if (p < n) {
      const int lr = p / W, c = p - lr * W, r = row0 + lr;
      state[p] = in ? pack(L, {r, c, r, c, r * W + c}) : L.ident;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    int slot = 0;
    if (lane == 0 && ballot) slot = atomicAdd(&s_count, __popc(ballot));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (in) list[slot + __popc(ballot & ((1u << lane) - 1u))] = static_cast<uint16_t>(p);
  }
  cluster.sync();  // every band seeded; rank 0's flags and maxima reset
  const int count = s_count;

  // The neighbour bands' edge rows, read in place. A row outside [0, H) is
  // never read, so rank 0's `above` and the last band's `below` are unused.
  const uint64_t* above =
      rank > 0 ? cluster.map_shared_rank(state, rank - 1) + static_cast<int64_t>(R - 1) * W
               : state;
  const uint64_t* below = rank + 1 < CLUSTER ? cluster.map_shared_rank(state, rank + 1) : state;
  int* flag0 = cluster.map_shared_rank(s_flag, 0);
  int* red0 = cluster.map_shared_rank(s_red, 0);

  for (int it = 0; it < num_iters; ++it) {
    uint64_t next[PPT];
    bool changed = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      if (k * THREADS >= count) break;
      if (i >= count) continue;
      const int p = list[i];
      const int lr = p / W, c = p - lr * W, r = row0 + lr;
      const uint64_t old = state[p];
      Fields f = unpack(L, old);
      if (lr > 0 && lr + 1 < rows) {
        // All three rows in this band: pointers the compiler knows to be
        // shared memory, so plain shared loads.
        fold_3x3(f, L, state + (lr - 1) * W, state + lr * W, state + (lr + 1) * W, true, true,
                 c, W);
      } else {  // a band edge: a neighbour band's row, or no row outside [0, H)
        fold_3x3(f, L, lr > 0 ? state + (lr - 1) * W : above, state + lr * W,
                 lr + 1 < rows ? state + (lr + 1) * W : below, r > 0, r + 1 < H, c, W);
      }
      next[k] = pack(L, f);
      changed |= next[k] != old;
    }
    if (__any_sync(0xffffffffu, changed) && lane == 0) atomicOr(&flag0[it & 1], 1);
    cluster.sync();  // every read of this round's state is done
    if (flag0[it & 1] == 0) break;  // the fixed point; the same value in every block
    // Round it + 1's flag was last read before this round's first barrier.
    if (rank == 0 && tid == 0) s_flag[(it + 1) & 1] = 0;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      if (k * THREADS >= count) break;
      if (i < count) state[list[i]] = next[k];
    }
    cluster.sync();  // every write of this round is done
  }

  // The pick, in three stages over the mask pixels.
  int best = -1;
  for (int i = tid; i < count; i += THREADS) {
    const Fields f = unpack(L, state[list[i]]);
    best = max(best, (f.xc - f.mc + 1) * (f.xr - f.mr + 1));
  }
  best = warp_max(best);
  if (lane == 0 && best >= 0) atomicMax(&red0[RED_AREA], best);
  cluster.sync();
  const int max_area = red0[RED_AREA];
  int first = -1;
  for (int i = tid; i < count; i += THREADS) {
    const Fields f = unpack(L, state[list[i]]);
    if ((f.xc - f.mc + 1) * (f.xr - f.mr + 1) == max_area) first = max(first, f.fp);
  }
  first = warp_max(first);
  if (lane == 0 && first >= 0) atomicMax(&red0[RED_FIRST], first);
  cluster.sync();
  const int best_first = red0[RED_FIRST];
  int w_mc = -1, w_mr = -1, w_bw = -1, w_bh = -1;
  for (int i = tid; i < count; i += THREADS) {
    const Fields f = unpack(L, state[list[i]]);
    const int bw = f.xc - f.mc + 1, bh = f.xr - f.mr + 1;
    if (bw * bh == max_area && f.fp == best_first) {
      w_mc = max(w_mc, f.mc);
      w_mr = max(w_mr, f.mr);
      w_bw = max(w_bw, bw);
      w_bh = max(w_bh, bh);
    }
  }
  w_mc = warp_max(w_mc);
  w_mr = warp_max(w_mr);
  w_bw = warp_max(w_bw);
  w_bh = warp_max(w_bh);
  if (lane == 0 && w_mc >= 0) {
    atomicMax(&red0[RED_MC], w_mc);
    atomicMax(&red0[RED_MR], w_mr);
    atomicMax(&red0[RED_BW], w_bw);
    atomicMax(&red0[RED_BH], w_bh);
  }
  cluster.sync();  // the last cross-block access; every block passes it before exiting
  if (rank == 0 && tid == 0) {
    const bool any = s_red[RED_AREA] >= 0;
    const int cx = any ? (s_red[RED_MC] * 2 + s_red[RED_BW]) / 2 : 0;
    const int cy = any ? (s_red[RED_MR] * 2 + s_red[RED_BH]) / 2 : 0;
    int* o = out + 3 * blockIdx.y;
    o[0] = cx;
    o[1] = cy;
    o[2] = (cx == 0 && cy == 0) ? 0 : 1;
  }
}

// Lets the kernel take the largest band's shared memory, and at cluster 16
// the non-portable cluster size, once per device (a function attribute
// holds for the device's context; setting it again is harmless).
template <int CLUSTER>
cudaError_t prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess || (device < kMaxDevices && done[device])) return e;
  e = cudaFuncSetAttribute(heatmap_cc_cluster_kernel<CLUSTER>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (e == cudaSuccess && CLUSTER > 8) {  // 16 exceeds the portable cluster size
    e = cudaFuncSetAttribute(heatmap_cc_cluster_kernel<CLUSTER>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess && device < kMaxDevices) done[device] = true;
  return e;
}

template <int CLUSTER>
cudaLaunchConfig_t config(int B, int smem_bytes, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, B, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int CLUSTER>
cudaError_t launch(const float* heatmaps, int* out, int B, int H, int W, int R, int smem_bytes,
                   float threshold, int num_iters, cudaStream_t stream) {
  cudaError_t e = prepare<CLUSTER>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<CLUSTER>(B, smem_bytes, stream, &attr);
  return cudaLaunchKernelEx(&cfg, heatmap_cc_cluster_kernel<CLUSTER>, heatmaps, out, H, W, R,
                            threshold, num_iters);
}

template <int CLUSTER>
cudaError_t max_active(int smem_bytes, int* count) {
  cudaError_t e = prepare<CLUSTER>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<CLUSTER>(1, smem_bytes, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(count, heatmap_cc_cluster_kernel<CLUSTER>, &cfg);
}

}  // namespace

// heatmaps: (B, H, W) fp32; out: (B, 3) int32 rows (cx, cy, vis). cluster is
// 8 or 16, R = rows_per_block with R * cluster >= H and R * W <= 18,432, and
// smem_bytes = R * W * 10 (ops/heatmap.py::cc_plan). Returns the launch's
// error, or cudaGetLastError() after it.
extern "C" int heatmap_cc_decode(const void* heatmaps, void* out, int B, int H, int W, int cluster,
                                 int rows_per_block, int smem_bytes, float threshold,
                                 int num_iters, void* stream) {
  const int R = rows_per_block;
  if (R < 1 || R * cluster < H || R * W > THREADS * PPT || smem_bytes < R * W * 10 ||
      smem_bytes > SMEM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* hm = static_cast<const float*>(heatmaps);
  auto* o = static_cast<int*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (cluster) {
    case 8: e = launch<8>(hm, o, B, H, W, R, smem_bytes, threshold, num_iters, s); break;
    case 16: e = launch<16>(hm, o, B, H, W, R, smem_bytes, threshold, num_iters, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// How many clusters of `cluster` blocks with `smem_bytes` of dynamic shared
// memory each the card can hold at once (cudaOccupancyMaxActiveClusters).
extern "C" int heatmap_cc_max_active_clusters(int cluster, int smem_bytes, int* count) {
  switch (cluster) {
    case 8: return static_cast<int>(max_active<8>(smem_bytes, count));
    case 16: return static_cast<int>(max_active<16>(smem_bytes, count));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
