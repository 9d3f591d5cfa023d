// Connected-component heatmap decode: threshold, truncated 3x3 min/max
// propagation of each blob's bounding-box extrema, largest-area pick, centre.
//
// Replaces: padel_analytics_tpu/ops/pallas_cc.py::decode_heatmaps_pallas (the
// same function as the jnp rollprop decode, ops/heatmap.py
// ::_decode_single_rollprop).
//
// What bounds it on the H100: the TPU kernel keeps five int32 maps of the
// whole 288x512 heatmap (~2.95 MB) in VMEM, which cannot fit in a block's
// 227 KB of shared memory. Done densely from global memory, every round would
// stream all five maps of every pixel. But thresholded TrackNet heatmaps are
// sparse: only pixels above the threshold ever change, so the work and the
// memory traffic scale with the number of mask pixels, and the bound is the
// latency of one block's loop of synchronous rounds.
//
// Design (one block per heatmap, simple and exact):
// 1. compact the mask pixels (heatmap > threshold) into a list in global
//    scratch, warp-aggregated atomics on a shared counter; seed their five
//    state values (min/max row, min/max col, raster-first index) in buffer 0.
// 2. for num_iters synchronous (Jacobi) rounds, every listed pixel reads the
//    3x3 neighbourhood of the CURRENT buffer and writes the NEXT one; neighbours
//    outside the image or the mask contribute the identity (BIG for min, -1 for
//    max) and are never read. The rounds stay synchronous: an in-place update
//    would propagate further per round and change the result for blobs wider
//    than num_iters. A round that changes nothing reached the fixed point, so
//    the loop stops early without changing the result.
// 3. block reductions (shared atomicMax): the largest bbox area, then the
//    largest raster-first index among pixels with that area (cv2's
//    reverse-scan tie-break), then each winner field's max, as the reference
//    takes them. cx = (min_c * 2 + bw) / 2, cy likewise, vis = !(cx == 0 &&
//    cy == 0); an empty mask gives (0, 0, 0).
// Scratch (int32, per heatmap): 2 state buffers x 5 maps x H*W + a H*W list,
// allocated by the wrapper. H*W must stay below BIG = 2^24.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 1024;
constexpr int BIG = 1 << 24;
constexpr int SCRATCH_MAPS = 11;  // 2 x 5 state maps + 1 pixel list

__global__ void __launch_bounds__(THREADS)
heatmap_cc_kernel(const float* __restrict__ heatmaps, int* __restrict__ out,
                  int* __restrict__ scratch, int H, int W, float threshold, int num_iters) {
  const int HW = H * W;
  const float* hm = heatmaps + static_cast<int64_t>(blockIdx.x) * HW;
  int* base = scratch + static_cast<int64_t>(blockIdx.x) * SCRATCH_MAPS * HW;
  int* const state0 = base;  // each state buffer: mr | mc | xr | xc | fp
  int* const state1 = base + 5 * HW;
  int* list = base + 10 * HW;

  __shared__ int s_count;
  __shared__ int s_changed;
  __shared__ int s_area, s_first, s_mc, s_mr, s_bw, s_bh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    s_count = 0;
    s_area = -1;
    s_first = -1;
    s_mc = -1;
    s_mr = -1;
    s_bw = -1;
    s_bh = -1;
  }
  __syncthreads();

  // 1. compaction + seed. The loop bound is uniform across the warp so that
  // __ballot_sync sees every lane.
  for (int p0 = 0; p0 < HW; p0 += THREADS) {
    const int p = p0 + tid;
    const bool in = p < HW && hm[p] > threshold;
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    int slot = 0;
    if (lane == 0 && ballot) slot = atomicAdd(&s_count, __popc(ballot));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (in) {
      list[slot + __popc(ballot & ((1u << lane) - 1u))] = p;
      const int r = p / W;
      const int c = p - r * W;
      int* s = state0;
      s[p] = r;
      s[HW + p] = c;
      s[2 * HW + p] = r;
      s[3 * HW + p] = c;
      s[4 * HW + p] = p;
    }
  }
  __syncthreads();
  const int count = s_count;

  // 2. synchronous propagation rounds.
  int cur = 0;
  for (int it = 0; it < num_iters; ++it) {
    if (tid == 0) s_changed = 0;
    __syncthreads();
    const int* src = cur ? state1 : state0;
    int* dst = cur ? state0 : state1;
    bool changed = false;
    for (int i = tid; i < count; i += THREADS) {
      const int p = list[i];
      const int r = p / W;
      const int c = p - r * W;
      int mr = BIG, mc = BIG, xr = -1, xc = -1, fp = BIG;
      for (int dy = -1; dy <= 1; ++dy) {
        const int rr = r + dy;
        if (rr < 0 || rr >= H) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          const int cc = c + dx;
          if (cc < 0 || cc >= W) continue;
          const int q = rr * W + cc;
          if (!(hm[q] > threshold)) continue;
          mr = min(mr, src[q]);
          mc = min(mc, src[HW + q]);
          xr = max(xr, src[2 * HW + q]);
          xc = max(xc, src[3 * HW + q]);
          fp = min(fp, src[4 * HW + q]);
        }
      }
      changed |= mr != src[p] || mc != src[HW + p] || xr != src[2 * HW + p] ||
                 xc != src[3 * HW + p] || fp != src[4 * HW + p];
      dst[p] = mr;
      dst[HW + p] = mc;
      dst[2 * HW + p] = xr;
      dst[3 * HW + p] = xc;
      dst[4 * HW + p] = fp;
    }
    if (changed) s_changed = 1;
    __syncthreads();
    const int any_change = s_changed;
    cur ^= 1;
    __syncthreads();  // every thread has read s_changed before the next reset
    if (!any_change) break;
  }

  // 3. reductions over the listed pixels.
  const int* s = cur ? state1 : state0;
  int best = -1;
  for (int i = tid; i < count; i += THREADS) {
    const int p = list[i];
    const int bw = s[3 * HW + p] - s[HW + p] + 1;
    const int bh = s[2 * HW + p] - s[p] + 1;
    best = max(best, bw * bh);
  }
  atomicMax(&s_area, best);
  __syncthreads();
  const int max_area = s_area;
  int first = -1;
  for (int i = tid; i < count; i += THREADS) {
    const int p = list[i];
    const int bw = s[3 * HW + p] - s[HW + p] + 1;
    const int bh = s[2 * HW + p] - s[p] + 1;
    if (bw * bh == max_area) first = max(first, s[4 * HW + p]);
  }
  atomicMax(&s_first, first);
  __syncthreads();
  const int best_first = s_first;
  int w_mc = -1, w_mr = -1, w_bw = -1, w_bh = -1;
  for (int i = tid; i < count; i += THREADS) {
    const int p = list[i];
    const int bw = s[3 * HW + p] - s[HW + p] + 1;
    const int bh = s[2 * HW + p] - s[p] + 1;
    if (bw * bh == max_area && s[4 * HW + p] == best_first) {
      w_mc = max(w_mc, s[HW + p]);
      w_mr = max(w_mr, s[p]);
      w_bw = max(w_bw, bw);
      w_bh = max(w_bh, bh);
    }
  }
  atomicMax(&s_mc, w_mc);
  atomicMax(&s_mr, w_mr);
  atomicMax(&s_bw, w_bw);
  atomicMax(&s_bh, w_bh);
  __syncthreads();
  if (tid == 0) {
    const int cx = count > 0 ? (s_mc * 2 + s_bw) / 2 : 0;
    const int cy = count > 0 ? (s_mr * 2 + s_bh) / 2 : 0;
    int* o = out + 3 * blockIdx.x;
    o[0] = cx;
    o[1] = cy;
    o[2] = (cx == 0 && cy == 0) ? 0 : 1;
  }
}

}  // namespace

// heatmaps: (B, H, W) fp32; out: (B, 3) int32 rows (cx, cy, vis); scratch:
// (B, 11, H, W) int32. Returns cudaGetLastError() after the launch.
extern "C" int heatmap_cc_decode(const void* heatmaps, void* out, void* scratch, int B, int H,
                                 int W, float threshold, int num_iters, void* stream) {
  heatmap_cc_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(heatmaps), static_cast<int*>(out), static_cast<int*>(scratch), H,
      W, threshold, num_iters);
  return static_cast<int>(cudaGetLastError());
}
