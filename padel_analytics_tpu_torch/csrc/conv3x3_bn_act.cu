// Fused stride-1 3x3 convolution + folded BatchNorm + activation, NHWC bf16,
// for Hopper (sm_90a): wgmma fed by TMA through mbarrier rings.
//
// Replaces: padel_analytics_tpu/ops/pallas_conv.py::_conv3x3_bn_act and its
// row-pipelined twin _conv3x3_bn_act_rows. Both compute this function; the
// twin differs only in overlapping its row DMAs with the MXU, which is what
// the multi-stage TMA rings below do here.
//
// What bounds it on the H100: TrackNet's convs at 288x512 are implicit GEMMs
// of M = B*H*W (1.18M rows at B=8), N = Cout (64..512), K = 9*Cin
// (288..6912), far above the bf16 ridge point (~295 FLOP/byte), so the
// tensor cores bound it; only the 27- and 64-channel convs at 288x512 come
// near the byte bound. Below the tensor cores, what limits a tile is the
// traffic from L2 into shared memory (each input pixel is wanted by 9 taps),
// shared memory's read rate into wgmma (an m64n64 product reads as many
// bytes per cycle as shared memory gives), and the epilogue, during which a
// block's tensor cores idle. The fused epilogue saves the fp32 round trip of
// a separate BN + act.
//
// Design:
// - GEMM: the pixels of a tile are the M side and its BN output channels
//   (128 where Cout is a multiple of 128, else 64) the N side, for tiles of
//   TH x TW = 128 pixels of one image. TW is 64, 32, 16 or 8, picked by the
//   wrapper's tile plan so that ragged widths (YOLOv8's 20, 40, 80, 160)
//   waste few rows. Up to 64 output channels on images a multiple of 128
//   wide, the tile is 2 x 128 pixels and the sides swap: each warpgroup
//   computes (64 channels) x (128 pixels) with m64n128k16, which reads 6 KB
//   of shared memory per k16 product where two m64n64k16 would read 8 KB.
// - K walks (64-channel block c0, tap). A tiles come from TMA boxes of the
//   unpadded NHWC input; TMA zero-fills what lies outside the tensor, which
//   gives the (1, 1) padding, the ragged edges and the channels past Cin with
//   no address math in any thread. The weight is one 3-D box (64, 1, BN) of
//   the weight packed as (Cout, 9, Cin_p), one per tap.
// - Tiles 64 or 128 wide (every TrackNet layer): one halo box
//   (64, TW + 2, TH + 2, 1) at (c0, x0 - 1, y0 - 1, b) per channel block; the
//   9 taps read it through descriptors shifted by (dy * (TW + 2) + dx) rows,
//   so each input pixel crosses from L2 once per tile instead of 9 times.
//   Narrower tiles load one box (64, TW, TH, 1) at (c0, x0 + dx - 1,
//   y0 + dy - 1, b) per tap.
// - Both operands land in shared memory with TMA's 128-byte swizzle, which is
//   the layout the wgmma descriptors read (K-major, no transpose).
// - Warp specialisation: warpgroup 2 is the producer (one thread issues the
//   TMA copies into an A ring and a B ring of 4 or 6 stages, each with full
//   and empty mbarriers; setmaxnreg hands its registers to the consumers);
//   warpgroups 0 and 1 each own half of the tile's pixels and issue wgmma
//   (bf16 in, fp32 accumulators in registers), keeping one wgmma group in
//   flight while they wait for the next stage.
// - Persistent: one block per SM walks the tiles; the rings run on across
//   tiles, so the next tile's loads overlap this tile's last products and
//   its epilogue.
// - Epilogue from registers: scale, bias and activation in fp32, one cast to
//   bf16, written into a shared-memory output tile in the swizzled layout
//   and stored by TMA, which clips the tile at the image and Cout edges; the
//   store drains while the next tile computes.
// Contract (checked by the Python wrapper): Cin % 8 == 0 and Cout % 8 == 0
// (TMA wants 16-byte strides), contiguous tensors, 16-byte aligned bases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int BM = 128;                     // GEMM rows (pixels) per tile
constexpr int BK = 64;                      // channels per k-block: one 128-byte row
constexpr int kThreads = 384;               // consumer warpgroups 0, 1 + producer 2
constexpr int kConsumers = 256;
constexpr int kEncodeError = 100000;        // + CUresult when a tensor map is refused

template <int TW, int BN>
struct Cfg {
  // 128-wide tiles (Cout <= 64) put the pixels on wgmma's N side: each
  // warpgroup computes (64 channels) x (one image row of 128 pixels), which
  // reads 6 KB of shared memory per k16 product where two m64n64 read 8 KB.
  static constexpr bool kPixelsN = TW == 128;
  static_assert(!kPixelsN || BN == 64, "pixels on N: one 64-channel block");
  static constexpr int TH = kPixelsN ? 2 : BM / TW;
  static constexpr int PIXELS = TH * TW;  // 128, or 256 with pixels on N
  // Tiles 64 or more wide (TH = 2) load one halo box per channel block and
  // read the 9 taps from it through shifted descriptors; narrower tiles load
  // one box per tap.
  static constexpr bool kHalo = TW >= 64;
  static constexpr int A_ROWS = kHalo ? (TH + 2) * (TW + 2) : BM;
  static constexpr int A_TX = A_ROWS * BK * 2;  // bytes one A load moves
  static constexpr int A_STAGE = (A_TX + 1023) / 1024 * 1024;
  static constexpr int B_STAGE = BN * BK * 2;
  static constexpr int kAStages = kPixelsN ? 2 : kHalo ? 3 : 4;
  static constexpr int kBStages = BN == 128 ? 4 : 6;
  static constexpr int ACC = kPixelsN ? 64 : BN / 2;  // fp32 accumulators a thread
  static constexpr int C_BYTES = PIXELS * BN * 2;     // the output tile, bf16
  static constexpr int B_OFFSET = kAStages * A_STAGE;
  static constexpr int C_OFFSET = B_OFFSET + kBStages * B_STAGE;
  static constexpr int BAR_OFFSET = C_OFFSET + C_BYTES;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFFSET + 2 * (kAStages + kBStages) * 8;
  static_assert(SMEM_BYTES <= 227 * 1024, "one block per SM");
};

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return v / (1.0f + __expf(-v));
  return v;
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                           int accumulate) {
  if constexpr (BN == 128) {
    sm90::wgmma_m64n128k16(acc, da, db, accumulate);
  } else {
    sm90::wgmma_m64n64k16(acc, da, db, accumulate);
  }
}

// Ring position: stage index and the parity of its current round.
template <int N>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == N) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Output tile `t`: output channels fastest, so the tiles that share an input
// tile run together and find it in L2.
struct Tile {
  int n0, x0, y0, b;
  __device__ __forceinline__ Tile(int t, int tw, int th, int bn, int tiles_x, int tiles_y,
                                  int tiles_n) {
    n0 = (t % tiles_n) * bn;
    t /= tiles_n;
    x0 = (t % tiles_x) * tw;
    t /= tiles_x;
    y0 = (t % tiles_y) * th;
    b = t / tiles_y;
  }
};

// Persistent: one block per SM walks the tiles blockIdx.x, + gridDim.x, ...
// The rings carry over from tile to tile, so the producer loads the next
// tile while the consumers finish this one and run its epilogue.
template <int TW, int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bn_act_sm90(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __grid_constant__ CUtensorMap out_map,
                    const float* __restrict__ scale, const float* __restrict__ bias, int Cout,
                    int n_cblocks, int tiles_x, int tiles_y, int tiles_n, int n_tiles,
                    int act) {
  using C = Cfg<TW, BN>;
  constexpr int TH = C::TH;
  extern __shared__ unsigned char smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: stages start 1024-aligned.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + C::BAR_OFFSET);
  uint64_t* empty_a = full_a + C::kAStages;
  uint64_t* full_b = empty_a + C::kAStages;
  uint64_t* empty_b = full_b + C::kBStages;

  if (threadIdx.x == 0) {
    // full: the producer's expect_tx arrival; empty: one arrival per consumer warp.
    for (int s = 0; s < C::kAStages; ++s) {
      sm90::mbar_init(&full_a[s], 1);
      sm90::mbar_init(&empty_a[s], kConsumers / 32);
    }
    for (int s = 0; s < C::kBStages; ++s) {
      sm90::mbar_init(&full_b[s], 1);
      sm90::mbar_init(&empty_b[s], kConsumers / 32);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps both rings full. Every expect_tx counts
    // the whole box, zero-filled parts included.
    sm90::warpgroup_reg_dealloc<40>();
    if (threadIdx.x == 2 * 128) {
      sm90::prefetch_tensormap(&x_map);
      sm90::prefetch_tensormap(&w_map);
      Ring<C::kAStages> ra;
      Ring<C::kBStages> rb;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tile(t, TW, TH, BN, tiles_x, tiles_y, tiles_n);
        for (int cb = 0; cb < n_cblocks; ++cb) {
          for (int tap = 0; tap < 9; ++tap) {
            if (!C::kHalo || tap == 0) {
              sm90::mbar_wait(&empty_a[ra.stage], ra.phase ^ 1);  // round 0 passes at once
              sm90::mbar_arrive_expect_tx(&full_a[ra.stage], C::A_TX);
              // Halo: rows y0-1 .. y0+TH, columns x0-1 .. x0+TW. Per tap: the
              // tile shifted by (dy - 1, dx - 1).
              const int dy = C::kHalo ? 0 : tap / 3, dx = C::kHalo ? 0 : tap % 3;
              sm90::tma_load_4d(smem + ra.stage * C::A_STAGE, &x_map, &full_a[ra.stage],
                                cb * BK, tile.x0 + dx - 1, tile.y0 + dy - 1, tile.b);
              ra.advance();
            }
            sm90::mbar_wait(&empty_b[rb.stage], rb.phase ^ 1);
            sm90::mbar_arrive_expect_tx(&full_b[rb.stage], C::B_STAGE);
            sm90::tma_load_3d(smem + C::B_OFFSET + rb.stage * C::B_STAGE, &w_map,
                              &full_b[rb.stage], cb * BK, tap, tile.n0);
            rb.advance();
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns the tile's pixels [P wg, P wg + P),
    // P = PIXELS / 2.
    sm90::warpgroup_reg_alloc<232>();
    float acc[C::ACC];
    const int lane = threadIdx.x & 31;
    const int warp = (threadIdx.x & 127) >> 5;
    const bool store_thread = (threadIdx.x & 127) == 0;
    const uint32_t base = sm90::smem_u32(smem);
    // This warpgroup's output pixels: BN/64 chunks of P rows x 128 bytes.
    unsigned char* ctile = smem + C::C_OFFSET + wg * (C::PIXELS / 2) * BN * 2;
    Ring<C::kAStages> ra;
    Ring<C::kBStages> rb;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tile(t, TW, TH, BN, tiles_x, tiles_y, tiles_n);
      int prev_a = -1, prev_b = -1;  // stages the previous wgmma group read (-1: keep)
      for (int cb = 0; cb < n_cblocks; ++cb) {
        for (int tap = 0; tap < 9; ++tap) {
          const bool first_use = !C::kHalo || tap == 0;
          const bool last_use = !C::kHalo || tap == 8;
          if (first_use) sm90::mbar_wait(&full_a[ra.stage], ra.phase);
          sm90::mbar_wait(&full_b[rb.stage], rb.phase);
          // First A row of this warpgroup for the tap. Halo: warpgroup wg's
          // output row is image row y0 + wg, read through halo row wg + dy
          // shifted by dx pixels.
          const int row0 = C::kHalo ? (wg + tap / 3) * (TW + 2) + tap % 3 : wg * 64;
          const uint32_t a = base + ra.stage * C::A_STAGE + row0 * 128;
          const uint32_t bw = base + C::B_OFFSET + rb.stage * C::B_STAGE;
          sm90::fence_regs(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            // The tile's first product overwrites the accumulators.
            const int accumulate = (cb | tap | kk) != 0;
            const uint64_t pixels = sm90::sw128_desc(a + kk * 32);
            const uint64_t weights = sm90::sw128_desc(bw + kk * 32);
            if constexpr (C::kPixelsN) {
              sm90::wgmma_m64n128k16(acc, weights, pixels, accumulate);
            } else {
              wgmma_tile<BN>(acc, pixels, weights, accumulate);
            }
          }
          sm90::wgmma_commit();
          sm90::fence_regs(acc);
          sm90::wgmma_wait<1>();  // the previous group is done: free what it read
          sm90::fence_regs(acc);
          if (lane == 0) {
            if (prev_b >= 0) sm90::mbar_arrive(&empty_b[prev_b]);
            if (prev_a >= 0) sm90::mbar_arrive(&empty_a[prev_a]);
          }
          prev_b = rb.stage;
          prev_a = last_use ? ra.stage : -1;
          rb.advance();
          if (last_use) ra.advance();
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) {  // the last stages are free for the next tile's loads
        sm90::mbar_arrive(&empty_b[prev_b]);
        if (prev_a >= 0) sm90::mbar_arrive(&empty_a[prev_a]);
      }

      // Epilogue into this warpgroup's output pixels: pixel r is
      // (y0 + wg * TH/2 + r / TW, x0 + r % TW) and holds its 64-channel
      // chunks in the 128-byte swizzle (16-byte group g of row r at
      // g ^ (r % 8)). The previous tile's store must have read the buffer.
      if (store_thread) sm90::tma_store_wait_read();
      sm90::named_barrier_sync(1 + wg, 128);
      const int r0 = warp * 16 + (lane >> 2);  // and r0 + 8; r0 % 8 == lane / 4
      if constexpr (C::kPixelsN) {
        // acc holds channels n0 + r0, n0 + r0 + 8 at pixels
        // 8j + 2 (lane % 4) + {0, 1}.
        float sc[2] = {0.0f, 0.0f}, bi[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = tile.n0 + r0 + 8 * h;
          if (n < Cout) {
            sc[h] = scale[n];
            bi[h] = bias[n];
          }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int px = 8 * j + 2 * (lane & 3) + (e & 1), h = e >> 1;
            const float v = apply_act(acc[4 * j + e] * sc[h] + bi[h], act);
            // channel r0 + 8h: 16-byte group r0 / 8 + h, element lane / 4.
            *reinterpret_cast<__nv_bfloat16*>(
                ctile + px * 128 + ((((r0 >> 3) + h) ^ (px & 7)) << 4) + (lane >> 2) * 2) =
                __float2bfloat16(v);
          }
        }
      } else {
        // acc holds pixels r0, r0 + 8 at channels n0 + 8j + 2 (lane % 4) + {0, 1}.
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = tile.n0 + j * 8 + (lane & 3) * 2;
          float2 sc = make_float2(0.0f, 0.0f), bi = make_float2(0.0f, 0.0f);
          if (n < Cout) {
            sc = *reinterpret_cast<const float2*>(scale + n);
            bi = *reinterpret_cast<const float2*>(bias + n);
          }
          const __nv_bfloat162 top =
              __floats2bfloat162_rn(apply_act(acc[4 * j] * sc.x + bi.x, act),
                                    apply_act(acc[4 * j + 1] * sc.y + bi.y, act));
          const __nv_bfloat162 bot =
              __floats2bfloat162_rn(apply_act(acc[4 * j + 2] * sc.x + bi.x, act),
                                    apply_act(acc[4 * j + 3] * sc.y + bi.y, act));
          unsigned char* p =
              ctile + (j / 8) * 64 * 128 + (((j % 8) ^ (lane >> 2)) * 16) + (lane & 3) * 4;
          *reinterpret_cast<__nv_bfloat162*>(p + r0 * 128) = top;
          *reinterpret_cast<__nv_bfloat162*>(p + (r0 + 8) * 128) = bot;
        }
      }
      sm90::fence_async_shared();
      sm90::named_barrier_sync(1 + wg, 128);
      if (store_thread) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          sm90::tma_store_4d(&out_map, ctile + c * (C::PIXELS / 2) * 128, tile.n0 + c * 64,
                             tile.x0, tile.y0 + wg * (TH / 2), tile.b);
        }
        sm90::tma_store_commit();
      }
    }
    if (store_thread) sm90::tma_store_wait_read();
  }
}

template <int TW, int BN>
int launch(const void* x, const void* w, const float* scale, const float* bias, void* out, int B,
           int H, int W, int Cin, int Cout, int act, cudaStream_t stream) {
  using C = Cfg<TW, BN>;
  constexpr int TH = C::TH;
  const cuuint64_t e = 2;  // bytes per bf16
  CUtensorMap x_map, w_map, out_map;
  const cuuint64_t x_dims[4] = {cuuint64_t(Cin), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t x_strides[3] = {Cin * e, W * Cin * e, cuuint64_t(H) * W * Cin * e};
  const cuuint32_t x_box[4] = {BK, C::kHalo ? TW + 2 : TW, C::kHalo ? TH + 2 : TH, 1};
  const cuuint64_t w_dims[3] = {cuuint64_t(Cin), 9, cuuint64_t(Cout)};
  const cuuint64_t w_strides[2] = {Cin * e, 9 * Cin * e};
  const cuuint32_t w_box[3] = {BK, 1, BN};
  const cuuint64_t o_dims[4] = {cuuint64_t(Cout), cuuint64_t(W), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t o_strides[3] = {Cout * e, W * Cout * e, cuuint64_t(H) * W * Cout * e};
  const cuuint32_t o_box[4] = {64, TW, TH / 2, 1};
  CUresult r = sm90::encode_bf16_map(&x_map, x, 4, x_dims, x_strides, x_box,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_bf16_map(&w_map, w, 3, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_bf16_map(&out_map, out, 4, o_dims, o_strides, o_box,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);

  auto kernel = conv3x3_bn_act_sm90<TW, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_cblocks = (Cin + BK - 1) / BK;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int tiles_n = (Cout + BN - 1) / BN;
  const long long tiles = static_cast<long long>(B) * tiles_y * tiles_x * tiles_n;
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<blocks, kThreads, C::SMEM_BYTES, stream>>>(x_map, w_map, out_map, scale, bias, Cout,
                                                      n_cblocks, tiles_x, tiles_y, tiles_n,
                                                      static_cast<int>(tiles), act);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_tw(int tw, const void* x, const void* w, const float* scale, const float* bias,
              void* out, int B, int H, int W, int Cin, int Cout, int act, cudaStream_t stream) {
  switch (tw) {
    case 128:
      if constexpr (BN == 64) {
        return launch<128, 64>(x, w, scale, bias, out, B, H, W, Cin, Cout, act, stream);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    case 64: return launch<64, BN>(x, w, scale, bias, out, B, H, W, Cin, Cout, act, stream);
    case 32: return launch<32, BN>(x, w, scale, bias, out, B, H, W, Cin, Cout, act, stream);
    case 16: return launch<16, BN>(x, w, scale, bias, out, B, H, W, Cin, Cout, act, stream);
    case 8: return launch<8, BN>(x, w, scale, bias, out, B, H, W, Cin, Cout, act, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (B, H, W, Cin) bf16 NHWC; w: (Cout, 9, Cin) bf16, w[n, 3 * dy + dx, c];
// scale, bias: (Cout,) fp32; out: (B, H, W, Cout) bf16. act: 0 none, 1 relu,
// 2 silu. Tile: tw in {64, 32, 16, 8} pixels wide, 128 / tw rows tall, or
// tw = 128 (2 rows, bn = 64 only); bn in {64, 128} output channels. Returns cudaGetLastError() after the
// launch, or 100000 + the CUresult of a refused tensor map.
extern "C" int conv3x3_bn_act_bf16(const void* x, const void* w, const void* scale,
                                   const void* bias, void* out, int B, int H, int W, int Cin,
                                   int Cout, int act, int tw, int bn, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto sc = static_cast<const float*>(scale);
  const auto bi = static_cast<const float*>(bias);
  if (bn == 128) return launch_tw<128>(tw, x, w, sc, bi, out, B, H, W, Cin, Cout, act, s);
  if (bn == 64) return launch_tw<64>(tw, x, w, sc, bi, out, B, H, W, Cin, Cout, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
