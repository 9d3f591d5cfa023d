// Fused stride-1 3x3 convolution + folded BatchNorm + activation, NHWC bf16.
//
// Replaces: padel_analytics_tpu/ops/pallas_conv.py::_conv3x3_bn_act (and its
// row-pipelined twin _conv3x3_bn_act_rows, which computes the same function).
//
// What bounds it on the H100: TrackNet's convs at 288x512 are GEMMs of
// M = B*H*W (1.18M rows at B=8), N = Cout (64..512), K = 9*Cin (288..6912),
// far above the bf16 ridge point (~295 FLOP/byte), so the tensor cores bound
// it. The activation traffic (each input pixel is re-read for 9 taps) is
// absorbed by L1/L2, and the fused epilogue saves one full write + read of
// the fp32 conv output that conv -> BN -> ReLU as three ops would cost.
//
// Design (a simple, correct first version; wgmma/TMA come later):
// - implicit GEMM: a block owns a BM x BN output tile (BM pixels x BN output
//   channels) and walks K in BK slices. The A slice is gathered im2col-style
//   straight from the NHWC input (k = tap * Cin + c; zero-filled outside the
//   image and past K), the B slice is the packed (9*Cin, Cout) weight.
// - 16-byte cp.async copies with a two-stage ring in shared memory, so the
//   next slice loads while the tensor cores work on the current one.
// - nvcuda::wmma bf16 16x16x16 fragments with fp32 accumulation; 8 warps,
//   each owning a 32x32 sub-tile.
// - epilogue: the accumulator tile goes through shared memory, then every
//   thread applies scale, bias and the activation in fp32, casts once to bf16
//   and stores 8 channels (16 bytes) at a time, masked at the ragged M / N
//   edges.
// Contract (checked by the Python wrapper): Cin % 8 == 0 (the wrapper pads the
// 27-channel TrackNet stem to 32 with zero channels and zero weight rows),
// Cout % 8 == 0, all pointers 16-byte aligned and contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;  // bf16 elements; padding breaks bank conflicts
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // fp32 elements
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int AB_BYTES = 2 * (A_STAGE + B_STAGE) * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return v / (1.0f + __expf(-v));
  return v;
}

__global__ void __launch_bounds__(THREADS)
conv3x3_bn_act_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int H, int W, int Cin, int Cout, int M,
                      int act) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the main loop

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const int HW = H * W;

  // A loader: BM rows x (BK / 8) chunks of 8 channels = 512 chunks, 2 a thread.
  int a_row[2], a_kc[2], a_b[2], a_y[2], a_x[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * THREADS;
    a_row[i] = id >> 2;
    a_kc[i] = id & 3;
    const int m = m0 + a_row[i];
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    a_b[i] = mm / HW;
    const int rem = mm - a_b[i] * HW;
    a_y[i] = rem / W;
    a_x[i] = rem - a_y[i] * W;
  }
  // B loader: BK rows x (BN / 8) chunks = 256 chunks, one a thread.
  const int b_k = tid >> 3;
  const int b_nc = tid & 7;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + a_kc[i] * 8;
      bool ok = a_ok[i] && k < K;
      const __nv_bfloat16* src = x;
      if (ok) {
        const int tap = k / Cin;
        const int c = k - tap * Cin;
        const int yy = a_y[i] + tap / 3 - 1;
        const int xx = a_x[i] + tap % 3 - 1;
        ok = yy >= 0 && yy < H && xx >= 0 && xx < W;
        if (ok) src = x + ((static_cast<int64_t>(a_b[i]) * H + yy) * W + xx) * Cin + c;
      }
      cp_async16(As + stage * A_STAGE + a_row[i] * A_LD + a_kc[i] * 8, src, ok);
    }
    const int k = k0 + b_k;
    const int n = n0 + b_nc * 8;
    const bool ok = k < K && n < Cout;
    const __nv_bfloat16* src = ok ? w + static_cast<int64_t>(k) * Cout + n : w;
    cp_async16(Bs + stage * B_STAGE + b_k * B_LD + b_nc * 8, src, ok);
  };

  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 0..3: rows wm*32
  const int wn = warp & 1;   // 0..1: cols wn*32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile((kt + 1) & 1, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a_s = As + (kt & 1) * A_STAGE;
    const __nv_bfloat16* b_s = Bs + (kt & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_s + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is overwritten by the next iteration's load
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();

  // Epilogue: BM x BN / 8 = 1024 chunks of 8 channels, 4 a thread.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = tid + i * THREADS;
    const int row = id >> 3;
    const int nc = id & 7;
    const int m = m0 + row;
    const int n = n0 + nc * 8;
    if (m >= M || n >= Cout) continue;
    alignas(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y = Cs[row * C_LD + nc * 8 + e] * scale[n + e] + bias[n + e];
      v[e] = __float2bfloat16(apply_act(y, act));
    }
    *reinterpret_cast<uint4*>(out + static_cast<int64_t>(m) * Cout + n) =
        *reinterpret_cast<const uint4*>(v);
  }
}

}  // namespace

// x: (B, H, W, Cin) bf16; w: (9 * Cin, Cout) bf16, row k = tap * Cin + c with
// tap = 3 * dy + dx; scale, bias: (Cout,) fp32; out: (B, H, W, Cout) bf16.
// act: 0 none, 1 relu, 2 silu. Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_bn_act_bf16(const void* x, const void* w, const void* scale,
                                   const void* bias, void* out, int B, int H, int W, int Cin,
                                   int Cout, int act, void* stream) {
  const int M = B * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv3x3_bn_act_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, M, act);
  return static_cast<int>(cudaGetLastError());
}
