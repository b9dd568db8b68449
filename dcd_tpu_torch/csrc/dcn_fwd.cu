// Modulated deformable convolution (DCNv2) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel dcd_tpu/ops/dcn_pallas.py::_kernel_cw (launched by
// _forward_pallas_cw through deform_conv2d_pallas). The TPU layout variants
// _kernel (width on sublanes) and _kernel_p2 (C == 64, lane-packed even/odd)
// compute the same function in other TPU register layouts; they need no
// kernel of their own here.
//
// What it computes, 3x3 taps, stride 1, pad 1, K = 9, NHWC:
//
//   out[b, p, :] = sum_k W_k^T (mask[b, p, k] *
//                  bilinear(x[b], p + t_k + clip(off[b, p, k], +-R))) + bias
//
// with zero padding per bilinear corner outside the image and interleaved
// offsets (off[..., 2k] = dy, off[..., 2k+1] = dx). The TPU kernel walked a
// (2R+2)^2 window of static shifts because gathers were scalarised there;
// on this card a gather from device memory is an ordinary coalesced load,
// so the kernel gathers the four corners directly and drops the walk.
//
// What bounds it on this card: operations. An output pixel costs
// 2 * 9 * Cin * Cout FLOP of contraction (plus 8 per tap and input channel
// for the bilinear sample) against 4 * (Cin + 27 + Cout) bytes read and
// written once in fp32 (x, offsets and mask, out). That is over 100 FLOP
// per byte at the model's narrowest block (64 -> 64), above the H100's
// balance point for fp32 outside the tensor cores (67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP per byte). Corners are read up to four times and
// once more per Cout tile; the L2 cache (50 MB) absorbs the repeats.
//
// Design, a first kernel that is right and simple:
//  * one block of 256 threads computes a tile of 64 output pixels (flat
//    over B*H*W) times 64 output channels;
//  * for each tap, 64 threads compute the pixel's four corner indices and
//    coefficient * mask in fp32, once, into shared memory;
//  * for each chunk of 32 input channels, the block gathers the bilinear
//    samples from NHWC x (a warp reads 32 consecutive channels of one
//    corner: 128 bytes, coalesced) into shared memory, and stages the
//    matching 32 x 64 slice of W_k;
//  * each thread keeps a 4 x 4 register tile of fp32 sums (pixels
//    ty + 16i, channels tx + 16j), so shared-memory reads are broadcasts
//    or words in distinct banks;
//  * bias is added and the tile stored NHWC in the input type.
// fp32 and bf16 inputs both accumulate in fp32. Tensor cores (wgmma),
// TMA and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KT = 9;         // taps of a 3x3 kernel
constexpr int TILE_P = 64;    // output pixels per block
constexpr int TILE_CO = 64;   // output channels per block
constexpr int CHUNK_C = 32;   // input channels staged per step
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ off,
               const T* __restrict__ mask, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ out,
               int B, int H, int W, int Cin, int Cout, float R) {
  __shared__ int s_idx[TILE_P][4];          // corner pixel (flat b*H*W + y*W + x)
  __shared__ float s_cf[TILE_P][4];         // corner coefficient * mask, 0 outside
  // bilinear samples of this chunk; the row is padded by one word so that
  // the two pixel rows a warp reads in the product sit in different banks
  __shared__ float s_samp[TILE_P][CHUNK_C + 1];
  __shared__ float s_w[CHUNK_C][TILE_CO];   // W_k slice of this chunk

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channel lane
  const int ty = tid / 16;  // output pixel lane
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * TILE_P;
  const int co0 = blockIdx.y * TILE_CO;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < KT; ++k) {
    // corner indices and coefficients of tap k for the tile's pixels
    if (tid < TILE_P) {
      const long long p = p0 + tid;
      if (p < P) {
        const int wq = (int)(p % W);
        const int hq = (int)((p / W) % H);
        const long long img = p - (long long)hq * W - wq;  // b * H * W
        float dy = fminf(fmaxf(off[p * (2 * KT) + 2 * k], -R), R);
        float dx = fminf(fmaxf(off[p * (2 * KT) + 2 * k + 1], -R), R);
        const float iy = floorf(dy), ix = floorf(dx);
        const float ly = dy - iy, lx = dx - ix;
        const int y0 = hq + k / 3 - 1 + (int)iy;
        const int x0 = wq + k % 3 - 1 + (int)ix;
        const float m = to_f32(mask[p * KT + k]);
        const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx,
                             ly * (1.f - lx), ly * lx};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int yc = y0 + (c >> 1);
          const int xc = x0 + (c & 1);
          const bool ok = yc >= 0 && yc < H && xc >= 0 && xc < W;
          s_idx[tid][c] = ok ? (int)(img + (long long)yc * W + xc) : 0;
          s_cf[tid][c] = ok ? cw[c] * m : 0.f;
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s_idx[tid][c] = 0;
          s_cf[tid][c] = 0.f;
        }
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < Cin; c0 += CHUNK_C) {
      // gather: a warp takes the 32 channels of one pixel
      {
        const int c = tid % CHUNK_C;
        const bool cok = c0 + c < Cin;
#pragma unroll
        for (int r = 0; r < TILE_P * CHUNK_C / THREADS; ++r) {
          const int pl = tid / CHUNK_C + r * (THREADS / CHUNK_C);
          float v = 0.f;
          if (cok) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float cf = s_cf[pl][q];
              if (cf != 0.f)
                v += cf * to_f32(x[(long long)s_idx[pl][q] * Cin + c0 + c]);
            }
          }
          s_samp[pl][c] = v;
        }
      }
      // stage W[k, c0:c0+32, co0:co0+64]
      {
        const int co = tid % TILE_CO;
#pragma unroll
        for (int r = 0; r < CHUNK_C * TILE_CO / THREADS; ++r) {
          const int c = tid / TILE_CO + r * (THREADS / TILE_CO);
          float v = 0.f;
          if (c0 + c < Cin && co0 + co < Cout)
            v = to_f32(w[((long long)k * Cin + c0 + c) * Cout + co0 + co]);
          s_w[c][co] = v;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < CHUNK_C; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_samp[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = s_w[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co >= Cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f32(bias[co]);
      out[p * Cout + co] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* off, const void* mask, const void* w,
           const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
           int radius, void* stream) {
  const long long P = (long long)B * H * W;
  dim3 grid((unsigned)((P + TILE_P - 1) / TILE_P), (unsigned)((Cout + TILE_CO - 1) / TILE_CO));
  dcn_fwd_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)off, (const T*)mask, (const T*)w, (const T*)bias,
      (T*)out, B, H, W, Cin, Cout, (float)radius);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers; `bias` may
// be null. The launch goes on `stream` and does not synchronise. The return
// value is cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int dcn_fwd_f32(const void* x, const void* off, const void* mask,
                           const void* w, const void* bias, void* out, int B,
                           int H, int W, int Cin, int Cout, int radius,
                           void* stream) {
  return launch<float>(x, off, mask, w, bias, out, B, H, W, Cin, Cout, radius, stream);
}

extern "C" int dcn_fwd_bf16(const void* x, const void* off, const void* mask,
                            const void* w, const void* bias, void* out, int B,
                            int H, int W, int Cin, int Cout, int radius,
                            void* stream) {
  return launch<__nv_bfloat16>(x, off, mask, w, bias, out, B, H, W, Cin, Cout,
                               radius, stream);
}
