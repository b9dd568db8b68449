// Modulated deformable convolution (DCNv2) backward for Hopper (sm_90a), fp32.
//
// Replaces two TPU kernels of dcd_tpu/ops/dcn_pallas.py, entered through the
// custom VJP of deform_conv2d_pallas:
//
//  * K2, _bwd_pom_kernel_cw (dcn_pallas.py:859, launched by _bwd_pom_cw
//    :1013): grad_offset, grad_mask and grad_weight. Here:
//    tap_products_kernel, bwd_pom_kernel, bwd_weight_kernel and
//    bwd_weight_reduce_kernel, launched by dcn_bwd_pom_f32 (after
//    dcn_tap_products_f32).
//  * K3, _bwd_x_kernel_cw (dcn_pallas.py:1246, launched by _bwd_x_cw
//    :1352): grad_x. Here: bwd_x_kernel, launched by dcn_bwd_x_f32.
//
// The TPU's width-on-sublanes variants _bwd_pom_kernel (:746) and
// _bwd_x_kernel (:1163), selected by DCD_DCN_LAYOUT=wc, compute the same
// functions in another TPU register layout; they close with these kernels
// and need none of their own.
//
// The forward (dcn_fwd.cu), 3x3 taps, stride 1, pad 1, K = 9, NHWC:
//
//   s_k(p)  = bilinear(x, p + t_k + clip(off_k(p), +-R))      (per channel)
//   out(p)  = sum_k W_k^T (mask_k(p) s_k(p)) + bias
//
// With the cotangent g (B, H, W, Cout) and the per-tap product
// U_k(p) = W_k g(p) (Cin values for each pixel and tap):
//
//   grad_mask_k(p)   = sum_c U_k(p)_c s_k(p)_c
//   grad_off_k(p)    = mask_k(p) sum_c U_k(p)_c ds_k(p)_c / d(dy, dx),
//                      zero where the clip is active (|off| > R)
//   grad_weight_k    = sum_p (mask_k(p) s_k(p)) g(p)^T
//   grad_x(q)        = sum_k sum_p coef_k(p -> q) mask_k(p) U_k(p)
//
// where coef_k(p -> q) is the bilinear weight with which output pixel p's
// tap k reads input pixel q. The fraction is taken with the floor convention
// of the forward and of the plain version, fy = dy - floor(dy), so at an
// integer offset (every offset at the first step: the offset convs start at
// zero) ds/ddy is the forward difference x(y0 + 1) - x(y0). Corners outside
// the image read zero and receive nothing. A clipped offset samples at the
// clipped position, so it still gives grad_x and grad_mask there. A tap
// whose dy or dx is NaN is dropped: it gives and gets nothing (grad_offset,
// grad_mask, grad_weight and grad_x all 0 from it), as autograd of the plain
// version gives.
//
// What bounds it on this card: operations. The two contractions (U and
// grad_weight, 2 * 9 * Cin * Cout FLOP per pixel each) dominate; the
// sampling adds some 40 FLOP per pixel, tap and input channel. That is over
// 100 FLOP per byte of the function's inputs and outputs at the model's
// narrowest block (64 -> 64), above the H100's fp32 balance point outside
// the tensor cores (67 TFLOP/s over 3.35 TB/s, about 20 FLOP per byte).
//
// Design, a first version that is right, simple and deterministic:
//  * tap_products_kernel: U (P, 9, Cin) = g (P, Cout) times W (9 Cin, Cout)^T,
//    a shared-memory tiled product with fp32 FMAs (64 x 64 tiles, 4 x 4
//    register tiles), as in dcn_fwd.cu. K2 and K3 share U in a train step.
//  * bwd_pom_kernel: one warp per (pixel, tap). It recomputes the four
//    clamped, floor-split corners exactly as the forward does; its lanes walk
//    the channels, reading the corners of x and the row of U (coalesced), and
//    a butterfly of shuffles sums the three products in a fixed order.
//  * bwd_weight_kernel: a block owns a 64 x 64 tile of grad_weight_k and a
//    fixed range of pixels; it gathers mask * s for 32 pixels at a time into
//    shared memory beside the matching rows of g and accumulates in
//    registers. Blocks run in no order, so each writes its partial sum, and
//    bwd_weight_reduce_kernel adds the partials in a fixed order. No float
//    atomics anywhere: two runs give bitwise equal results.
//  * bwd_x_kernel: the transposed gather of the TPU kernel, without its
//    (2R+2)^2 walk over whole planes: one warp per input pixel q; for each
//    tap its lanes test the (2R+2)^2 source pixels p whose clamped offset can
//    reach q, recomputing p's corners; a ballot lists the hits in a fixed
//    order and the whole warp adds coef * mask * U_k(p) over the channels.
//    No scatter, no atomics.
// Tensor cores (wgmma on TF32 or bf16), fusing U into its consumers and a
// persistent schedule are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 9;  // taps of a 3x3 kernel
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// tap products
constexpr int UT_P = 64;  // pixels per block
constexpr int UT_N = 64;  // (tap, input channel) columns per block
constexpr int UT_O = 32;  // output channels staged per step
static_assert(UT_P == UT_N, "tap_products_kernel stages g and w rows with one index");

// grad_weight
constexpr int GW_P = 32;      // pixels staged per step
constexpr int GW_C = 64;      // input channels per block
constexpr int GW_O = 64;      // output channels per block
constexpr int GW_BLOCKS = 528;  // aim: four blocks per SM of 132
static_assert(GW_C == GW_O, "bwd_weight_kernel stages x and g with one index");

// grad_x
constexpr int X_CPL = 4;  // channels per lane per pass (128 per warp)

struct Corners {
  long long base[4];  // flat pixel index of each corner (0 when outside)
  bool ok[4];         // corner inside the image
  int y0, x0;         // top-left corner
  float ly, lx;       // fractions, floor convention
  bool in_y, in_x;    // offset inside [-R, R]: the clip passes its gradient
  bool drop;          // dy or dx is NaN: the tap reads nothing and gets no gradient
};

// The sample point of output pixel p = (img, hq, wq), tap k: clamp, floor
// split and corner validity exactly as dcn_fwd.cu computes them.
__device__ __forceinline__ Corners corners_of(const float* __restrict__ off, long long p,
                                              long long img, int hq, int wq, int k, int H,
                                              int W, float R) {
  Corners c;
  const float dyr = off[p * (2 * KT) + 2 * k];
  const float dxr = off[p * (2 * KT) + 2 * k + 1];
  // a NaN offset drops the tap, as the plain version and the TPU kernel do
  // (fmaxf would turn NaN into -R); its (dy, dx) become 0 so that the
  // indices below stay finite, and every corner is marked outside
  c.drop = isnan(dyr) || isnan(dxr);
  c.in_y = !c.drop && dyr >= -R && dyr <= R;
  c.in_x = !c.drop && dxr >= -R && dxr <= R;
  const float dy = c.drop ? 0.f : fminf(fmaxf(dyr, -R), R);
  const float dx = c.drop ? 0.f : fminf(fmaxf(dxr, -R), R);
  const float iy = floorf(dy), ix = floorf(dx);
  c.ly = dy - iy;
  c.lx = dx - ix;
  c.y0 = hq + k / 3 - 1 + (int)iy;
  c.x0 = wq + k % 3 - 1 + (int)ix;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yc = c.y0 + (q >> 1);
    const int xc = c.x0 + (q & 1);
    c.ok[q] = !c.drop && yc >= 0 && yc < H && xc >= 0 && xc < W;
    c.base[q] = c.ok[q] ? img + (long long)yc * W + xc : 0;
  }
  return c;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
  return v;
}

// U[p][n] = sum_o g[p][o] * w[n][o]; g (P, Cout), w (N = 9 Cin, Cout).
__global__ void __launch_bounds__(THREADS)
tap_products_kernel(const float* __restrict__ g, const float* __restrict__ w,
                    float* __restrict__ u, long long P, int N, int Cout) {
  __shared__ float s_g[UT_P][UT_O + 1];
  __shared__ float s_w[UT_O][UT_N + 1];  // transposed: s_w[o][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column lane
  const int ty = tid / 16;  // pixel lane
  const long long p0 = (long long)blockIdx.x * UT_P;
  const int n0 = blockIdx.y * UT_N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int o0 = 0; o0 < Cout; o0 += UT_O) {
    const int o = tid % 32;
    const bool ook = o0 + o < Cout;
#pragma unroll
    for (int r = 0; r < UT_P / WARPS; ++r) {
      const int row = tid / 32 + r * WARPS;
      const long long p = p0 + row;
      s_g[row][o] = (ook && p < P) ? g[p * Cout + o0 + o] : 0.f;
      const int n = n0 + row;
      s_w[o][row] = (ook && n < N) ? w[(long long)n * Cout + o0 + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int oo = 0; oo < UT_O; ++oo) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_g[ty + 16 * i][oo];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_w[oo][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) u[p * N + n] = acc[i][j];
    }
  }
}

// grad_mask and grad_offset: one warp per (pixel, tap).
__global__ void __launch_bounds__(THREADS)
bwd_pom_kernel(const float* __restrict__ x, const float* __restrict__ off,
               const float* __restrict__ mask, const float* __restrict__ u,
               float* __restrict__ go, float* __restrict__ gm, int B, int H, int W,
               int Cin, float R) {
  const long long P = (long long)B * H * W;
  const long long pk = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (pk >= P * KT) return;  // the whole warp leaves together
  const long long p = pk / KT;
  const int k = (int)(pk % KT);
  const int wq = (int)(p % W);
  const int hq = (int)((p / W) % H);
  const long long img = p - (long long)hq * W - wq;
  const Corners c = corners_of(off, p, img, hq, wq, k, H, W, R);
  const float ly = c.ly, lx = c.lx;
  const float* __restrict__ up = u + pk * Cin;

  float ss = 0.f, sy = 0.f, sx = 0.f;
  for (int ch = lane; ch < Cin; ch += 32) {
    const float v00 = c.ok[0] ? x[c.base[0] * Cin + ch] : 0.f;
    const float v01 = c.ok[1] ? x[c.base[1] * Cin + ch] : 0.f;
    const float v10 = c.ok[2] ? x[c.base[2] * Cin + ch] : 0.f;
    const float v11 = c.ok[3] ? x[c.base[3] * Cin + ch] : 0.f;
    const float top = (1.f - lx) * v00 + lx * v01;  // row y0, blended in x
    const float bot = (1.f - lx) * v10 + lx * v11;  // row y0 + 1
    const float s = (1.f - ly) * top + ly * bot;
    const float dsy = bot - top;
    const float dsx = (1.f - ly) * (v01 - v00) + ly * (v11 - v10);
    const float uu = up[ch];
    ss = fmaf(uu, s, ss);
    sy = fmaf(uu, dsy, sy);
    sx = fmaf(uu, dsx, sx);
  }
  ss = warp_sum(ss);
  sy = warp_sum(sy);
  sx = warp_sum(sx);
  if (lane == 0) {
    const float m = mask[p * KT + k];
    gm[pk] = ss;
    go[p * (2 * KT) + 2 * k] = c.in_y ? m * sy : 0.f;
    go[p * (2 * KT) + 2 * k + 1] = c.in_x ? m * sx : 0.f;
  }
}

// Partial grad_weight of one tile (tap k, 64 input channels, 64 output
// channels) over one range of pixels: part[split][k][c][o].
__global__ void __launch_bounds__(THREADS)
bwd_weight_kernel(const float* __restrict__ x, const float* __restrict__ off,
                  const float* __restrict__ mask, const float* __restrict__ g,
                  float* __restrict__ part, int B, int H, int W, int Cin, int Cout,
                  float R, long long pix_per_split) {
  __shared__ long long s_idx[GW_P][4];
  __shared__ float s_cf[GW_P][4];
  __shared__ float s_samp[GW_P][GW_C];
  __shared__ float s_g[GW_P][GW_O];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output channel lane
  const int ty = tid / 16;  // input channel lane
  const int ctiles = (Cin + GW_C - 1) / GW_C;
  const int k = blockIdx.x / ctiles;
  const int c0 = (blockIdx.x % ctiles) * GW_C;
  const int o0 = blockIdx.y * GW_O;
  const int split = blockIdx.z;
  const long long P = (long long)B * H * W;
  const long long pa = split * pix_per_split;
  const long long pb = min(P, pa + pix_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long pbase = pa; pbase < pb; pbase += GW_P) {
    if (tid < GW_P) {
      const long long p = pbase + tid;
      if (p < pb) {
        const int wq = (int)(p % W);
        const int hq = (int)((p / W) % H);
        const long long img = p - (long long)hq * W - wq;
        const Corners c = corners_of(off, p, img, hq, wq, k, H, W, R);
        const float m = mask[p * KT + k];
        const float cw[4] = {(1.f - c.ly) * (1.f - c.lx), (1.f - c.ly) * c.lx,
                             c.ly * (1.f - c.lx), c.ly * c.lx};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s_idx[tid][q] = c.base[q];
          s_cf[tid][q] = c.ok[q] ? cw[q] * m : 0.f;
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          s_idx[tid][q] = 0;
          s_cf[tid][q] = 0.f;
        }
      }
    }
    __syncthreads();
    // a warp gathers 32 consecutive channels of one pixel's corners and
    // loads 32 consecutive output channels of the same pixel's g
#pragma unroll
    for (int r = 0; r < GW_P * GW_C / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int pl = e / GW_C;
      const int cl = e % GW_C;
      float v = 0.f;
      if (c0 + cl < Cin) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float cf = s_cf[pl][q];
          if (cf != 0.f) v = fmaf(cf, x[s_idx[pl][q] * Cin + c0 + cl], v);
        }
      }
      s_samp[pl][cl] = v;
      const long long p = pbase + pl;
      s_g[pl][cl] = (p < pb && o0 + cl < Cout) ? g[p * Cout + o0 + cl] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int pl = 0; pl < GW_P; ++pl) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_samp[pl][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_g[pl][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* __restrict__ dst = part + ((long long)split * KT + k) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + 16 * j;
      if (o < Cout) dst[(long long)c * Cout + o] = acc[i][j];
    }
  }
}

// grad_weight = the partials summed over the splits, in split order.
__global__ void __launch_bounds__(THREADS)
bwd_weight_reduce_kernel(const float* __restrict__ part, float* __restrict__ gw,
                         long long n, int splits) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[(long long)s * n + i];
  gw[i] = v;
}

// grad_x: one warp per input pixel q.
__global__ void __launch_bounds__(THREADS)
bwd_x_kernel(const float* __restrict__ off, const float* __restrict__ mask,
             const float* __restrict__ u, float* __restrict__ gx, int B, int H, int W,
             int Cin, int radius) {
  const long long P = (long long)B * H * W;
  const long long q = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= P) return;  // the whole warp leaves together
  const int qx = (int)(q % W);
  const int qy = (int)((q / W) % H);
  const long long img = q - (long long)qy * W - qx;
  const float R = (float)radius;
  const int win = 2 * radius + 2;  // reach of floor(dy) + corner row: [-R, R + 1]
  const int ncand = win * win;

  for (int c0 = 0; c0 < Cin; c0 += 32 * X_CPL) {
    float acc[X_CPL];
#pragma unroll
    for (int j = 0; j < X_CPL; ++j) acc[j] = 0.f;
    for (int k = 0; k < KT; ++k) {
      const int ki = k / 3, kj = k % 3;
      for (int cb = 0; cb < ncand; cb += 32) {
        const int cand = cb + lane;
        float coef = 0.f;
        long long p = 0;
        if (cand < ncand) {
          // source p whose tap k reads q through corner (a, b) of its window
          const int a = cand / win - radius;
          const int b = cand % win - radius;
          const int py = qy - ki + 1 - a;
          const int px = qx - kj + 1 - b;
          if (py >= 0 && py < H && px >= 0 && px < W) {
            p = img + (long long)py * W + px;
            const Corners c = corners_of(off, p, img, py, px, k, H, W, R);
            const int ry = qy - c.y0, rx = qx - c.x0;
            if (!c.drop && (ry == 0 || ry == 1) && (rx == 0 || rx == 1)) {
              const float wy = ry ? c.ly : 1.f - c.ly;
              const float wx = rx ? c.lx : 1.f - c.lx;
              coef = wy * wx * mask[p * KT + k];
            }
          }
        }
        unsigned hits = __ballot_sync(FULL, coef != 0.f);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          const float cf = __shfl_sync(FULL, coef, src);
          const long long pp = __shfl_sync(FULL, p, src);
          const float* __restrict__ up = u + (pp * KT + k) * Cin;
#pragma unroll
          for (int j = 0; j < X_CPL; ++j) {
            const int ch = c0 + lane + 32 * j;
            if (ch < Cin) acc[j] = fmaf(cf, up[ch], acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < X_CPL; ++j) {
      const int ch = c0 + lane + 32 * j;
      if (ch < Cin) gx[q * Cin + ch] = acc[j];
    }
  }
}

int launch_error() { return (int)cudaGetLastError(); }

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers to
// contiguous fp32 arrays; every launch goes on `stream` and nothing
// synchronises. Each launcher returns cudaGetLastError() after its launches:
// 0 when they were accepted.

// The number of pixel ranges that grad_weight is split into; the caller
// allocates splits * 9 * Cin * Cout floats of scratch for the partials.
extern "C" int dcn_bwd_weight_splits(int B, int H, int W, int Cin, int Cout) {
  const long long P = (long long)B * H * W;
  const long long tiles = (long long)KT * ((Cin + GW_C - 1) / GW_C) * ((Cout + GW_O - 1) / GW_O);
  long long splits = (GW_BLOCKS + tiles - 1) / tiles;
  const long long steps = (P + GW_P - 1) / GW_P;  // at least one step of pixels each
  if (splits > steps) splits = steps;
  if (splits < 1) splits = 1;
  const long long per = ((steps + splits - 1) / splits) * GW_P;
  return (int)((P + per - 1) / per);
}

// u (P, 9, Cin) = the per-tap products W_k g(p).
extern "C" int dcn_tap_products_f32(const void* g, const void* w, void* u, int B, int H,
                                    int W, int Cin, int Cout, void* stream) {
  const long long P = (long long)B * H * W;
  const int N = KT * Cin;
  dim3 grid((unsigned)((P + UT_P - 1) / UT_P), (unsigned)((N + UT_N - 1) / UT_N));
  tap_products_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)w, (float*)u, P, N, Cout);
  return launch_error();
}

// go (B, H, W, 18), gm (B, H, W, 9), gw (3, 3, Cin, Cout) from x, offsets,
// mask, the cotangent g and its tap products u; part holds
// splits * 9 * Cin * Cout floats of scratch.
extern "C" int dcn_bwd_pom_f32(const void* x, const void* off, const void* mask,
                               const void* g, const void* u, void* go, void* gm, void* gw,
                               void* part, int B, int H, int W, int Cin, int Cout,
                               int radius, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long P = (long long)B * H * W;
  const float R = (float)radius;
  bwd_pom_kernel<<<(unsigned)((P * KT + WARPS - 1) / WARPS), THREADS, 0, s>>>(
      (const float*)x, (const float*)off, (const float*)mask, (const float*)u, (float*)go,
      (float*)gm, B, H, W, Cin, R);
  int rc = launch_error();
  if (rc) return rc;
  const long long steps = (P + GW_P - 1) / GW_P;
  const long long per = ((steps + splits - 1) / splits) * GW_P;
  dim3 grid((unsigned)(KT * ((Cin + GW_C - 1) / GW_C)), (unsigned)((Cout + GW_O - 1) / GW_O),
            (unsigned)splits);
  bwd_weight_kernel<<<grid, THREADS, 0, s>>>((const float*)x, (const float*)off,
                                             (const float*)mask, (const float*)g,
                                             (float*)part, B, H, W, Cin, Cout, R, per);
  rc = launch_error();
  if (rc) return rc;
  const long long n = (long long)KT * Cin * Cout;
  bwd_weight_reduce_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      (const float*)part, (float*)gw, n, splits);
  return launch_error();
}

// gx (B, H, W, Cin) from offsets, mask and the tap products u.
extern "C" int dcn_bwd_x_f32(const void* off, const void* mask, const void* u, void* gx,
                             int B, int H, int W, int Cin, int radius, void* stream) {
  const long long P = (long long)B * H * W;
  bwd_x_kernel<<<(unsigned)((P + WARPS - 1) / WARPS), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)off, (const float*)mask, (const float*)u, (float*)gx, B, H, W, Cin,
      radius);
  return launch_error();
}
