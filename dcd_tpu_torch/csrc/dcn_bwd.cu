// Modulated deformable convolution (DCNv2) backward for Hopper (sm_90a), with
// fp32 or bf16 inputs (x, mask, weight, cotangent; offsets fp32 in both).
//
// Replaces two TPU kernels of dcd_tpu/ops/dcn_pallas.py, entered through the
// custom VJP of deform_conv2d_pallas:
//
//  * K2, _bwd_pom_kernel_cw (dcn_pallas.py:859, launched by _bwd_pom_cw
//    :1013): grad_offset, grad_mask and grad_weight. Here: bwd_pom_kernel,
//    bwd_weight_kernel and bwd_weight_reduce_kernel, launched by
//    dcn_bwd_pom_f32 and dcn_bwd_pom_bf16.
//  * K3, _bwd_x_kernel_cw (dcn_pallas.py:1246, launched by _bwd_x_cw
//    :1352): grad_x. Here: bwd_x_kernel, launched by dcn_bwd_x_f32 and
//    dcn_bwd_x_bf16.
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
//   grad_x(q)        = sum_k W_k G_k(q),
//                      G_k(q) = sum_p coef_k(p -> q) mask_k(p) g(p)
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
// What bounds it on this card: operations. Three contractions of
// 2 * 9 * Cin * Cout FLOP per pixel each (U in K2, grad_weight in K2, the
// G-by-W product in K3) run on the tensor cores as 3xTF32 (three TF32
// passes, 495/3 TFLOP/s); the sampling adds some 40 FLOP per pixel, tap and
// input channel in fp32 outside them (67 TFLOP/s). At the model's narrowest
// block (64 -> 64) the whole is still over 20 FLOP per byte of the
// function's inputs and outputs.
//
// Design: implicit GEMMs on mma.sync (3xTF32 m16n8k8, as dcn_fwd.cu, with
// the operands split into TF32 parts by integer operations rather than the
// conversion unit: see split_tf32_int), with every gathered operand built
// in shared memory and nothing of size (pixels, 9, Cin) in device memory.
// The tensor cores truncate as they accumulate, so each K chunk of 32 goes
// into a fresh partial sum that an ordinary rounded add puts into the
// accumulator. No float atomics, and every sum in a fixed order: two runs
// give bitwise equal results.
//  * bwd_pom_kernel (grad_mask, grad_offset): a block owns 64 pixels and one
//    tap; it stages their rows of g once, then for each chunk of 32 input
//    channels computes U's chunk (64 x 32, K = Cout) on the tensor cores
//    into shared memory while the four x corners of each (pixel, channel)
//    load as 16-byte vectors, forms s, ds/dy and ds/dx in fp32 (the walk
//    stays fp32: a bf16 walk cost the TPU 0.59 relative error in
//    grad_offset, dcn_pallas.py:875-879) and adds the three products with U
//    into per-thread sums; the 8 lanes of a pixel sum theirs by a fixed
//    butterfly at the end.
//  * bwd_weight_kernel (grad_weight): a block owns a 64 x 64 tile of
//    grad_weight_k and a range of at most 512 pixels. It computes the
//    corners of the whole range first; then per 32 pixels it writes mask * s
//    into shared memory beside the rows of g and adds (mask s)^T g on the
//    tensor cores (M = Cin, N = Cout, K = pixels) while the next 32 pixels'
//    g (cp.async) and x corners (registers) load. Each range writes its
//    partial, and bwd_weight_reduce_kernel adds the partials in range order.
//    It gathers x a second time rather than sharing bwd_pom_kernel's gather,
//    whose blocks each see one tap and 64 pixels and would leave a partial of
//    all of grad_weight_k per block.
//  * bwd_x_kernel (grad_x), the forward transposed: a block owns an 8 x 8
//    tile of input pixels q and 64 input channels. It computes, in one round
//    of loads, where every source pixel p that can reach the tile (the tile
//    and a halo of R+2 above and left, R+1 below and right) samples for each
//    of the 9 taps. Per tap it lists each q's sources (p, coef * mask) in
//    candidate order (count, scan, fill); per 64 output channels it gathers
//    the rows of G_k = sum over the list of coef * mask * g(p) into shared
//    memory as the A operand, with W_k^T by cp.async as B.
//  Precision. Each kernel is a template on the element type T that it loads
//  (float or __nv_bfloat16) for x, mask, W and g; offsets are fp32 in both.
//  A bf16 value widens to fp32 exactly as it loads (a 16-bit shift), and
//  from there everything is the fp32 kernel's: the operands in shared
//  memory, the walk, ds/dy and ds/dx (fp32, as the TPU kernel keeps them,
//  dcn_pallas.py:875-879), the 3xTF32 products and every sum, in the same
//  order. So the bf16 kernels give bitwise what the fp32 kernels give on the
//  inputs widened to fp32. (A bf16 value is exact in TF32, so two of the
//  three TF32 passes of a bf16 x bf16 product add zeros: a bf16 mma.sync
//  would do those products in one pass. That is later work.) The outputs
//  are fp32; the wrapper casts grad_mask, grad_weight and grad_x to their
//  inputs' type, as the JAX package's _bwd does outside its kernels.
//  Requirements (checked by the wrapper): Cin and Cout multiples of 8; x, g
//  and w 16-byte aligned, offsets 8-byte aligned (bwd_x_kernel reads them
//  in pairs); B*H*W < 2^31. bwd_x_kernel sizes its halo, its lists and its
//  masks of candidate sources from the radius (NW 32-bit words of mask per
//  target quarter: 1 up to radius 4, 2 up to 7, 4 up to MAX_R = 9); the
//  halo and the lists take 212 (2R + 11)^2 bytes of shared memory, which
//  at radius 10 exceeds the 227 KB a block can have on this card.
// wgmma, TMA, warp specialisation and a persistent schedule are later work.

#include <cuda_bf16.h>

#include "dcn_common.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr unsigned FULL = 0xffffffffu;
constexpr int PAD = 4;  // floats of padding per shared-memory row

// bwd_pom_kernel
constexpr int PM = 64;  // pixels per block
constexpr int PC = 32;  // input channels per chunk (U's columns)
constexpr int PO = 32;  // output channels per MMA chunk (U's K)

// bwd_weight_kernel
constexpr int WP = 32;          // pixels per step (the MMA's K)
constexpr int WC = 64;          // input channels per block
constexpr int WO = 64;          // output channels per block
constexpr int WSTR = 72;        // row stride: fragment reads hit 32 banks
constexpr int WR = 512;         // most pixels per range
constexpr int GW_BLOCKS = 528;  // aim: four blocks per SM of 132

// bwd_x_kernel
constexpr int XT = 8;                        // target tile side
constexpr int XM = XT * XT;                  // target pixels per block
constexpr int XN = 64;                       // input channels per block
constexpr int XO = 64;                       // output channels per gather round
constexpr int MAX_R = 9;                     // largest radius the masks of 4 words hold

struct Corners {
  long long base[4];  // flat pixel index of each corner (0 when outside)
  bool ok[4];         // corner inside the image, and the tap not dropped
  float ly, lx;       // fractions, floor convention
  bool in_y, in_x;    // offset inside [-R, R]: the clip passes its gradient
};

// The sample point of output pixel p, tap k: clamp, floor split and corner
// validity exactly as dcn_fwd.cu computes them.
__device__ __forceinline__ Corners corners_at(const float* __restrict__ off, long long p, int k,
                                              int H, int W, float R) {
  const int wq = (int)(p % W);
  const int hq = (int)((p / W) % H);
  const long long img = p - (long long)hq * W - wq;
  Corners c;
  const float dyr = off[p * (2 * KT) + 2 * k];
  const float dxr = off[p * (2 * KT) + 2 * k + 1];
  // a NaN offset drops the tap, as the plain version and the TPU kernel do
  // (fmaxf would turn NaN into -R); its (dy, dx) become 0 so that the
  // indices below stay finite, and every corner is marked outside
  const bool drop = isnan(dyr) || isnan(dxr);
  c.in_y = !drop && dyr >= -R && dyr <= R;
  c.in_x = !drop && dxr >= -R && dxr <= R;
  const float dy = drop ? 0.f : fminf(fmaxf(dyr, -R), R);
  const float dx = drop ? 0.f : fminf(fmaxf(dxr, -R), R);
  const float iy = floorf(dy), ix = floorf(dx);
  c.ly = dy - iy;
  c.lx = dx - ix;
  const int y0 = hq + k / 3 - 1 + (int)iy;
  const int x0 = wq + k % 3 - 1 + (int)ix;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yc = y0 + (q >> 1);
    const int xc = x0 + (q & 1);
    c.ok[q] = !drop && yc >= 0 && yc < H && xc >= 0 && xc < W;
    c.base[q] = c.ok[q] ? img + (long long)yc * W + xc : 0;
  }
  return c;
}

// Loads of the input type, widened to fp32 (a bf16 value by a 16-bit shift,
// exactly).
__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
// four consecutive elements (16 bytes of fp32, 8 of bf16)
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
// four consecutive elements into shared memory as fp32, zeros where !ok
// (src must then still be a valid address): fp32 by cp.async (the caller
// commits and waits), bf16 by a load, a widening and a store
__device__ __forceinline__ void stage4(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok ? 16 : 0);
}
__device__ __forceinline__ void stage4(float* dst, const __nv_bfloat16* src, bool ok) {
  *reinterpret_cast<float4*>(dst) = ok ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void fma4(float4& acc, float c, const float4& v) {
  acc.x = fmaf(c, v.x, acc.x);
  acc.y = fmaf(c, v.y, acc.y);
  acc.z = fmaf(c, v.z, acc.z);
  acc.w = fmaf(c, v.w, acc.w);
}

// One K chunk of 32 of a warp's (16 MT) x (8 NT) output tile on the tensor
// cores, 3xTF32, into a fresh partial that is then added into acc.
// a(m, kk) and b(n, kk) read the operands' fp32 values from shared memory:
// m is the row within the warp tile, n the column, kk in [0, 32).
template <int MT, int NT, typename FA, typename FB>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4], FA a, FB b, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float part[MT][NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < 32; ks += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      split_tf32_int(a(16 * i + g, ks + t), ah[i][0], al[i][0]);
      split_tf32_int(a(16 * i + g + 8, ks + t), ah[i][1], al[i][1]);
      split_tf32_int(a(16 * i + g, ks + t + 4), ah[i][2], al[i][2]);
      split_tf32_int(a(16 * i + g + 8, ks + t + 4), ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split_tf32_int(b(8 * j + g, ks + t), bh[j][0], bl[j][0]);
      split_tf32_int(b(8 * j + g, ks + t + 4), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mma_tf32(part[i][j], al[i], bh[j]);
        mma_tf32(part[i][j], ah[i], bl[j]);
        mma_tf32(part[i][j], ah[i], bh[j]);
      }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] += part[i][j][r];
}

// ---------------------------------------------------------------------------
// grad_mask and grad_offset. Grid (pixel blocks of PM, 9 taps). Dynamic
// shared memory, GS = Cout rounded up to PO, plus PAD:
//   sG [PM][GS]  the block's rows of g
//   sW [PC][GS]  W_k rows of the current channel chunk
//   sU [PM][PC + PAD]  U's chunk
//   s_idx, s_wt, s_in  the corners of the block's pixels for tap k
__host__ __device__ constexpr int pom_row(int Cout) { return (Cout + PO - 1) / PO * PO + PAD; }
__host__ __device__ constexpr int pom_smem_bytes(int Cout) {
  return 4 * ((PM + PC) * pom_row(Cout) + PM * (PC + PAD)) + PM * (16 + 16 + 4);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bwd_pom_kernel(const T* __restrict__ x, const float* __restrict__ off,
               const T* __restrict__ mask, const T* __restrict__ g,
               const T* __restrict__ w, float* __restrict__ go, float* __restrict__ gm,
               int B, int H, int W, int Cin, int Cout, float R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int GS = pom_row(Cout);
  const int CoutP = GS - PAD;
  constexpr int US = PC + PAD;
  float* sG = reinterpret_cast<float*>(smem);
  float* sW = sG + PM * GS;
  float* sU = sW + PC * GS;
  int4* s_idx = reinterpret_cast<int4*>(sU + PM * US);  // corner pixels, -1 outside
  float4* s_wt = reinterpret_cast<float4*>(s_idx + PM);  // ly, lx, mask
  int* s_in = reinterpret_cast<int*>(s_wt + PM);         // bit 0: dy inside the clip, bit 1: dx

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * PM;
  const int k = blockIdx.y;
  const int vpr = CoutP / 4;  // 16-byte vectors per staged row

  for (int e = tid; e < PM * vpr; e += THREADS) {
    const int row = e / vpr, col = (e % vpr) * 4;
    const long long p = p0 + row;
    const bool ok = p < P && col < Cout;
    stage4(sG + row * GS + col, ok ? g + p * Cout + col : g, ok);
  }
  cp_async_commit();
  if (tid < PM) {
    const long long p = p0 + tid;
    int4 idx = make_int4(-1, -1, -1, -1);
    float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
    int in = 0;
    if (p < P) {
      const Corners c = corners_at(off, p, k, H, W, R);
      idx = make_int4(c.ok[0] ? (int)c.base[0] : -1, c.ok[1] ? (int)c.base[1] : -1,
                      c.ok[2] ? (int)c.base[2] : -1, c.ok[3] ? (int)c.base[3] : -1);
      wt = make_float4(c.ly, c.lx, ld1(mask + p * KT + k), 0.f);
      in = (c.in_y ? 1 : 0) | (c.in_x ? 2 : 0);
    }
    s_idx[tid] = idx;
    s_wt[tid] = wt;
    s_in[tid] = in;
  }

  // warps 4 (16 pixels each) x 2 (16 channels each) over U's 64 x 32 chunk
  const int wm = warp >> 1, wn = warp & 1;
  const float* aG = sG + (wm * 16) * GS;
  const float* bW = sW + (wn * 16) * GS;
  // (pixel, 4-channel vector) items of the dot products: 2 per thread; the
  // 8 items of a pixel are 8 consecutive lanes
  float ss[2] = {0.f, 0.f}, sy[2] = {0.f, 0.f}, sx[2] = {0.f, 0.f};

  __syncthreads();  // the corners

  for (int c0 = 0; c0 < Cin; c0 += PC) {
    for (int e = tid; e < PC * vpr; e += THREADS) {
      const int row = e / vpr, col = (e % vpr) * 4;
      const int c = c0 + row;
      const bool ok = c < Cin && col < Cout;
      stage4(sW + row * GS + col, ok ? w + ((long long)k * Cin + c) * Cout + col : w, ok);
    }
    cp_async_commit();
    // this chunk's x corners, (y0, x0), (y0, x0 + 1), (y0 + 1, x0),
    // (y0 + 1, x0 + 1), in flight during U's product
    float4 xv[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * THREADS;
      const int row = e >> 3, c = c0 + 4 * (e & 7);
      const int4 idx = s_idx[row];  // -1 outside the image and past the last pixel
      const int ids[4] = {idx.x, idx.y, idx.z, idx.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xv[j][q] = c < Cin && ids[q] >= 0 ? ld4(x + (long long)ids[q] * Cin + c)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_wait_all();
    __syncthreads();

    // U's chunk: U[p][c] = sum_o g[p][o] W_k[c][o], K = Cout in chunks of PO
    float acc[1][2][4] = {};
    for (int o0 = 0; o0 < CoutP; o0 += PO) {
      mma_chunk<1, 2>(
          acc, [&](int m, int kk) { return aG[m * GS + o0 + kk]; },
          [&](int n, int kk) { return bW[n * GS + o0 + kk]; }, lane);
    }
    {
      const int gq = lane >> 2, t = lane & 3;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* u = sU + (wm * 16 + gq) * US + wn * 16 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(u) = make_float2(acc[0][j][0], acc[0][j][1]);
        *reinterpret_cast<float2*>(u + 8 * US) = make_float2(acc[0][j][2], acc[0][j][3]);
      }
    }
    __syncthreads();

    // the samples, their offset derivatives, and their products with U; the
    // next chunk's copies start only after every thread passed the barrier
    // above, so sW and sU need no barrier after this
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = tid + j * THREADS;
      const int row = e >> 3, v = e & 7;
      const float4 wt = s_wt[row];
      const float4 u = *reinterpret_cast<const float4*>(sU + row * US + 4 * v);
      const float ly = wt.x, lx = wt.y;
      const float4 a = xv[j][0], b = xv[j][1], d = xv[j][2], f = xv[j][3];
      const float v00[4] = {a.x, a.y, a.z, a.w}, v01[4] = {b.x, b.y, b.z, b.w};
      const float v10[4] = {d.x, d.y, d.z, d.w}, v11[4] = {f.x, f.y, f.z, f.w};
      const float uu[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float top = (1.f - lx) * v00[i] + lx * v01[i];  // row y0, blended in x
        const float bot = (1.f - lx) * v10[i] + lx * v11[i];  // row y0 + 1
        const float s = (1.f - ly) * top + ly * bot;
        const float dsy = bot - top;
        const float dsx = (1.f - ly) * (v01[i] - v00[i]) + ly * (v11[i] - v10[i]);
        ss[j] = fmaf(uu[i], s, ss[j]);
        sy[j] = fmaf(uu[i], dsy, sy[j]);
        sx[j] = fmaf(uu[i], dsx, sx[j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int s = 4; s > 0; s >>= 1) {
      ss[j] += __shfl_xor_sync(FULL, ss[j], s);
      sy[j] += __shfl_xor_sync(FULL, sy[j], s);
      sx[j] += __shfl_xor_sync(FULL, sx[j], s);
    }
    const int row = (tid + j * THREADS) >> 3;
    const long long p = p0 + row;
    if ((lane & 7) == 0 && p < P) {
      const float m = s_wt[row].z;
      const int in = s_in[row];
      gm[p * KT + k] = ss[j];
      go[p * (2 * KT) + 2 * k] = (in & 1) ? m * sy[j] : 0.f;
      go[p * (2 * KT) + 2 * k + 1] = (in & 2) ? m * sx[j] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Partial grad_weight of one tile (tap k, WC input channels, WO output
// channels) over one range of at most WR pixels: part[split][k][c][o]. The
// corners of the whole range come first, in one round; then per step of WP
// pixels the next step's g rows (cp.async, two buffers) and x corners
// (registers) are in flight while this step's MMAs run.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bwd_weight_kernel(const T* __restrict__ x, const float* __restrict__ off,
                  const T* __restrict__ mask, const T* __restrict__ g,
                  float* __restrict__ part, int B, int H, int W, int Cin, int Cout, float R,
                  int pix_per_split) {
  __shared__ __align__(16) float sMS[WP][WSTR];     // mask * s: [pixel][input channel]
  __shared__ __align__(16) float sG[2][WP][WSTR];   // g: [pixel][output channel]
  __shared__ int4 s_idx[WR];                        // corner pixels (0 where the coefficient is 0)
  __shared__ float4 s_cf[WR];                       // coef * mask per corner
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ctiles = (Cin + WC - 1) / WC;
  const int k = blockIdx.x / ctiles;
  const int c0 = (blockIdx.x % ctiles) * WC;
  const int o0 = blockIdx.y * WO;
  const long long P = (long long)B * H * W;
  const long long pa = (long long)blockIdx.z * pix_per_split;
  const int np = (int)min((long long)pix_per_split, P - pa);  // pixels of this range
  // warps 2 (32 input channels each) x 4 (16 output channels each)
  const int wm = warp >> 2, wn = warp & 3;

  for (int i = tid; i < np; i += THREADS) {
    const long long p = pa + i;
    const Corners c = corners_at(off, p, k, H, W, R);
    const float m = ld1(mask + p * KT + k);
    const float cw[4] = {(1.f - c.ly) * (1.f - c.lx), (1.f - c.ly) * c.lx,
                         c.ly * (1.f - c.lx), c.ly * c.lx};
    s_idx[i] = make_int4((int)c.base[0], (int)c.base[1], (int)c.base[2], (int)c.base[3]);
    s_cf[i] = make_float4(c.ok[0] ? cw[0] * m : 0.f, c.ok[1] ? cw[1] * m : 0.f,
                          c.ok[2] ? cw[2] * m : 0.f, c.ok[3] ? cw[3] * m : 0.f);
  }

  // a row of 16 threads handles 64 consecutive channels of one pixel
  auto load_g = [&](int step, int buf) {
#pragma unroll
    for (int j = 0; j < WP * WO / 4 / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int row = e >> 4, col = (e & 15) * 4;
      const int i = step * WP + row;
      const bool ok = i < np && o0 + col < Cout;
      stage4(&sG[buf][row][col], ok ? g + (pa + i) * Cout + o0 + col : g, ok);
    }
    cp_async_commit();
  };
  float4 xv[WP * WC / 4 / THREADS][4];
  auto gather = [&](int step) {
#pragma unroll
    for (int j = 0; j < WP * WC / 4 / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int i = step * WP + (e >> 4), c = c0 + (e & 15) * 4;
      const bool ok = i < np && c < Cin;
      const int4 idx = ok ? s_idx[i] : make_int4(0, 0, 0, 0);
      const float4 cf = ok ? s_cf[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const int ids[4] = {idx.x, idx.y, idx.z, idx.w};
      const float cfs[4] = {cf.x, cf.y, cf.z, cf.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xv[j][q] = cfs[q] != 0.f ? ld4(x + (long long)ids[q] * Cin + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  float acc[2][2][4] = {};
  const int steps = (np + WP - 1) / WP;
  load_g(0, 0);
  __syncthreads();  // the corners
  gather(0);
  for (int st = 0; st < steps; ++st) {
    // mask * s of this step, summed over the corners in order
#pragma unroll
    for (int j = 0; j < WP * WC / 4 / THREADS; ++j) {
      const int e = tid + j * THREADS;
      const int i = st * WP + (e >> 4);
      const float4 cf = i < np ? s_cf[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float cfs[4] = {cf.x, cf.y, cf.z, cf.w};
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (cfs[q] != 0.f) fma4(v, cfs[q], xv[j][q]);
      *reinterpret_cast<float4*>(&sMS[e >> 4][(e & 15) * 4]) = v;
    }
    const bool more = st + 1 < steps;
    if (more) {
      load_g(st + 1, (st + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (more) gather(st + 1);
    // (mask s)^T g: M = input channels, N = output channels, K = pixels
    const int buf = st & 1;
    mma_chunk<2, 2>(
        acc, [&](int m, int kk) { return sMS[kk][wm * 32 + m]; },
        [&](int n, int kk) { return sG[buf][kk][wn * 16 + n]; }, lane);
    __syncthreads();
  }
  float* __restrict__ dst = part + ((long long)blockIdx.z * KT + k) * Cin * Cout;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * 32 + 16 * i + gq + 8 * h;
        const int o = o0 + wn * 16 + 8 * j + 2 * t;
        if (c < Cin && o < Cout)
          *reinterpret_cast<float2*>(dst + (long long)c * Cout + o) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
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

// ---------------------------------------------------------------------------
// grad_x. Grid (8 x 8 tiles of input pixels over B images, Cin / XN).
// Dynamic shared memory, sized by the radius (x_smem_bytes; HS the halo's
// side): s_frac [9][HS * HS] and s_pos [9][HS * HS], the halo's sources for
// every tap, then s_hp [4 HS * HS] and s_hc [4 HS * HS], one tap's lists
// (each source reaches at most 4 targets). NW: 32-bit words of the mask of
// candidate hits per target quarter, which holds ceil(win / 4) * win bits
// (win = 2R + 2): 1 word up to radius 4, 2 up to 7, 4 up to 9.
__host__ __device__ constexpr int x_halo(int radius) { return (XT + 2 * radius + 3) * (XT + 2 * radius + 3); }
__host__ __device__ constexpr int x_smem_bytes(int radius) { return x_halo(radius) * (KT * (16 + 4) + 4 * (4 + 4)); }
__host__ __device__ constexpr int x_mask_words(int radius) {
  return ((2 * radius + 2 + 3) / 4 * (2 * radius + 2) + 31) / 32;
}

template <typename T, int NW>
__global__ void __launch_bounds__(THREADS, 2)
bwd_x_kernel(const float* __restrict__ off, const T* __restrict__ mask,
             const T* __restrict__ g, const T* __restrict__ w, float* __restrict__ gx,
             int B, int H, int W, int Cin, int Cout, int radius) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cnt[XM];
  __shared__ int s_start[XM + 1];
  __shared__ __align__(16) float sA[XM][XO + PAD];  // G_k's chunk: [target][output channel]
  __shared__ __align__(16) float sB[XN][XO + PAD];  // W_k's chunk: [input channel][output channel]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + XT - 1) / XT, tiles_y = (H + XT - 1) / XT;
  const int img = blockIdx.x / (tiles_x * tiles_y);
  const int rem = blockIdx.x % (tiles_x * tiles_y);
  const int ty0 = (rem / tiles_x) * XT, tx0 = (rem % tiles_x) * XT;
  const int c0 = blockIdx.y * XN;
  const float R = (float)radius;
  const int HS = XT + 2 * radius + 3;        // halo side
  const int HS2 = HS * HS;
  const int hy0 = ty0 - radius - 2, hx0 = tx0 - radius - 2;
  const int win = 2 * radius + 2;            // sources per axis that can reach a pixel
  const long long ibase = (long long)img * H * W;
  float4* s_frac = reinterpret_cast<float4*>(smem);          // ly, lx, mask
  int* s_pos = reinterpret_cast<int*>(s_frac + KT * HS2);     // top-left corner, packed; -1: none
  int* s_hp = s_pos + KT * HS2;                               // sources of each target, in target order
  float* s_hc = reinterpret_cast<float*>(s_hp + 4 * HS2);     // their coef * mask

  // 1. where each source of the halo samples, for every tap: one round of
  // loads (a source's 18 offsets and 9 mask values)
  for (int s = tid; s < HS2; s += THREADS) {
    const int hy = hy0 + s / HS, hx = hx0 + s % HS;
    if (hy >= 0 && hy < H && hx >= 0 && hx < W) {
      const long long p = ibase + (long long)hy * W + hx;
      float2 o2[KT];
      float mk[KT];
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        o2[k] = __ldg(reinterpret_cast<const float2*>(off + p * (2 * KT)) + k);
        mk[k] = ld1(mask + p * KT + k);
      }
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        int pos = -1;
        float4 fr = make_float4(0.f, 0.f, 0.f, 0.f);
        // a NaN offset drops the tap; clamp and floor split as corners_at
        if (!(isnan(o2[k].x) || isnan(o2[k].y))) {
          const float dy = fminf(fmaxf(o2[k].x, -R), R);
          const float dx = fminf(fmaxf(o2[k].y, -R), R);
          const float iy = floorf(dy), ix = floorf(dx);
          const int y0 = hy + k / 3 - 1 + (int)iy;
          const int x0 = hx + k % 3 - 1 + (int)ix;
          pos = ((y0 - ty0 + 64) << 8) | (x0 - tx0 + 64);
          fr = make_float4(dy - iy, dx - ix, mk[k], 0.f);
        }
        s_pos[k * HS2 + s] = pos;
        s_frac[k * HS2 + s] = fr;
      }
    } else {
#pragma unroll
      for (int k = 0; k < KT; ++k) s_pos[k * HS2 + s] = -1;
    }
  }
  __syncthreads();

  // the list: 4 threads per target, quarter j the candidate rows j, j + 4, ...
  const int tq = tid >> 2, quarter = tid & 3;
  const int qly = tq / XT, qlx = tq % XT;
  const bool qok = ty0 + qly < H && tx0 + qlx < W;

  // warps 2 (32 targets each) x 4 (16 input channels each)
  const int wm = warp >> 2, wn = warp & 3;
  float acc[2][2][4] = {};

  for (int k = 0; k < KT; ++k) {
    const int ki = k / 3, kj = k % 3;
    const int* pos_k = s_pos + k * HS2;
    const float4* frac_k = s_frac + k * HS2;
    // 2. each target's sources p (coef != 0) in candidate order: count,
    // scan, fill. Candidate (a, b) is the source at row qy - ki - R + a,
    // column qx - kj - R + b; a target's quarter j takes the rows a = j,
    // j + 4, ... (at most ceil(win / 4) rows of win: NW words of hits).
    auto coef_of = [&](int s, int pos) {
      const int ry = qly + 64 - (pos >> 8), rx = qlx + 64 - (pos & 255);
      if ((unsigned)ry > 1u || (unsigned)rx > 1u) return 0.f;
      const float4 fr = frac_k[s];
      const float wy = ry ? fr.x : 1.f - fr.x;
      const float wx = rx ? fr.y : 1.f - fr.y;
      return wy * wx * fr.z;
    };
    const int s0 = (qly - ki + 2 + quarter) * HS + (qlx - kj + 2);  // candidate (quarter, 0)
    unsigned hits[NW] = {};
    if (qok) {
      for (int a = quarter, bit = 0; a < win; a += 4, bit += win)
        for (int b = 0; b < win; ++b) {
          const int s = s0 + (a - quarter) * HS + b;
          const int pos = pos_k[s];
          if (pos >= 0 && coef_of(s, pos) != 0.f) {
            if constexpr (NW == 1)
              hits[0] |= 1u << (bit + b);
            else
              hits[(bit + b) >> 5] |= 1u << ((bit + b) & 31);
          }
        }
    }
    int n = 0;
#pragma unroll
    for (int wd = 0; wd < NW; ++wd) n += __popc(hits[wd]);
    int incl = n;
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d, 4);
      if (quarter >= d) incl += v;
    }
    if (quarter == 3) s_cnt[tq] = incl;
    __syncthreads();
    if (warp == 0) {
      const int a = s_cnt[2 * lane], b = s_cnt[2 * lane + 1];
      int scan = a + b;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, scan, d);
        if (lane >= d) scan += v;
      }
      s_start[2 * lane] = scan - a - b;
      s_start[2 * lane + 1] = scan - b;
      if (lane == 31) s_start[XM] = scan;
    }
    __syncthreads();
    {
      int out = s_start[tq] + incl - n;
      // the source's pixel: row qy - ki - R + a, column qx - kj - R + b
      const long long src0 =
          ibase + (long long)(ty0 + qly - ki - radius + quarter) * W + tx0 + qlx - kj - radius;
#pragma unroll
      for (int wd = 0; wd < NW; ++wd)
        for (unsigned h = hits[wd]; h; h &= h - 1) {
          const int bit = 32 * wd + __ffs(h) - 1;
          const int r = bit / win, b = bit % win;  // row a = quarter + 4 r
          const int s = s0 + 4 * r * HS + b;
          s_hp[out] = (int)(src0 + (long long)(4 * r) * W + b);
          s_hc[out] = coef_of(s, pos_k[s]);
          ++out;
        }
    }
    __syncthreads();

    // 3. G_k's rows against W_k^T, XO output channels per round
    for (int o0 = 0; o0 < Cout; o0 += XO) {
#pragma unroll
      for (int j = 0; j < XN * XO / 4 / THREADS; ++j) {
        const int e = tid + j * THREADS;
        const int row = e / (XO / 4), col = (e % (XO / 4)) * 4;
        const int c = c0 + row, o = o0 + col;
        const bool ok = c < Cin && o < Cout;
        stage4(&sB[row][col], ok ? w + ((long long)k * Cin + c) * Cout + o : w, ok);
      }
      cp_async_commit();
      // two (target, 4-channel vector) items at a time, the first four
      // sources of each in flight together; sums in list order
#pragma unroll
      for (int jp = 0; jp < XM * XO / 4 / THREADS; jp += 2) {
        int h[2], h1[2], row[2], col[2];
        float cf[2][4];
        float4 gv[2][4], v[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = tid + (jp + i) * THREADS;
          row[i] = e / (XO / 4);
          col[i] = (e % (XO / 4)) * 4;
          h[i] = s_start[row[i]];
          h1[i] = o0 + col[i] < Cout ? s_start[row[i] + 1] : h[i];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool ok = h[i] + u < h1[i];
            cf[i][u] = ok ? s_hc[h[i] + u] : 0.f;
            gv[i][u] = ok ? ld4(g + (long long)s_hp[h[i] + u] * Cout + o0 + col[i])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 4; ++u) fma4(v[i], cf[i][u], gv[i][u]);
          for (int hh = h[i] + 4; hh < h1[i]; ++hh)
            fma4(v[i], s_hc[hh], ld4(g + (long long)s_hp[hh] * Cout + o0 + col[i]));
          *reinterpret_cast<float4*>(&sA[row[i]][col[i]]) = v[i];
        }
      }
      cp_async_wait_all();
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < XO; kc += 32)
        mma_chunk<2, 2>(
            acc, [&](int m, int kk) { return sA[wm * 32 + m][kc + kk]; },
            [&](int n, int kk) { return sB[wn * 16 + n][kc + kk]; }, lane);
      __syncthreads();
    }
  }

  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm * 32 + 16 * i + gq + 8 * h;
      const int qy = ty0 + row / XT, qx = tx0 + row % XT;
      if (qy >= H || qx >= W) continue;
      const long long q = ibase + (long long)qy * W + qx;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + wn * 16 + 8 * j + 2 * t;
        if (c < Cin)
          *reinterpret_cast<float2*>(gx + q * Cin + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

int launch_error() { return (int)cudaGetLastError(); }

// The pixels of each range of bwd_weight_kernel: enough ranges for
// GW_BLOCKS blocks, at least one step and at most WR pixels each.
int weight_range(long long P, int Cin, int Cout) {
  const long long tiles = (long long)KT * ((Cin + WC - 1) / WC) * ((Cout + WO - 1) / WO);
  const long long steps = (P + WP - 1) / WP;
  long long splits = (GW_BLOCKS + tiles - 1) / tiles;
  if (splits > steps) splits = steps;
  const long long per = ((steps + splits - 1) / splits) * WP;
  return (int)(per < WR ? per : WR);
}

template <typename T>
int bwd_pom(const void* x, const void* off, const void* mask, const void* g, const void* w,
            void* go, void* gm, void* gw, void* part, int B, int H, int W, int Cin, int Cout,
            int radius, int splits, cudaStream_t s) {
  const long long P = (long long)B * H * W;
  const float R = (float)radius;
  const int bytes = pom_smem_bytes(Cout);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(bwd_pom_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  bwd_pom_kernel<T><<<dim3((unsigned)((P + PM - 1) / PM), KT), THREADS, bytes, s>>>(
      (const T*)x, (const float*)off, (const T*)mask, (const T*)g, (const T*)w, (float*)go,
      (float*)gm, B, H, W, Cin, Cout, R);
  int rc = launch_error();
  if (rc) return rc;
  const int per = weight_range(P, Cin, Cout);
  dim3 grid((unsigned)(KT * ((Cin + WC - 1) / WC)), (unsigned)((Cout + WO - 1) / WO),
            (unsigned)splits);
  bwd_weight_kernel<T><<<grid, THREADS, 0, s>>>((const T*)x, (const float*)off, (const T*)mask,
                                                (const T*)g, (float*)part, B, H, W, Cin, Cout, R,
                                                per);
  rc = launch_error();
  if (rc) return rc;
  const long long n = (long long)KT * Cin * Cout;
  bwd_weight_reduce_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      (const float*)part, (float*)gw, n, splits);
  return launch_error();
}

template <typename T, int NW>
int bwd_x_words(const void* off, const void* mask, const void* g, const void* w, void* gx,
                int B, int H, int W, int Cin, int Cout, int radius, cudaStream_t s) {
  const int bytes = x_smem_bytes(radius);
  const cudaError_t e =
      cudaFuncSetAttribute(bwd_x_kernel<T, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)(B * ((H + XT - 1) / XT) * ((W + XT - 1) / XT));
  bwd_x_kernel<T, NW><<<dim3(tiles, (unsigned)((Cin + XN - 1) / XN)), THREADS, bytes, s>>>(
      (const float*)off, (const T*)mask, (const T*)g, (const T*)w, (float*)gx, B, H, W, Cin, Cout,
      radius);
  return launch_error();
}

template <typename T>
int bwd_x(const void* off, const void* mask, const void* g, const void* w, void* gx, int B, int H,
          int W, int Cin, int Cout, int radius, cudaStream_t s) {
  if (radius < 0 || radius > MAX_R) return (int)cudaErrorInvalidValue;
  const int words = x_mask_words(radius);
  if (words == 1) return bwd_x_words<T, 1>(off, mask, g, w, gx, B, H, W, Cin, Cout, radius, s);
  if (words == 2) return bwd_x_words<T, 2>(off, mask, g, w, gx, B, H, W, Cin, Cout, radius, s);
  return bwd_x_words<T, 4>(off, mask, g, w, gx, B, H, W, Cin, Cout, radius, s);
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers to
// contiguous arrays: offsets and every output fp32, x, mask, g and w of the
// entry point's type; every launch goes on `stream` and nothing
// synchronises. Each launcher returns cudaGetLastError() after its launches:
// 0 when they were accepted.

// The number of pixel ranges that grad_weight is split into; the caller
// allocates splits * 9 * Cin * Cout floats of scratch for the partials.
extern "C" int dcn_bwd_weight_splits(int B, int H, int W, int Cin, int Cout) {
  const long long P = (long long)B * H * W;
  return (int)((P + weight_range(P, Cin, Cout) - 1) / weight_range(P, Cin, Cout));
}

// go (B, H, W, 18), gm (B, H, W, 9), gw (3, 3, Cin, Cout) from x, offsets,
// mask, the cotangent g and the weight w (3, 3, Cin, Cout); part holds
// splits * 9 * Cin * Cout floats of scratch.
extern "C" int dcn_bwd_pom_f32(const void* x, const void* off, const void* mask,
                               const void* g, const void* w, void* go, void* gm, void* gw,
                               void* part, int B, int H, int W, int Cin, int Cout,
                               int radius, int splits, void* stream) {
  return bwd_pom<float>(x, off, mask, g, w, go, gm, gw, part, B, H, W, Cin, Cout, radius, splits,
                        (cudaStream_t)stream);
}
extern "C" int dcn_bwd_pom_bf16(const void* x, const void* off, const void* mask,
                                const void* g, const void* w, void* go, void* gm, void* gw,
                                void* part, int B, int H, int W, int Cin, int Cout,
                                int radius, int splits, void* stream) {
  return bwd_pom<__nv_bfloat16>(x, off, mask, g, w, go, gm, gw, part, B, H, W, Cin, Cout, radius,
                                splits, (cudaStream_t)stream);
}

// gx (B, H, W, Cin) from offsets, mask, the cotangent g and the weight w.
extern "C" int dcn_bwd_x_f32(const void* off, const void* mask, const void* g, const void* w,
                             void* gx, int B, int H, int W, int Cin, int Cout, int radius,
                             void* stream) {
  return bwd_x<float>(off, mask, g, w, gx, B, H, W, Cin, Cout, radius, (cudaStream_t)stream);
}
extern "C" int dcn_bwd_x_bf16(const void* off, const void* mask, const void* g, const void* w,
                              void* gx, int B, int H, int W, int Cin, int Cout, int radius,
                              void* stream) {
  return bwd_x<__nv_bfloat16>(off, mask, g, w, gx, B, H, W, Cin, Cout, radius,
                              (cudaStream_t)stream);
}
