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
// offsets (off[..., 2k] = dy, off[..., 2k+1] = dx). A tap whose dy or dx is
// NaN is dropped, as the TPU kernel's jnp.clip and the plain version drop it.
// The TPU kernel walked a (2R+2)^2 window of static shifts because gathers
// were scalarised there; on this card a gather is an ordinary vector load,
// so the kernel gathers the four corners directly.
//
// What bounds it on this card. As a product it is an implicit GEMM with
// M = pixels, N = Cout and K = 9 Cin: 2 * 9 * Cin * Cout FLOP per pixel
// against (Cin + 27 + Cout) values read and written once. In bf16 on the
// tensor cores (989 TFLOP/s over 3.35 TB/s) the narrow blocks are bound by
// bytes and the wide ones by operations; at the main path's batch of 2 both
// bounds are a few microseconds per launch, and what sets the pace is the
// latency of the gather: 4 corner reads per (pixel, tap, channel) from L2.
//
// Design:
//  * A block owns BM pixels (flat over B*H*W) times BN output channels; the
//    tile is picked per shape (dcn_fwd_tile_m/n) so that every DCN shape of
//    the model launches at least two blocks per SM at batch 2. No split of
//    K, no atomics: two runs give bitwise equal results.
//  * First, one pass computes the four corner indices and coef * mask of
//    all 9 taps for the block's pixels into shared memory, behind one
//    barrier. NaN taps get coefficient 0 here.
//  * The K loop walks (tap, 128-byte chunk of input channels): 64 bf16 or
//    32 fp32 channels. Each thread gathers whole 16-byte vectors (8 bf16 or
//    4 fp32 channels of one corner; 8 threads read one corner's 128-byte
//    line), blends the four corners in fp32, rounds to the input type (as
//    the TPU kernel rounds its walk to the weight type before the MXU,
//    dcn_pallas.py:488-494) and stores the row into shared memory with 16
//    bytes of padding per row, so fragment reads hit 32 distinct banks.
//    The matching W_k slice comes in by cp.async.
//  * Two stages: the corner loads and the cp.async of chunk i+1 are issued
//    before the MMAs of chunk i and consumed after them, so their latency
//    hides behind the tensor cores; one barrier per chunk.
//  * The product is mma.sync on the tensor cores with fp32 accumulators:
//    bf16 m16n8k16 (A by ldmatrix, B by ldmatrix.trans from the row-major
//    W_k slice); fp32 inputs by 3xTF32 m16n8k8 (each operand split into a
//    TF32 high part and a TF32 remainder; lo*hi + hi*lo + hi*hi), which keeps
//    about fp32's accuracy. The tensor cores truncate as they accumulate, so
//    each chunk's products go into a fresh partial sum that is then added
//    into the accumulator with an ordinary rounded add (without that, the
//    bias reached 3e-5 of the output's scale over 9 * 512 terms).
//    mma.sync rather than wgmma: the A tile is written by the gather, 16 to
//    64 rows at a time, in a layout this kernel chooses; wgmma wants 64-row
//    warpgroup tiles and descriptor-swizzled shared memory, and at batch 2
//    the gather, not the MMA rate, sets the pace. wgmma, TMA and a
//    persistent schedule are later work.
//  * Bias is added in fp32 and the tile stored NHWC in the input type.
//  Requirements (checked by the wrapper): Cin and Cout multiples of 8, x and
//  w 16-byte aligned, B*H*W < 2^31.

#include <cuda_bf16.h>

#include "dcn_common.cuh"

namespace {

constexpr int THREADS = 256;      // 8 warps
constexpr int ROW_BYTES = 128;    // one chunk of a pixel's channels
constexpr int VEC = 16;           // bytes per vector load
constexpr int VPR = ROW_BYTES / VEC;  // vectors per chunk row
constexpr int A_PAD = 16;         // bytes of padding per sample row
constexpr int B_PAD = 8;          // elements of padding per weight row

template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> { static constexpr int BK = 64; };
template <> struct Elem<float> { static constexpr int BK = 32; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// the elements of a 16-byte vector, as fp32
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8], __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4], float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], __nv_bfloat16) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}
__device__ __forceinline__ uint4 pack(const float (&f)[4], float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T, int BM, int BN>
struct Smem {
  static constexpr int BK = Elem<T>::BK;
  static constexpr int ASTR = (ROW_BYTES + A_PAD) / (int)sizeof(T);  // sample row, elements
  static constexpr int BSTR = BN + B_PAD;                             // weight row, elements
  static constexpr int CORNERS = KT * BM * 32;  // int4 indices + float4 coefficients
  static constexpr int A = 2 * BM * ASTR * (int)sizeof(T);
  static constexpr int B = 2 * BK * BSTR * (int)sizeof(T);
  static constexpr int BYTES = CORNERS + A + B;
};

// BM x BN output tile, 8 warps as WM x WN, each a (BM/WM) x (BN/WN) tile of
// 16 x 8 MMA tiles.
template <typename T, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 ? 2 : 1)
dcn_fwd_kernel(const T* __restrict__ x, const float* __restrict__ off,
               const T* __restrict__ mask, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ out, int B, int H, int W,
               int Cin, int Cout, float R) {
  using S = Smem<T, BM, BN>;
  constexpr int BK = S::BK;
  constexpr int ASTR = S::ASTR, BSTR = S::BSTR;
  constexpr int EPV = VEC / (int)sizeof(T);  // elements per vector
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(WM * WN == THREADS / 32, "8 warps");
  static_assert(MT >= 1 && NT >= 1 && WTM % 16 == 0 && WTN % 8 == 0, "warp tile");
  constexpr int AVEC = BM * VPR;  // sample vectors per chunk
  constexpr int AV_PER_T = (AVEC + THREADS - 1) / THREADS;
  constexpr int BVPR = BN * (int)sizeof(T) / VEC;  // vectors per weight row
  constexpr int BVEC = BK * BVPR;
  static_assert(BVEC % THREADS == 0, "weight tile in whole vectors per thread");
  constexpr int BV_PER_T = BVEC / THREADS;

  extern __shared__ __align__(16) unsigned char smem[];
  int4* s_idx = reinterpret_cast<int4*>(smem);          // [KT][BM] corner pixels
  float4* s_cf = reinterpret_cast<float4*>(s_idx + KT * BM);  // [KT][BM] coef * mask
  T* s_a = reinterpret_cast<T*>(smem + S::CORNERS);     // [2][BM][ASTR] samples
  T* s_b = reinterpret_cast<T*>(smem + S::CORNERS + S::A);  // [2][BK][BSTR] W_k slice

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // 1. corners and coefficients of all 9 taps of the tile's pixels
  for (int e = tid; e < KT * BM; e += THREADS) {
    const int k = e / BM, pl = e % BM;
    const long long p = p0 + pl;
    int idx[4] = {0, 0, 0, 0};
    float cf[4] = {0.f, 0.f, 0.f, 0.f};
    if (p < P) {
      const float dyr = off[p * (2 * KT) + 2 * k];
      const float dxr = off[p * (2 * KT) + 2 * k + 1];
      if (!(isnan(dyr) || isnan(dxr))) {  // a NaN tap keeps coefficient 0
        const int wq = (int)(p % W);
        const int hq = (int)((p / W) % H);
        const long long img = p - (long long)hq * W - wq;
        const float dy = fminf(fmaxf(dyr, -R), R);
        const float dx = fminf(fmaxf(dxr, -R), R);
        const float iy = floorf(dy), ix = floorf(dx);
        const float ly = dy - iy, lx = dx - ix;
        const int y0 = hq + k / 3 - 1 + (int)iy;
        const int x0 = wq + k % 3 - 1 + (int)ix;
        const float m = to_f32(mask[p * KT + k]);
        const float cw[4] = {(1.f - ly) * (1.f - lx), (1.f - ly) * lx, ly * (1.f - lx),
                             ly * lx};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int yc = y0 + (c >> 1);
          const int xc = x0 + (c & 1);
          if (yc >= 0 && yc < H && xc >= 0 && xc < W) {
            idx[c] = (int)(img + (long long)yc * W + xc);
            cf[c] = cw[c] * m;
          }
        }
      }
    }
    s_idx[e] = make_int4(idx[0], idx[1], idx[2], idx[3]);
    s_cf[e] = make_float4(cf[0], cf[1], cf[2], cf[3]);
  }
  __syncthreads();

  const int nc = (Cin + BK - 1) / BK;  // chunks per tap
  const int nchunks = KT * nc;

  // 2. the stages: gathered corners in registers, blended into s_a; W_k by cp.async
  uint4 corner[AV_PER_T][4];
  float4 coef[AV_PER_T];

  auto load_b = [&](int i, int buf) {
    const int k = i / nc, c0 = (i % nc) * BK;
    T* dst0 = s_b + buf * BK * BSTR;
#pragma unroll
    for (int j = 0; j < BV_PER_T; ++j) {
      const int e = tid + j * THREADS;
      const int row = e / BVPR, col = (e % BVPR) * EPV;
      const int c = c0 + row, n = n0 + col;
      const bool ok = c < Cin && n < Cout;
      const T* src = ok ? w + ((long long)k * Cin + c) * Cout + n : w;
      cp_async16(dst0 + row * BSTR + col, src, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  auto gather = [&](int i) {
    const int k = i / nc, c0 = (i % nc) * BK;
#pragma unroll
    for (int j = 0; j < AV_PER_T; ++j) {
      const int e = tid + j * THREADS;
      float4 cf = make_float4(0.f, 0.f, 0.f, 0.f);
      int4 idx = make_int4(0, 0, 0, 0);
      const int c = c0 + (e % VPR) * EPV;
      if (e < AVEC && c < Cin) {
        cf = s_cf[k * BM + e / VPR];
        idx = s_idx[k * BM + e / VPR];
      }
      coef[j] = cf;
      const float cfs[4] = {cf.x, cf.y, cf.z, cf.w};
      const int ids[4] = {idx.x, idx.y, idx.z, idx.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        corner[j][q] = cfs[q] != 0.f
                           ? __ldg(reinterpret_cast<const uint4*>(x + (long long)ids[q] * Cin + c))
                           : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  auto blend = [&](int buf) {
    T* dst0 = s_a + buf * BM * ASTR;
#pragma unroll
    for (int j = 0; j < AV_PER_T; ++j) {
      const int e = tid + j * THREADS;
      if (e >= AVEC) continue;
      const float cfs[4] = {coef[j].x, coef[j].y, coef[j].z, coef[j].w};
      float acc[EPV], v[EPV];
#pragma unroll
      for (int i = 0; i < EPV; ++i) acc[i] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        unpack(corner[j][q], v, T());
#pragma unroll
        for (int i = 0; i < EPV; ++i) acc[i] = fmaf(cfs[q], v[i], acc[i]);
      }
      *reinterpret_cast<uint4*>(dst0 + (e / VPR) * ASTR + (e % VPR) * EPV) = pack(acc, T());
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][b][r] = 0.f;

  auto compute = [&](int buf) {
    const T* sa = s_a + buf * BM * ASTR + (wm * WTM) * ASTR;
    const T* sb = s_b + buf * BK * BSTR + wn * WTN;
    if constexpr (BF16) {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t fa[MT][4], fb[NT][2];
#pragma unroll
        for (int a = 0; a < MT; ++a)
          ldmatrix_x4(fa[a], sa + (a * 16 + (lane & 15)) * ASTR + ks + (lane >> 4) * 8);
#pragma unroll
        for (int b = 0; b < NT; ++b) ldmatrix_x2_trans(fb[b], sb + (ks + (lane & 15)) * BSTR + b * 8);
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int b = 0; b < NT; ++b) mma_bf16(acc[a][b], fa[a], fb[b]);
      }
    } else {
      // the tensor cores add each product into the accumulator with
      // truncation, a bias that grows with the number of MMAs into it: a
      // chunk's 12 MMAs go into a fresh partial sum, which is added into
      // acc with a rounded fp32 add
      float part[MT][NT][4];
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b)
#pragma unroll
          for (int r = 0; r < 4; ++r) part[a][b][r] = 0.f;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 8) {
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          const T* r0 = sa + (a * 16 + g) * ASTR + ks + t;
          split_tf32(to_f32(r0[0]), ah[a][0], al[a][0]);
          split_tf32(to_f32(r0[8 * ASTR]), ah[a][1], al[a][1]);
          split_tf32(to_f32(r0[4]), ah[a][2], al[a][2]);
          split_tf32(to_f32(r0[8 * ASTR + 4]), ah[a][3], al[a][3]);
        }
#pragma unroll
        for (int b = 0; b < NT; ++b) {
          const T* c0 = sb + (ks + t) * BSTR + b * 8 + g;
          split_tf32(to_f32(c0[0]), bh[b][0], bl[b][0]);
          split_tf32(to_f32(c0[4 * BSTR]), bh[b][1], bl[b][1]);
        }
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int b = 0; b < NT; ++b) {
            mma_tf32(part[a][b], al[a], bh[b]);
            mma_tf32(part[a][b], ah[a], bl[b]);
            mma_tf32(part[a][b], ah[a], bh[b]);
          }
      }
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT; ++b)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[a][b][r] += part[a][b][r];
    }
  };

  // chunk 0, then one barrier per chunk: chunk i+1's loads are in flight
  // while chunk i's MMAs run
  load_b(0, 0);
  gather(0);
  blend(0);
  cp_async_wait_all();
  __syncthreads();
  for (int i = 0; i < nchunks; ++i) {
    const int cur = i & 1;
    const bool more = i + 1 < nchunks;
    if (more) {
      load_b(i + 1, cur ^ 1);
      gather(i + 1);
    }
    compute(cur);
    if (more) {
      blend(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // 3. bias in fp32, store NHWC in the input type
#pragma unroll
  for (int b = 0; b < NT; ++b) {
    const int n = n0 + wn * WTN + b * 8 + 2 * t;
    if (n >= Cout) continue;
    const float b0 = bias != nullptr ? to_f32(bias[n]) : 0.f;
    const float b1 = bias != nullptr ? to_f32(bias[n + 1]) : 0.f;
#pragma unroll
    for (int a = 0; a < MT; ++a) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long p = p0 + wm * WTM + a * 16 + g + 8 * h;
        if (p < P) store_pair(out + p * Cout + n, acc[a][b][2 * h] + b0, acc[a][b][2 * h + 1] + b1);
      }
    }
  }
}

struct Tile {
  int bm, bn;
};
// the tiles, widest first; each has its own instantiation in launch()
constexpr Tile TILES[] = {{64, 128}, {64, 64}, {32, 64}, {16, 64}};
constexpr int NTILES = sizeof(TILES) / sizeof(TILES[0]);
constexpr long long MIN_BLOCKS = 2 * 132;  // two blocks per SM of an H100

// The widest tile that still launches MIN_BLOCKS blocks (the narrowest
// otherwise); a tile wider than Cout is skipped.
int pick_tile(long long P, int Cout) {
  for (int i = 0; i < NTILES; ++i) {
    const Tile tl = TILES[i];
    if (tl.bn > 64 && Cout <= 64) continue;
    const long long blocks = ((P + tl.bm - 1) / tl.bm) * ((Cout + tl.bn - 1) / tl.bn);
    if (blocks >= MIN_BLOCKS) return i;
  }
  return NTILES - 1;
}

template <typename T, int BM, int BN, int WM, int WN>
int launch_tile(const void* x, const void* off, const void* mask, const void* w,
                const void* bias, void* out, int B, int H, int W, int Cin, int Cout,
                int radius, cudaStream_t stream) {
  constexpr int bytes = Smem<T, BM, BN>::BYTES;
  auto kernel = dcn_fwd_kernel<T, BM, BN, WM, WN>;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const long long P = (long long)B * H * W;
  dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  kernel<<<grid, THREADS, bytes, stream>>>((const T*)x, (const float*)off, (const T*)mask,
                                           (const T*)w, (const T*)bias, (T*)out, B, H, W, Cin,
                                           Cout, (float)radius);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* off, const void* mask, const void* w, const void* bias,
           void* out, int B, int H, int W, int Cin, int Cout, int radius, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (pick_tile((long long)B * H * W, Cout)) {
    case 0:
      return launch_tile<T, 64, 128, 2, 4>(x, off, mask, w, bias, out, B, H, W, Cin, Cout,
                                           radius, s);
    case 1:
      return launch_tile<T, 64, 64, 2, 4>(x, off, mask, w, bias, out, B, H, W, Cin, Cout,
                                          radius, s);
    case 2:
      return launch_tile<T, 32, 64, 2, 4>(x, off, mask, w, bias, out, B, H, W, Cin, Cout,
                                          radius, s);
    default:
      return launch_tile<T, 16, 64, 1, 8>(x, off, mask, w, bias, out, B, H, W, Cin, Cout,
                                          radius, s);
  }
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

// The output tile (pixels, output channels) that the launch at this shape uses.
extern "C" int dcn_fwd_tile_m(int B, int H, int W, int Cout) {
  return TILES[pick_tile((long long)B * H * W, Cout)].bm;
}

extern "C" int dcn_fwd_tile_n(int B, int H, int W, int Cout) {
  return TILES[pick_tile((long long)B * H * W, Cout)].bn;
}
