// Learnable bilinear upsampling fused with the skip add of the decoder, for
// Hopper (sm_90a): out = up_f(x; w) + skip, NHWC, fp32 or bf16.
//
// Replaces no TPU kernel. The JAX package computes BilinearUp
// (dcd_tpu/models/layers.py:205) in plain XLA by its polyphase
// decomposition. The port first ran the operator as PyTorch's depthwise
// ConvTranspose2d, which cuDNN runs as dgrad2d_c1_k1_nhwc, and then the add
// after it as a separate pass. At batch 64 and 384x1280 in bf16 the eight
// upsamplings of a DGDE forward took 27.1 ms on an H100. Their bound is 0.57
// ms, so cuDNN ran the op 47 times over it. This kernel was added for that.
//
// What it computes. The operator is ConvTranspose2d(C, C, 2f, stride=f,
// padding=f/2, groups=C, bias=False) for f = 2 or 4. Output pixel
// (f i + a, f j + b) takes two taps per axis: (kh, di) = (a + f/2, 0) and
// (a + f/2 + f, -1) when a + f/2 < f, else (a + f/2 - f, +1); the same for
// (kw, dj) with b. Inputs outside the map count as zero. Per channel:
//
//   up  = sum over the 2 x 2 taps of w[c, kh, kw] * x[i + di, j + dj, c]
//   out = T(T(up) + skip)
//
// The four products are summed in fp32 with the weights cast to the
// working type T first, as weight.to(x.dtype) does. up is rounded to T
// before the skip is added, and the sum is rounded again. So the bf16 path
// keeps the two roundings of the separate transposed conv and add.
//
// What bounds it on this card: bytes. A thread does 32 FMAs per 8 output
// channels, so the arithmetic is negligible. Each input byte is read once,
// each skip byte is read once, and each output byte is written once. For
// the eight layers of a DGDE forward at batch 64 in bf16 that is
// 346 MB + 1,573 MB + 1,573 MB = 3.49 GB, or 1.04 ms at 3.35 TB/s. The
// unfused pair needs 1.92 GB for the upsampling and 4.72 GB for the add.
//
// Design:
//  * Channels are contiguous in NHWC. A thread owns 8 channels of one output
//    pixel: one 16-byte vector in bf16, two in fp32. A block has CV * PPB
//    threads (CV = C / 8 channel vectors, PPB = 256 / CV pixels). Its
//    neighbouring threads take neighbouring channel vectors and then
//    neighbouring output columns. So every load of skip and every store of
//    out is a whole vector, and a warp covers whole 32-byte sectors.
//  * A unit of work is PPB pixels of one output row. The row fixes the image,
//    the row phase a and its two input rows for the whole block. Blocks walk
//    the units in a grid-stride loop over a grid sized to the card, so
//    neighbouring units, and the input rows they re-read, run at the same
//    time. Each input vector is read by f x f to 4 f x f outputs, and L1 and
//    L2 serve those re-reads. x is loaded through the read-only path. skip
//    is loaded and out stored with the streaming hints (__ldcs, __stcs),
//    because each is touched once.
//  * The per-channel weights, cast to T, sit in shared memory laid out as
//    [tap][channel]. A thread reads its 8 channels of a tap as one vector in
//    bf16 and two in fp32. The block fills the table once: 4 f^2 C values.
//  * There are no atomics and a fixed order of the sum, so two runs are
//    bitwise equal (the deterministic training step relies on it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

// 8 consecutive values of T, kept as loaded (bf16 stays packed in 4
// registers) until the FMAs unpack them
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  uint4 r;
};
template <>
struct Pack<float> {
  float4 a, b;
};

// from device memory by the read-only path (x), by a streaming load (skip),
// or from shared memory (the weights)
__device__ __forceinline__ void load_x(const __nv_bfloat16* p, Pack<__nv_bfloat16>& v) {
  v.r = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_x(const float* p, Pack<float>& v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  v.a = __ldg(q);
  v.b = __ldg(q + 1);
}
__device__ __forceinline__ void load_stream(const __nv_bfloat16* p, Pack<__nv_bfloat16>& v) {
  v.r = __ldcs(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void load_stream(const float* p, Pack<float>& v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  v.a = __ldcs(q);
  v.b = __ldcs(q + 1);
}
__device__ __forceinline__ void load_shared(const __nv_bfloat16* p, Pack<__nv_bfloat16>& v) {
  v.r = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void load_shared(const float* p, Pack<float>& v) {
  const float4* q = reinterpret_cast<const float4*>(p);
  v.a = q[0];
  v.b = q[1];
}
__device__ __forceinline__ void set_zero(Pack<__nv_bfloat16>& v) { v.r = make_uint4(0, 0, 0, 0); }
__device__ __forceinline__ void set_zero(Pack<float>& v) {
  v.a = make_float4(0.f, 0.f, 0.f, 0.f);
  v.b = v.a;
}

__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16>& p, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&p.r);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const Pack<float>& p, float (&v)[8]) {
  v[0] = p.a.x; v[1] = p.a.y; v[2] = p.a.z; v[3] = p.a.w;
  v[4] = p.b.x; v[5] = p.b.y; v[6] = p.b.z; v[7] = p.b.w;
}

// acc = w * x (first) or acc += w * x, in fp32
template <typename T, bool FIRST>
__device__ __forceinline__ void fma8(float (&acc)[8], const Pack<T>& w, const Pack<T>& x) {
  float wf[8], xf[8];
  unpack(w, wf);
  unpack(x, xf);
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = FIRST ? wf[k] * xf[k] : fmaf(wf[k], xf[k], acc[k]);
}

// round to T (nearest even, as PyTorch's casts) and store 8 values
__device__ __forceinline__ void store_stream(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  __stcs(reinterpret_cast<uint4*>(p), r);
}
__device__ __forceinline__ void store_stream(float* p, const float (&v)[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  __stcs(q, make_float4(v[0], v[1], v[2], v[3]));
  __stcs(q + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void cast(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void cast(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }

// the second tap of phase a: its kernel index and input shift (the first is
// (a + F/2, 0))
template <int F>
__device__ __forceinline__ void second_tap(int a, int& k, int& d) {
  const int k0 = a + F / 2;
  if (k0 < F) {
    k = k0 + F;
    d = -1;
  } else {
    k = k0 - F;
    d = 1;
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(MAX_THREADS)
upsample_add_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const T* __restrict__ skip, T* __restrict__ out, int B, int H, int W,
                    int C) {
  constexpr int K = 2 * F, TAPS = K * K;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sw = reinterpret_cast<T*>(smem);  // [TAPS][C]
  for (int e = threadIdx.x; e < C * TAPS; e += blockDim.x) {
    cast(w[e], sw + (e % TAPS) * C + e / TAPS);  // w is (C, 1, K, K)
  }
  __syncthreads();

  const int CV = C / 8, PPB = blockDim.x / CV;
  const int c0 = (threadIdx.x % CV) * 8, slot = threadIdx.x / CV;
  const int OH = F * H, OW = F * W;
  const int chunks = (OW + PPB - 1) / PPB;
  const int units = B * OH * chunks;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row = u / chunks;  // b * OH + oh
    const int ow = (u - row * chunks) * PPB + slot;
    if (ow >= OW) continue;
    const int b = row / OH, oh = row - b * OH;
    const int i = oh / F, a = oh - i * F;
    const int j = ow / F, bb = ow - j * F;
    int kh1, di, kw1, dj;
    second_tap<F>(a, kh1, di);
    second_tap<F>(bb, kw1, dj);
    const int kh0 = a + F / 2, kw0 = bb + F / 2;
    const int i1 = i + di, j1 = j + dj;
    const bool row1 = (unsigned)i1 < (unsigned)H, col1 = (unsigned)j1 < (unsigned)W;

    const T* xb = x + (size_t)b * H * W * C + c0;
    Pack<T> x00, x01, x10, x11, s;
    load_x(xb + ((size_t)i * W + j) * C, x00);
    set_zero(x01);
    set_zero(x10);
    set_zero(x11);
    if (col1) load_x(xb + ((size_t)i * W + j1) * C, x01);
    if (row1) load_x(xb + ((size_t)i1 * W + j) * C, x10);
    if (row1 && col1) load_x(xb + ((size_t)i1 * W + j1) * C, x11);
    const size_t o = (((size_t)b * OH + oh) * OW + ow) * C + c0;
    load_stream(skip + o, s);

    Pack<T> wv;
    float acc[8];
    load_shared(sw + (kh0 * K + kw0) * C + c0, wv);
    fma8<T, true>(acc, wv, x00);
    load_shared(sw + (kh0 * K + kw1) * C + c0, wv);
    fma8<T, false>(acc, wv, x01);
    load_shared(sw + (kh1 * K + kw0) * C + c0, wv);
    fma8<T, false>(acc, wv, x10);
    load_shared(sw + (kh1 * K + kw1) * C + c0, wv);
    fma8<T, false>(acc, wv, x11);
    float sf[8];
    unpack(s, sf);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[k] = round_to(acc[k], T()) + sf[k];
    }
    store_stream(out + o, acc);
  }
}

// Threads per block: CV channel vectors times as many pixels as fit in
// MAX_THREADS (one pixel when CV > MAX_THREADS / 2).
int block_threads(int C) {
  const int cv = C / 8;
  return cv * (MAX_THREADS / cv);
}

template <typename T, int F>
int launch_f(const void* x, const void* w, const void* skip, void* out, int B, int H, int W,
             int C, cudaStream_t stream) {
  auto kernel = upsample_add_kernel<T, F>;
  const int bytes = 4 * F * F * C * (int)sizeof(T);
  cudaError_t e;
  if (bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = block_threads(C);
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (e != cudaSuccess) return (int)e;
  const int ppb = threads / (C / 8);
  const long long units = (long long)B * F * H * ((F * W + ppb - 1) / ppb);
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = units < (long long)sms * per_sm ? units : (long long)sms * per_sm;
  if (grid < 1) return (int)cudaSuccess;  // an empty map
  kernel<<<(unsigned)grid, threads, bytes, stream>>>((const T*)x, (const float*)w,
                                                      (const T*)skip, (T*)out, B, H, W, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* skip, void* out, int B, int H, int W,
           int C, int f, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (f) {
    case 2:
      return launch_f<T, 2>(x, w, skip, out, B, H, W, C, s);
    case 4:
      return launch_f<T, 4>(x, w, skip, out, B, H, W, C, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points for ctypes. x (B, H, W, C), skip and out
// (B, fH, fW, C) in T, NHWC, 16-byte aligned, C a multiple of 8; w the fp32
// (C, 1, 2f, 2f) weight. f is 2 or 4. The launch goes on
// `stream` and does not synchronise. The return value is
// cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int upsample_add_f32(const void* x, const void* w, const void* skip, void* out,
                                int B, int H, int W, int C, int f, void* stream) {
  return launch<float>(x, w, skip, out, B, H, W, C, f, stream);
}

extern "C" int upsample_add_bf16(const void* x, const void* w, const void* skip, void* out,
                                 int B, int H, int W, int C, int f, void* stream) {
  return launch<__nv_bfloat16>(x, w, skip, out, B, H, W, C, f, stream);
}
