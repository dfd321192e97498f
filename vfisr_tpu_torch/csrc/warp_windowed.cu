// Windowed backward warp for Hopper (sm_90a).
//
// Replaces the TPU kernel vfisr_tpu/ops/pallas/warp.py::_warp_kernel
// (pallas_call at warp.py:348), weight_mode='interp', as reached through
// warp_windowed. It computes the same function: out[p] = bilinear sample of
// img at p + t*flow[p], where the sample position is clipped to the content
// (replicate border) or to r px past it over zeros (constant border), and
// the offset inside the tile's window is clamped to [0, nsh-1.001]. Each
// 32x256 output tile's window origin comes from its rounded tile-mean
// displacement; the wrapper (ops/cuda/warp.py) computes that table with
// torch ops and passes it in, as XLA computes it outside the Pallas kernel.
//
// The TPU kernel DMAs a window per tile and sums (2ry+2)*(2rx+2) shifted
// vector FMAs because the TPU has no fast gather. Hopper gathers well, so
// here each thread takes one output pixel and reads the two rows and two
// columns the hat weights select at the clamped coordinate: the same taps,
// weights and rounding steps, without the window copy and the rolls.
//
// What bounds it on the H100: bytes. Per pixel it does ~26 flops for the
// coordinates and weights and ~9 per channel, against C*2..4 bytes read
// once, C*2..4 written and 4..8 bytes of flow: a few flops per byte, far
// below the card's ~20 flop/byte (f32) balance point. The design
// answer: one thread per output pixel computes coordinates and weights once
// for all channels, neighbouring threads read neighbouring pixels (flows
// are smooth, so the 4 taps of a warp hit lines that the neighbours also
// read and L1/L2 absorb the reuse), and nothing is staged through shared
// memory. A faster version (vector loads, a tile in shared memory) is later
// work; its bound is one pass over img, flow and out.
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared
// library and loaded with ctypes. The launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  int n, h, w, c;
  int th, tw, ty_n, tx_n;
  int pt, pl;          // content origin inside the canvas
  float ylo, yhi;      // source-coordinate clip bounds (canvas space)
  float xlo, xhi;
  float ry_max, rx_max;  // nsh - 1.001: residual clamp
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// kBf16: window values, horizontal weights and horizontal sums in bf16
// (compute_dtype=bfloat16); the vertical accumulation stays f32.
// kConstant: zero canvas outside the content instead of edge replication.
template <typename TI, typename TF, bool kBf16, bool kConstant>
__global__ void warp_windowed_kernel(const TI* __restrict__ img,
                                     const TF* __restrict__ flow,
                                     const float* __restrict__ t,
                                     const int* __restrict__ origin,
                                     TI* __restrict__ out, Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  if (x >= p.w) return;
  const int ty = y / p.th, tx = x / p.tw;
  const int rows = y - ty * p.th, cols = x - tx * p.tw;
  const int* o = origin + ((static_cast<size_t>(n) * p.ty_n + ty) * p.tx_n + tx) * 2;
  const int oy = o[0], ox = o[1];  // effective window origin (canvas)
  const float tn = t[n];
  const size_t pix = (static_cast<size_t>(n) * p.h + y) * p.w + x;

  // Explicit fmaf and _rn intrinsics fix where each step rounds (nvcc
  // would otherwise contract at will): the source coordinate p + flow*t is
  // one fused multiply-add, as XLA compiles the reference's expression.
  const float fx = ld(flow + pix * 2), fy = ld(flow + pix * 2 + 1);
  const float sy_raw = __fmaf_rn(fy, tn, static_cast<float>(p.pt + y));
  const float sx_raw = __fmaf_rn(fx, tn, static_cast<float>(p.pl + x));
  const float sy = fminf(fmaxf(sy_raw, p.ylo), p.yhi);
  const float sx = fminf(fmaxf(sx_raw, p.xlo), p.xhi);
  const float ry = fminf(fmaxf(__fsub_rn(__fsub_rn(sy, static_cast<float>(oy)),
                                         static_cast<float>(rows)), 0.f), p.ry_max);
  const float rx = fminf(fmaxf(__fsub_rn(__fsub_rn(sx, static_cast<float>(ox)),
                                         static_cast<float>(cols)), 0.f), p.rx_max);
  const float a0 = floorf(ry), b0 = floorf(rx);
  // hat(d) = 1 - |d| at the two taps the hat leaves nonzero
  const float wy0 = __fsub_rn(1.f, __fsub_rn(ry, a0));
  const float wy1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(a0, 1.f), ry));
  float wx0 = __fsub_rn(1.f, __fsub_rn(rx, b0));
  float wx1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(b0, 1.f), rx));
  if (kBf16) {
    wx0 = bf16_round(wx0);
    wx1 = bf16_round(wx1);
  }

  // canvas tap -> content index
  const int yi0 = oy + rows + static_cast<int>(a0) - p.pt;
  const int xi0 = ox + cols + static_cast<int>(b0) - p.pl;
  int ys[2] = {yi0, yi0 + 1};
  int xs[2] = {xi0, xi0 + 1};
  bool vy[2] = {true, true}, vx[2] = {true, true};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (kConstant) {
      vy[k] = ys[k] >= 0 && ys[k] < p.h;
      vx[k] = xs[k] >= 0 && xs[k] < p.w;
    }
    ys[k] = min(max(ys[k], 0), p.h - 1);
    xs[k] = min(max(xs[k], 0), p.w - 1);
  }
  const TI* base = img + static_cast<size_t>(n) * p.h * p.w * p.c;
  TI* dst = out + pix * p.c;
  for (int ch = 0; ch < p.c; ++ch) {
    float v[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float val = (vy[a] && vx[b])
                        ? ld(base + (static_cast<size_t>(ys[a]) * p.w + xs[b]) * p.c + ch)
                        : 0.f;
        v[a][b] = kBf16 ? bf16_round(val) : val;
      }
    }
    float inner[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float p0 = __fmul_rn(wx0, v[a][0]);
      float p1 = __fmul_rn(wx1, v[a][1]);
      if (kBf16) {
        p0 = bf16_round(p0);
        p1 = bf16_round(p1);
        inner[a] = bf16_round(__fadd_rn(p0, p1));
      } else {
        inner[a] = __fadd_rn(p0, p1);
      }
    }
    st(dst + ch, __fadd_rn(__fmul_rn(wy0, inner[0]), __fmul_rn(wy1, inner[1])));
  }
}

template <typename TI, typename TF>
cudaError_t launch_typed(const void* img, const void* flow, const float* t,
                         const int* origin, void* out, const Params& p,
                         int bf16_window, int constant, cudaStream_t stream) {
  const dim3 block(256);
  const dim3 grid((p.w + block.x - 1) / block.x, p.h, p.n);
  const TI* in = static_cast<const TI*>(img);
  const TF* fl = static_cast<const TF*>(flow);
  TI* o = static_cast<TI*>(out);
  if (bf16_window) {
    if (constant)
      warp_windowed_kernel<TI, TF, true, true><<<grid, block, 0, stream>>>(in, fl, t, origin, o, p);
    else
      warp_windowed_kernel<TI, TF, true, false><<<grid, block, 0, stream>>>(in, fl, t, origin, o, p);
  } else {
    if (constant)
      warp_windowed_kernel<TI, TF, false, true><<<grid, block, 0, stream>>>(in, fl, t, origin, o, p);
    else
      warp_windowed_kernel<TI, TF, false, false><<<grid, block, 0, stream>>>(in, fl, t, origin, o, p);
  }
  return cudaGetLastError();
}

}  // namespace

// img/out: [n, h, w, c] f32 or bf16 (img_bf16); flow: [n, h, w, 2] f32 or
// bf16 (flow_bf16), (dx, dy); t: [n] f32; origin: [n, ty_n, tx_n, 2] int32
// effective window origins (oy, ox) in canvas coordinates. All contiguous,
// all on the device of `stream`. Returns the cudaError_t of the launch.
extern "C" int warp_windowed_launch(
    const void* img, const void* flow, const void* t, const void* origin,
    void* out, int n, int h, int w, int c, int img_bf16, int flow_bf16,
    int bf16_window, int constant, int th, int tw, int ty_n, int tx_n, int pt,
    int pl, float ylo, float yhi, float xlo, float xhi, float ry_max,
    float rx_max, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{n, h, w, c, th, tw, ty_n, tx_n, pt, pl,
                 ylo, yhi, xlo, xhi, ry_max, rx_max};
  const float* tf = static_cast<const float*>(t);
  const int* org = static_cast<const int*>(origin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (img_bf16) {
    err = flow_bf16
              ? launch_typed<__nv_bfloat16, __nv_bfloat16>(img, flow, tf, org, out, p, bf16_window, constant, s)
              : launch_typed<__nv_bfloat16, float>(img, flow, tf, org, out, p, bf16_window, constant, s);
  } else {
    err = flow_bf16
              ? launch_typed<float, __nv_bfloat16>(img, flow, tf, org, out, p, bf16_window, constant, s)
              : launch_typed<float, float>(img, flow, tf, org, out, p, bf16_window, constant, s);
  }
  return static_cast<int>(err);
}
