// Windowed backward warp for Hopper (sm_90a): the forward (K1) and its flow
// gradient (K2).
//
// K1 replaces the TPU kernel vfisr_tpu/ops/pallas/warp.py::_warp_kernel
// (pallas_call at warp.py:348), weight_mode='interp', as reached through
// warp_windowed. It computes the same function: out[p] = bilinear sample of
// img at p + t*flow[p], where the sample position is clipped to the content
// (replicate border) or to r px past it over zeros (constant border), and
// the offset inside the tile's window is clamped to [0, nsh-1.001]. Each
// 32x256 output tile's window origin comes from its rounded tile-mean
// displacement; the wrapper (ops/cuda/warp.py) computes that table with
// torch ops and passes it in, as XLA computes it outside the Pallas kernel.
//
// K2 replaces the same Pallas kernel in weight_mode='grad_y' and 'grad_x',
// launched twice by vfisr_tpu/core/warp.py::_pallas_warp_bwd (:182-185) and
// each followed there by a channel reduction with the cotangent (:186-187).
// Here one launch returns both reductions, cg = (d loss/d sx, d loss/d sy),
// and grad_flow = cg * t. The window origin is a constant of the backward,
// as in the reference (no gradient flows through the tile mean).
//
// The TPU kernel DMAs a window per tile and sums (2ry+2)*(2rx+2) shifted
// vector FMAs because the TPU has no fast gather. Hopper gathers well, so
// here each thread takes one output pixel and reads the two rows and two
// columns the hat weights select at the clamped coordinate: the same taps,
// weights and rounding steps, without the window copy and the rolls.
//
// What bounds both on the H100: bytes. Per pixel K1 does ~26 flops for the
// coordinates and weights and ~9 per channel, K2 ~30 and ~20 per channel,
// against C*2..4 bytes of img read once, C*2..4 of out written (K2: of ct
// read, and 8 of cg plus 4..8 of grad_flow written) and 4..8 bytes of flow:
// a few flops per byte, far below the card's ~20 flop/byte (f32) balance
// point. The design answer: one thread per output pixel computes
// coordinates, weights and validity once for all channels (K2 also shares
// the taps between its two axes), neighbouring threads read neighbouring
// pixels (flows are smooth, so the 4 taps of a warp hit lines that the
// neighbours also read and L1/L2 absorb the reuse), and nothing is staged
// through shared memory. K2 reduces over channels in registers, so the
// per-channel derivatives (the Pallas kernel's two outputs) never reach
// memory. A faster version (vector loads, a tile in shared memory) is later
// work; its bound is one pass over the inputs and outputs.
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared
// library and loaded with ctypes. Each launch returns cudaGetLastError().

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
template <typename T>
__device__ __forceinline__ float as_stored(float v);
template <>
__device__ __forceinline__ float as_stored<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_stored<__nv_bfloat16>(float v) { return bf16_round(v); }

// Where one output pixel samples: everything K1 and K2 compute once for all
// channels.
struct Sample {
  float sy_raw, sx_raw;  // source coordinate before the clip (canvas)
  float ry_raw, rx_raw;  // residual inside the window before its clamp
  float wy0, wy1;        // vertical hat weights at the two taps
  float wx0, wx1;        // horizontal hat weights (bf16-rounded with kBf16)
  int ys[2], xs[2];      // the two rows and columns, clamped into the content
  bool vy[2], vx[2];     // tap inside the content (constant border only)
};

// Explicit fmaf and _rn intrinsics fix where each step rounds (nvcc would
// otherwise contract at will): the source coordinate p + flow*t is one
// fused multiply-add, as XLA compiles the reference's expression.
template <typename TF, bool kBf16, bool kConstant>
__device__ __forceinline__ Sample sample_at(const TF* __restrict__ flow, float tn,
                                            const int* __restrict__ origin,
                                            const Params& p, int n, int y, int x,
                                            size_t pix) {
  Sample s;
  const int ty = y / p.th, tx = x / p.tw;
  const int rows = y - ty * p.th, cols = x - tx * p.tw;
  const int* o = origin + ((static_cast<size_t>(n) * p.ty_n + ty) * p.tx_n + tx) * 2;
  const int oy = o[0], ox = o[1];  // effective window origin (canvas)
  const float fx = ld(flow + pix * 2), fy = ld(flow + pix * 2 + 1);
  s.sy_raw = __fmaf_rn(fy, tn, static_cast<float>(p.pt + y));
  s.sx_raw = __fmaf_rn(fx, tn, static_cast<float>(p.pl + x));
  const float sy = fminf(fmaxf(s.sy_raw, p.ylo), p.yhi);
  const float sx = fminf(fmaxf(s.sx_raw, p.xlo), p.xhi);
  s.ry_raw = __fsub_rn(__fsub_rn(sy, static_cast<float>(oy)), static_cast<float>(rows));
  s.rx_raw = __fsub_rn(__fsub_rn(sx, static_cast<float>(ox)), static_cast<float>(cols));
  const float ry = fminf(fmaxf(s.ry_raw, 0.f), p.ry_max);
  const float rx = fminf(fmaxf(s.rx_raw, 0.f), p.rx_max);
  const float a0 = floorf(ry), b0 = floorf(rx);
  // hat(d) = 1 - |d| at the two taps the hat leaves nonzero
  s.wy0 = __fsub_rn(1.f, __fsub_rn(ry, a0));
  s.wy1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(a0, 1.f), ry));
  s.wx0 = __fsub_rn(1.f, __fsub_rn(rx, b0));
  s.wx1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(b0, 1.f), rx));
  if (kBf16) {
    s.wx0 = bf16_round(s.wx0);
    s.wx1 = bf16_round(s.wx1);
  }
  // canvas tap -> content index
  const int yi0 = oy + rows + static_cast<int>(a0) - p.pt;
  const int xi0 = ox + cols + static_cast<int>(b0) - p.pl;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int yk = yi0 + k, xk = xi0 + k;
    s.vy[k] = !kConstant || (yk >= 0 && yk < p.h);
    s.vx[k] = !kConstant || (xk >= 0 && xk < p.w);
    s.ys[k] = min(max(yk, 0), p.h - 1);
    s.xs[k] = min(max(xk, 0), p.w - 1);
  }
  return s;
}

// The 2x2 taps of one channel, rounded to the window dtype.
template <typename TI, bool kBf16>
__device__ __forceinline__ void load_taps(const TI* __restrict__ base, const Sample& s,
                                          const Params& p, int ch, float v[2][2]) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float val = (s.vy[a] && s.vx[b])
                            ? ld(base + (static_cast<size_t>(s.ys[a]) * p.w + s.xs[b]) * p.c + ch)
                            : 0.f;
      v[a][b] = kBf16 ? bf16_round(val) : val;
    }
  }
}

// One row's horizontal sum w0*v0 + w1*v1 as the window dtype takes it: in
// bf16 each product and the sum round to bf16.
template <bool kBf16>
__device__ __forceinline__ float row_sum(float w0, float v0, float w1, float v1) {
  float p0 = __fmul_rn(w0, v0);
  float p1 = __fmul_rn(w1, v1);
  if (!kBf16) return __fadd_rn(p0, p1);
  p0 = bf16_round(p0);
  p1 = bf16_round(p1);
  return bf16_round(__fadd_rn(p0, p1));
}

// K1. kBf16: window values, horizontal weights and horizontal sums in bf16
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
  const size_t pix = (static_cast<size_t>(n) * p.h + y) * p.w + x;
  const Sample s = sample_at<TF, kBf16, kConstant>(flow, t[n], origin, p, n, y, x, pix);
  const TI* base = img + static_cast<size_t>(n) * p.h * p.w * p.c;
  TI* dst = out + pix * p.c;
  for (int ch = 0; ch < p.c; ++ch) {
    float v[2][2];
    load_taps<TI, kBf16>(base, s, p, ch, v);
    const float in0 = row_sum<kBf16>(s.wx0, v[0][0], s.wx1, v[0][1]);
    const float in1 = row_sum<kBf16>(s.wx0, v[1][0], s.wx1, v[1][1]);
    st(dst + ch, __fadd_rn(__fmul_rn(s.wy0, in0), __fmul_rn(s.wy1, in1)));
  }
}

// K2: the warp's flow gradient, both axes in one pass (the TPU kernel's
// weight_mode='grad_y' and 'grad_x', two launches there, plus the two
// channel reductions of core/warp.py::_pallas_warp_bwd). One axis' hat is
// replaced by its floor-consistent derivative dhat: -1 at the lower tap and
// +1 at the upper one, so an exact integer coordinate (zero flow) still gets
// v[k+1]-v[k]; masked to 0 wherever the forward saturates, i.e. the source
// coordinate leaves [lo, hi) or the residual leaves [0, nsh-1.001). The other
// axis keeps its hat. Per channel the derivative is rounded to img's dtype
// (the Pallas output's cast), multiplied by the cotangent and summed over
// channels in f32: cg = (d loss/d sx, d loss/d sy), and grad_flow = cg * t.
template <typename TI, typename TF, bool kBf16, bool kConstant>
__global__ void warp_windowed_grad_kernel(const TI* __restrict__ img,
                                          const TF* __restrict__ flow,
                                          const float* __restrict__ t,
                                          const int* __restrict__ origin,
                                          const TI* __restrict__ ct,
                                          TF* __restrict__ grad_flow,
                                          float* __restrict__ cg, Params p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int n = blockIdx.z;
  if (x >= p.w) return;
  const size_t pix = (static_cast<size_t>(n) * p.h + y) * p.w + x;
  const float tn = t[n];
  const Sample s = sample_at<TF, kBf16, kConstant>(flow, tn, origin, p, n, y, x, pix);
  const float my = (s.sy_raw >= p.ylo && s.sy_raw < p.yhi && s.ry_raw >= 0.f &&
                    s.ry_raw < p.ry_max) ? 1.f : 0.f;
  const float mx = (s.sx_raw >= p.xlo && s.sx_raw < p.xhi && s.rx_raw >= 0.f &&
                    s.rx_raw < p.rx_max) ? 1.f : 0.f;
  const TI* base = img + static_cast<size_t>(n) * p.h * p.w * p.c;
  const TI* cot = ct + pix * p.c;
  float acc_y = 0.f, acc_x = 0.f;
  for (int ch = 0; ch < p.c; ++ch) {
    float v[2][2];
    load_taps<TI, kBf16>(base, s, p, ch, v);
    // d out/d sy: vertical dhat over the interp rows
    const float in0 = row_sum<kBf16>(s.wx0, v[0][0], s.wx1, v[0][1]);
    const float in1 = row_sum<kBf16>(s.wx0, v[1][0], s.wx1, v[1][1]);
    float gy = __fadd_rn(__fmul_rn(-my, in0), __fmul_rn(my, in1));
    // d out/d sx: horizontal dhat (exact in bf16), vertical hat
    const float dx0 = row_sum<kBf16>(-mx, v[0][0], mx, v[0][1]);
    const float dx1 = row_sum<kBf16>(-mx, v[1][0], mx, v[1][1]);
    float gx = __fadd_rn(__fmul_rn(s.wy0, dx0), __fmul_rn(s.wy1, dx1));
    gy = as_stored<TI>(gy);
    gx = as_stored<TI>(gx);
    const float c = ld(cot + ch);
    acc_y = __fadd_rn(acc_y, __fmul_rn(c, gy));
    acc_x = __fadd_rn(acc_x, __fmul_rn(c, gx));
  }
  cg[pix * 2] = acc_x;
  cg[pix * 2 + 1] = acc_y;
  st(grad_flow + pix * 2, __fmul_rn(acc_x, tn));
  st(grad_flow + pix * 2 + 1, __fmul_rn(acc_y, tn));
}

// Instantiates and launches K1 or K2 (Kernel::run) for the window dtype and
// border of the call; one thread per output pixel, one grid row per image row.
template <typename Kernel, typename... Args>
cudaError_t launch_modes(const Params& p, int bf16_window, int constant,
                         cudaStream_t stream, Args... args) {
  const dim3 block(256);
  const dim3 grid((p.w + block.x - 1) / block.x, p.h, p.n);
  if (bf16_window) {
    if (constant)
      Kernel::template run<true, true>(grid, block, stream, p, args...);
    else
      Kernel::template run<true, false>(grid, block, stream, p, args...);
  } else {
    if (constant)
      Kernel::template run<false, true>(grid, block, stream, p, args...);
    else
      Kernel::template run<false, false>(grid, block, stream, p, args...);
  }
  return cudaGetLastError();
}

template <typename TI, typename TF>
struct Interp {
  template <bool kBf16, bool kConstant>
  static void run(dim3 grid, dim3 block, cudaStream_t stream, const Params& p,
                  const void* img, const void* flow, const float* t, const int* origin,
                  void* out) {
    warp_windowed_kernel<TI, TF, kBf16, kConstant><<<grid, block, 0, stream>>>(
        static_cast<const TI*>(img), static_cast<const TF*>(flow), t, origin,
        static_cast<TI*>(out), p);
  }
};

template <typename TI, typename TF>
struct Grad {
  template <bool kBf16, bool kConstant>
  static void run(dim3 grid, dim3 block, cudaStream_t stream, const Params& p,
                  const void* img, const void* flow, const float* t, const int* origin,
                  const void* ct, void* grad_flow, float* cg) {
    warp_windowed_grad_kernel<TI, TF, kBf16, kConstant><<<grid, block, 0, stream>>>(
        static_cast<const TI*>(img), static_cast<const TF*>(flow), t, origin,
        static_cast<const TI*>(ct), static_cast<TF*>(grad_flow), cg, p);
  }
};

// Picks the kernel's img and flow element types.
template <template <typename, typename> class Kernel, typename... Args>
cudaError_t launch_typed(int img_bf16, int flow_bf16, const Params& p, int bf16_window,
                         int constant, cudaStream_t stream, Args... args) {
  using bf16 = __nv_bfloat16;
  if (img_bf16)
    return flow_bf16
               ? launch_modes<Kernel<bf16, bf16>>(p, bf16_window, constant, stream, args...)
               : launch_modes<Kernel<bf16, float>>(p, bf16_window, constant, stream, args...);
  return flow_bf16
             ? launch_modes<Kernel<float, bf16>>(p, bf16_window, constant, stream, args...)
             : launch_modes<Kernel<float, float>>(p, bf16_window, constant, stream, args...);
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
  return static_cast<int>(launch_typed<Interp>(
      img_bf16, flow_bf16, p, bf16_window, constant, static_cast<cudaStream_t>(stream),
      img, flow, static_cast<const float*>(t), static_cast<const int*>(origin), out));
}

// K2. The arguments of warp_windowed_launch, plus ct: [n, h, w, c] in img's
// type (the cotangent of out); grad_flow: [n, h, w, 2] in flow's type; cg:
// [n, h, w, 2] f32, (d loss/d sx, d loss/d sy). Returns the cudaError_t.
extern "C" int warp_windowed_grad_launch(
    const void* img, const void* flow, const void* t, const void* origin,
    const void* ct, void* grad_flow, void* cg, int n, int h, int w, int c,
    int img_bf16, int flow_bf16, int bf16_window, int constant, int th, int tw,
    int ty_n, int tx_n, int pt, int pl, float ylo, float yhi, float xlo,
    float xhi, float ry_max, float rx_max, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{n, h, w, c, th, tw, ty_n, tx_n, pt, pl,
                 ylo, yhi, xlo, xhi, ry_max, rx_max};
  return static_cast<int>(launch_typed<Grad>(
      img_bf16, flow_bf16, p, bf16_window, constant, static_cast<cudaStream_t>(stream),
      img, flow, static_cast<const float*>(t), static_cast<const int*>(origin), ct,
      grad_flow, static_cast<float*>(cg)));
}
