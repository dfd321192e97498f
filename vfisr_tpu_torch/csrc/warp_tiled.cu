// Windowed backward warp at any output tile, for Hopper (sm_90a): the
// forward (K1) and its flow gradient (K2), for every tile (th, tw) other
// than the 32x256 one that csrc/warp_windowed.cu is built for.
//
// It replaces the same TPU kernel as warp_windowed.cu,
// vfisr_tpu/ops/pallas/warp.py::_warp_kernel (pallas_call at warp.py:348),
// in weight_mode 'interp' (K1) and 'grad_y'/'grad_x' (K2), at the `tile`
// argument of the reference's warp_windowed (:195), which decides two things
// per output tile: where its window sits (the tile-mean displacement,
// :288-314) and the content origin (PT, PL) (:262-263) that the clip bounds
// hang on. warp_windowed.cu fixes the tile at build time (a CTA per tile
// column, one warp per 32x32 block of its mean); here (th, tw) are run-time
// arguments, so one build serves every tile.
//
// The function, as ops/cuda/warp.py::warp_windowed_plain computes it for
// `tile`: out[p] = bilinear sample of img at p + t*flow[p], the sample
// position clipped to the content (replicate border) or to r px past it
// over zeros (constant border), its offset inside the tile's window clamped
// to [0, nsh-1.001]; K2 gives cg = (d loss/d sx, d loss/d sy), the channel
// sums of the cotangent times the per-channel derivatives, and grad_flow =
// cg * t.
//
// What bounds it on the H100: bytes, as for warp_windowed.cu (a few flops
// per byte against the card's ~20 flop/byte f32 balance). The design is the
// simple one, right first:
// - tiled_origins_kernel, one CTA per tile: each thread takes cells of the
//   tile (g x g pixel blocks, g the largest power of two dividing th and
//   tw), reduces its cell by the chain of 2x2 halvings in Morton order (so
//   every sum is ((a00 + a01) + a10) + a11, as the twin's and the
//   reference's), and writes the cell mean to a scratch the wrapper
//   allocates; then one thread adds the tile's cells in row-major order,
//   scales by g*g/(th*tw) and t, rounds half-even and clamps: the window
//   origin, bit for bit as window_origins.
// - tiled_warp_kernel<kGrad>, one thread per output pixel: it reads its
//   tile's origin, computes its source coordinate, residuals and weights
//   with the twin's arithmetic (fmaf for p + t*flow, _rn intrinsics so that
//   nvcc contracts nothing), and loops over the channels (any C), reading
//   the 2x2 taps of img through L1/L2 (__ldg). K1 writes out; K2 reads ct
//   and accumulates cg over the channels in channel order, then writes cg
//   and grad_flow. A window in shared memory, TMA and tuning are left for
//   later work.
//
// Plain C interface, no PyTorch headers: built by nvcc into its own shared
// library and loaded with ctypes (ops/cuda/warp.py::build_tiled). Each entry
// returns a cudaError_t: of the launch, or cudaErrorInvalidValue for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 15;  // halvings of a cell: g up to 2^15

struct Tiled {
  int n, h, w, c;
  int th, tw;           // output tile
  int ty_n, tx_n;       // tiles per image (content rounded up to the tile)
  int g, levels;        // cell side (a power of two) and its log2
  int cy, cx;           // cells per tile: th / g, tw / g
  float cell_scale;     // g*g/(th*tw) rounded to f32; unused with one cell
  int pt, pl;           // content origin inside the canvas
  int ry, rx;           // residual radii
  int t_stride;         // t[n * t_stride], or t_scalar where t is null
  float t_scalar;
  float ylo, yhi, xlo, xhi;  // source-coordinate clip bounds (canvas space)
  float ry_max, rx_max;      // nsh - 1.001: residual clamp
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename T>
__device__ __forceinline__ float as_stored(float v) {
  return std::is_same<T, float>::value ? v : bf16_round(v);
}

__device__ __forceinline__ float batch_t(const float* __restrict__ t, const Tiled& p, int n) {
  return t ? __ldg(t + n * p.t_stride) : p.t_scalar;
}

// The mean flow of one g x g cell whose top-left pixel is (y0, x0), by the
// chain of 2x2 halvings: the cell's pixels are visited in Morton order, so
// the four children of every node arrive as (0,0), (0,1), (1,0), (1,1) and
// each node is (((a00 + a01) + a10) + a11) * 0.25, as the twin's halvings
// give it. Pixels past the content repeat its last row and column (the
// reference's edge padding to tile multiples).
template <typename TF>
__device__ float2 cell_mean(const TF* __restrict__ base, const Tiled& p, int y0, int x0) {
  float2 acc[kMaxLevels];
  float2 v = make_float2(0.f, 0.f);
  const int count = 1 << (2 * p.levels);
  for (int k = 0; k < count; ++k) {
    int yy = 0, xx = 0;
    for (int b = 0; b < p.levels; ++b) {
      xx |= ((k >> (2 * b)) & 1) << b;
      yy |= ((k >> (2 * b + 1)) & 1) << b;
    }
    const int y = min(y0 + yy, p.h - 1), x = min(x0 + xx, p.w - 1);
    const TF* f = base + (static_cast<size_t>(y) * p.w + x) * 2;
    v = make_float2(ld(f), ld(f + 1));
    for (int lvl = 0; lvl < p.levels; ++lvl) {
      const int pos = (k >> (2 * lvl)) & 3;
      if (pos == 0) {
        acc[lvl] = v;
        break;
      }
      acc[lvl] = make_float2(__fadd_rn(acc[lvl].x, v.x), __fadd_rn(acc[lvl].y, v.y));
      if (pos < 3) break;
      v = make_float2(__fmul_rn(acc[lvl].x, 0.25f), __fmul_rn(acc[lvl].y, 0.25f));
    }
  }
  return v;  // after the last pixel: the cell's root
}

// One CTA per tile (x: tx, y: ty, z: n). cells: [n, ty_n, tx_n, cy * cx]
// float2 scratch; origin: [n, ty_n, tx_n, 2] int32 (oy, ox), canvas
// coordinates, the effective window origin as window_origins gives it.
template <typename TF, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    tiled_origins_kernel(const TF* __restrict__ flow, const float* __restrict__ t,
                         float2* __restrict__ cells, int* __restrict__ origin, Tiled p) {
  const int n = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
  const size_t tile = (static_cast<size_t>(n) * p.ty_n + ty) * p.tx_n + tx;
  const int per_tile = p.cy * p.cx;
  float2* mine = cells + tile * per_tile;
  const TF* base = flow + static_cast<size_t>(n) * p.h * p.w * 2;
  for (int k = threadIdx.x; k < per_tile; k += kThreads) {
    const int i = k / p.cx, j = k - i * p.cx;
    mine[k] = cell_mean(base, p, ty * p.th + i * p.g, tx * p.tw + j * p.g);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float mx = mine[0].x, my = mine[0].y;
  for (int k = 1; k < per_tile; ++k) {  // row-major, as the twin's final reduce
    mx = __fadd_rn(mx, mine[k].x);
    my = __fadd_rn(my, mine[k].y);
  }
  if (per_tile > 1) {
    mx = __fmul_rn(mx, p.cell_scale);
    my = __fmul_rn(my, p.cell_scale);
  }
  const float tn = batch_t(t, p, n);
  mx = __fmul_rn(mx, tn);
  my = __fmul_rn(my, tn);
  // round half-even (torch.round), as 64-bit ints like the reference's
  long long oy = p.pt + static_cast<long long>(ty) * p.th + __float2ll_rn(my) - (p.ry + 1);
  long long ox = p.pl + static_cast<long long>(tx) * p.tw + __float2ll_rn(mx) - (p.rx + 1);
  oy = min(max(oy, 0LL), static_cast<long long>(p.pt) + static_cast<long long>(p.ty_n) * p.th);
  ox = min(max(ox, 0LL), static_cast<long long>(p.pl) + static_cast<long long>(p.tx_n) * p.tw);
  if (kBf16) oy -= oy & 1;  // the TPU's bf16 rolls drop the odd row slack
  origin[tile * 2] = static_cast<int>(oy);
  origin[tile * 2 + 1] = static_cast<int>(ox);
}

// One tap of channel ch as the window dtype holds it: img's element (row
// yi, column xi of image n) clamped into the content (replicate) or zero
// outside it (constant), rounded to bf16 with a bf16 window.
template <typename TI, bool kBf16, bool kConstant>
__device__ __forceinline__ float tap(const TI* __restrict__ img_n, const Tiled& p, int yi, int xi,
                                     int ch) {
  if (kConstant && (yi < 0 || yi >= p.h || xi < 0 || xi >= p.w)) return 0.f;
  yi = min(max(yi, 0), p.h - 1);
  xi = min(max(xi, 0), p.w - 1);
  const float v = ld(img_n + (static_cast<size_t>(yi) * p.w + xi) * p.c + ch);
  return kBf16 ? bf16_round(v) : v;
}

// One row's horizontal sum w0*v0 + w1*v1 as the window dtype takes it: in
// bf16 each product and the sum round to bf16.
template <bool kBf16>
__device__ __forceinline__ float row_sum(float w0, float v0, float w1, float v1) {
  float p0 = __fmul_rn(w0, v0);
  float p1 = __fmul_rn(w1, v1);
  if (!kBf16) return __fadd_rn(p0, p1);
  return bf16_round(__fadd_rn(bf16_round(p0), bf16_round(p1)));
}

// K1 (kGrad false) and K2 (kGrad true), one thread per output pixel of
// [n, h, w]. origin: tiled_origins_kernel's. K1 writes out [n, h, w, c];
// K2 reads ct [n, h, w, c] and writes cg [n, h, w, 2] f32 and grad_flow
// [n, h, w, 2] in flow's type.
template <typename TI, typename TF, bool kBf16, bool kConstant, bool kGrad>
__global__ void __launch_bounds__(kThreads)
    tiled_warp_kernel(const TI* __restrict__ img, const TF* __restrict__ flow,
                      const float* __restrict__ t, const int* __restrict__ origin,
                      const TI* __restrict__ ct, TI* __restrict__ out, float* __restrict__ cg,
                      TF* __restrict__ grad_flow, Tiled p) {
  const size_t pix = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t plane = static_cast<size_t>(p.h) * p.w;
  if (pix >= plane * p.n) return;
  const int n = static_cast<int>(pix / plane);
  const int rem = static_cast<int>(pix - static_cast<size_t>(n) * plane);
  const int y = rem / p.w, x = rem - y * p.w;
  const int ty = y / p.th, tx = x / p.tw;
  const int rows = y - ty * p.th, cols = x - tx * p.tw;
  const int* o = origin + ((static_cast<size_t>(n) * p.ty_n + ty) * p.tx_n + tx) * 2;
  const int oy = o[0], ox = o[1];
  const float tn = batch_t(t, p, n);
  const float fx = ld(flow + pix * 2), fy = ld(flow + pix * 2 + 1);
  // p + flow*t as one fused multiply-add, then the clip, the residual and
  // its clamp, the hat weights at the two taps (the twin's order of steps)
  const float sy_raw = __fmaf_rn(fy, tn, static_cast<float>(p.pt + y));
  const float sx_raw = __fmaf_rn(fx, tn, static_cast<float>(p.pl + x));
  const float sy = fminf(fmaxf(sy_raw, p.ylo), p.yhi);
  const float sx = fminf(fmaxf(sx_raw, p.xlo), p.xhi);
  const float ry_raw = __fsub_rn(__fsub_rn(sy, static_cast<float>(oy)), static_cast<float>(rows));
  const float rx_raw = __fsub_rn(__fsub_rn(sx, static_cast<float>(ox)), static_cast<float>(cols));
  const float ry = fminf(fmaxf(ry_raw, 0.f), p.ry_max);
  const float rx = fminf(fmaxf(rx_raw, 0.f), p.rx_max);
  const float a0 = floorf(ry), b0 = floorf(rx);
  const float wy0 = __fsub_rn(1.f, __fsub_rn(ry, a0));
  const float wy1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(a0, 1.f), ry));
  float wx0 = __fsub_rn(1.f, __fsub_rn(rx, b0));
  float wx1 = __fsub_rn(1.f, __fsub_rn(__fadd_rn(b0, 1.f), rx));
  if (kBf16) {
    wx0 = bf16_round(wx0);
    wx1 = bf16_round(wx1);
  }
  // content row and column of the upper-left tap
  const int yi = oy + rows + static_cast<int>(a0) - p.pt;
  const int xi = ox + cols + static_cast<int>(b0) - p.pl;
  const TI* img_n = img + static_cast<size_t>(n) * plane * p.c;
  if constexpr (!kGrad) {
    TI* dst = out + pix * p.c;
    for (int ch = 0; ch < p.c; ++ch) {
      const float in0 = row_sum<kBf16>(wx0, tap<TI, kBf16, kConstant>(img_n, p, yi, xi, ch), wx1,
                                       tap<TI, kBf16, kConstant>(img_n, p, yi, xi + 1, ch));
      const float in1 =
          row_sum<kBf16>(wx0, tap<TI, kBf16, kConstant>(img_n, p, yi + 1, xi, ch), wx1,
                         tap<TI, kBf16, kConstant>(img_n, p, yi + 1, xi + 1, ch));
      st(dst + ch, __fadd_rn(__fmul_rn(wy0, in0), __fmul_rn(wy1, in1)));
    }
  } else {
    // dhat: -1 at the lower tap, +1 at the upper, masked to 0 where the
    // forward saturates (source coordinate outside [lo, hi), residual
    // outside [0, nsh-1.001))
    const float my = (sy_raw >= p.ylo && sy_raw < p.yhi && ry_raw >= 0.f && ry_raw < p.ry_max)
                         ? 1.f : 0.f;
    const float mx = (sx_raw >= p.xlo && sx_raw < p.xhi && rx_raw >= 0.f && rx_raw < p.rx_max)
                         ? 1.f : 0.f;
    const TI* ct_p = ct + pix * p.c;
    float2 acc = make_float2(0.f, 0.f);
    for (int ch = 0; ch < p.c; ++ch) {
      const float v00 = tap<TI, kBf16, kConstant>(img_n, p, yi, xi, ch);
      const float v01 = tap<TI, kBf16, kConstant>(img_n, p, yi, xi + 1, ch);
      const float v10 = tap<TI, kBf16, kConstant>(img_n, p, yi + 1, xi, ch);
      const float v11 = tap<TI, kBf16, kConstant>(img_n, p, yi + 1, xi + 1, ch);
      // d out/d sy: vertical dhat over the interp rows
      const float in0 = row_sum<kBf16>(wx0, v00, wx1, v01);
      const float in1 = row_sum<kBf16>(wx0, v10, wx1, v11);
      const float gy = as_stored<TI>(__fadd_rn(__fmul_rn(-my, in0), __fmul_rn(my, in1)));
      // d out/d sx: horizontal dhat (exact in bf16), vertical hat
      const float dx0 = row_sum<kBf16>(-mx, v00, mx, v01);
      const float dx1 = row_sum<kBf16>(-mx, v10, mx, v11);
      const float gx = as_stored<TI>(__fadd_rn(__fmul_rn(wy0, dx0), __fmul_rn(wy1, dx1)));
      const float cv = ld(ct_p + ch);
      acc.y = __fadd_rn(acc.y, __fmul_rn(cv, gy));
      acc.x = __fadd_rn(acc.x, __fmul_rn(cv, gx));
    }
    reinterpret_cast<float2*>(cg)[pix] = acc;
    st(grad_flow + pix * 2, __fmul_rn(acc.x, tn));
    st(grad_flow + pix * 2 + 1, __fmul_rn(acc.y, tn));
  }
}

// The tile geometry of a launch; false where the kernel does not take it.
bool make_tiled(Tiled& p, int n, int h, int w, int c, int th, int tw, int ry, int rx, int pt,
                int pl, float t_scalar, int t_stride) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || th <= 0 || tw <= 0 || n > 65535) return false;
  p = Tiled{};
  p.n = n, p.h = h, p.w = w, p.c = c, p.th = th, p.tw = tw;
  p.ty_n = (h + th - 1) / th;
  p.tx_n = (w + tw - 1) / tw;
  if (p.ty_n > 65535 || static_cast<long long>(n) * h * w >= (1LL << 40)) return false;
  p.g = 1;
  while (th % (2 * p.g) == 0 && tw % (2 * p.g) == 0) p.g *= 2;
  p.levels = 0;
  while ((1 << p.levels) < p.g) ++p.levels;
  if (p.levels > kMaxLevels) return false;
  p.cy = th / p.g, p.cx = tw / p.g;
  p.cell_scale = static_cast<float>(static_cast<double>(p.g) * p.g / (static_cast<double>(th) * tw));
  p.pt = pt, p.pl = pl, p.ry = ry, p.rx = rx;
  p.t_scalar = t_scalar, p.t_stride = t_stride;
  return true;
}

template <typename TF, bool kBf16>
cudaError_t launch_origins(const Tiled& p, const void* flow, const float* t, void* cells,
                           int* origin, cudaStream_t s) {
  const dim3 grid(p.tx_n, p.ty_n, p.n);
  tiled_origins_kernel<TF, kBf16><<<grid, kThreads, 0, s>>>(
      static_cast<const TF*>(flow), t, static_cast<float2*>(cells), origin, p);
  return cudaGetLastError();
}

cudaError_t origins_typed(const Tiled& p, int flow_bf16, int bf16_window, const void* flow,
                          const float* t, void* cells, int* origin, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (flow_bf16)
    return bf16_window ? launch_origins<bf16, true>(p, flow, t, cells, origin, s)
                       : launch_origins<bf16, false>(p, flow, t, cells, origin, s);
  return bf16_window ? launch_origins<float, true>(p, flow, t, cells, origin, s)
                     : launch_origins<float, false>(p, flow, t, cells, origin, s);
}

template <typename TI, typename TF, bool kGrad>
cudaError_t launch_warp(const Tiled& p, int bf16_window, int constant, const void* img,
                        const void* flow, const float* t, const int* origin, const void* ct,
                        void* out, float* cg, void* grad_flow, cudaStream_t s) {
  const size_t pixels = static_cast<size_t>(p.n) * p.h * p.w;
  const unsigned blocks = static_cast<unsigned>((pixels + kThreads - 1) / kThreads);
  const TI* im = static_cast<const TI*>(img);
  const TF* fl = static_cast<const TF*>(flow);
  const TI* c = static_cast<const TI*>(ct);
  TI* o = static_cast<TI*>(out);
  TF* gf = static_cast<TF*>(grad_flow);
#define VFISR_TILED_LAUNCH(B, K)                                                           \
  tiled_warp_kernel<TI, TF, B, K, kGrad><<<blocks, kThreads, 0, s>>>(im, fl, t, origin, c, \
                                                                     o, cg, gf, p)
  if (bf16_window) {
    if (constant) VFISR_TILED_LAUNCH(true, true); else VFISR_TILED_LAUNCH(true, false);
  } else {
    if (constant) VFISR_TILED_LAUNCH(false, true); else VFISR_TILED_LAUNCH(false, false);
  }
#undef VFISR_TILED_LAUNCH
  return cudaGetLastError();
}

template <bool kGrad>
cudaError_t warp_typed(const Tiled& p, int img_bf16, int flow_bf16, int bf16_window, int constant,
                       const void* img, const void* flow, const float* t, const int* origin,
                       const void* ct, void* out, float* cg, void* grad_flow, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (img_bf16)
    return flow_bf16 ? launch_warp<bf16, bf16, kGrad>(p, bf16_window, constant, img, flow, t,
                                                      origin, ct, out, cg, grad_flow, s)
                     : launch_warp<bf16, float, kGrad>(p, bf16_window, constant, img, flow, t,
                                                       origin, ct, out, cg, grad_flow, s);
  return flow_bf16 ? launch_warp<float, bf16, kGrad>(p, bf16_window, constant, img, flow, t,
                                                     origin, ct, out, cg, grad_flow, s)
                   : launch_warp<float, float, kGrad>(p, bf16_window, constant, img, flow, t,
                                                      origin, ct, out, cg, grad_flow, s);
}

}  // namespace

// The window origins of a launch at tile (th, tw): origin [n, ceil(h/th),
// ceil(w/tw), 2] int32 (oy, ox), canvas coordinates; cells: f32 scratch of
// [n, ceil(h/th), ceil(w/tw), th/g * tw/g, 2] (g: the largest power of two
// dividing th and tw). flow: [n, h, w, 2] f32 or bf16 (flow_bf16); t: [n]
// f32 read as t[i * t_stride], or null for t_scalar; bf16_window: the
// window dtype (its row origin rounded down to even); (ry, rx): residual
// radii; (pt, pl): the content origin in the canvas for this tile. Returns
// the cudaError_t of the launch.
extern "C" int warp_tiled_origins_launch(const void* flow, const void* t, float t_scalar,
                                         int t_stride, void* cells, void* origin, int n, int h,
                                         int w, int flow_bf16, int bf16_window, int th, int tw,
                                         int ry, int rx, int pt, int pl, void* stream) {
  Tiled p;
  if (!make_tiled(p, n, h, w, 2, th, tw, ry, rx, pt, pl, t_scalar, t_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(origins_typed(p, flow_bf16, bf16_window, flow,
                                        static_cast<const float*>(t), cells,
                                        static_cast<int*>(origin), static_cast<cudaStream_t>(stream)));
}

// K1 (grad = 0) or K2 (grad = 1) at tile (th, tw) after
// warp_tiled_origins_launch on the same stream. img: [n, h, w, c] f32 or bf16
// (img_bf16); K1 writes out (img's shape and type); K2 reads ct (img's shape
// and type) and writes cg [n, h, w, 2] f32 and grad_flow (flow's shape and
// type). The clip bounds and residual clamps as ops/cuda/warp.py::_geometry
// gives them for this tile. All contiguous, all on the device of `stream`.
// Returns the cudaError_t of the launch.
extern "C" int warp_tiled_launch(const void* img, const void* flow, const void* t, float t_scalar,
                                 int t_stride, const void* origin, const void* ct, void* out,
                                 void* cg, void* grad_flow, int n, int h, int w, int c,
                                 int img_bf16, int flow_bf16, int bf16_window, int constant,
                                 int grad, int th, int tw, int ry, int rx, int pt, int pl,
                                 float ylo, float yhi, float xlo, float xhi, float ry_max,
                                 float rx_max, void* stream) {
  Tiled p;
  if (!make_tiled(p, n, h, w, c, th, tw, ry, rx, pt, pl, t_scalar, t_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grad && (reinterpret_cast<uintptr_t>(cg) % 8 || ct == nullptr || grad_flow == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.ylo = ylo, p.yhi = yhi, p.xlo = xlo, p.xhi = xhi;
  p.ry_max = ry_max, p.rx_max = rx_max;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(t);
  const int* o = static_cast<const int*>(origin);
  float* g = static_cast<float*>(cg);
  const cudaError_t err =
      grad ? warp_typed<true>(p, img_bf16, flow_bf16, bf16_window, constant, img, flow, tp, o, ct,
                              out, g, grad_flow, s)
           : warp_typed<false>(p, img_bf16, flow_bf16, bf16_window, constant, img, flow, tp, o,
                               ct, out, g, grad_flow, s);
  return static_cast<int>(err);
}
