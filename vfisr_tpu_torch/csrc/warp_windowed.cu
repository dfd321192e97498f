// Windowed backward warp for Hopper (sm_90a): the forward (K1), its flow
// gradient (K2) and the tile origin both of them compute.
//
// K1 replaces the TPU kernel vfisr_tpu/ops/pallas/warp.py::_warp_kernel
// (pallas_call at warp.py:348), weight_mode='interp', as reached through
// warp_windowed. It computes the same function: out[p] = bilinear sample of
// img at p + t*flow[p], where the sample position is clipped to the content
// (replicate border) or to r px past it over zeros (constant border), and
// the offset inside the tile's window is clamped to [0, nsh-1.001]. Each
// 32x256 output tile's window origin comes from its rounded tile-mean
// displacement.
//
// K2 replaces the same Pallas kernel in weight_mode='grad_y' and 'grad_x',
// launched twice by vfisr_tpu/core/warp.py::_pallas_warp_bwd (:182-185) and
// each followed there by a channel reduction with the cotangent (:186-187).
// Here one launch returns both reductions, cg = (d loss/d sx, d loss/d sy),
// and grad_flow = cg * t. The window origin is a constant of the backward,
// as in the reference (no gradient flows through the tile mean): K2
// recomputes the forward's origin from the same flow.
//
// The tile origin. The Pallas kernel takes it from a scalar-prefetch table
// that XLA computes in the same jit (pallas/warp.py:286-327). Here each CTA
// computes its own tile's origin (tile_origin, shared by K1, K2 and the
// origin-only entry that tests use), bit for bit as
// ops/cuda/warp.py::window_origins: the tile's flow, edge-clamped to tile
// multiples, reduced in f32 by five 2x2 halvings (one warp per 32x32 block,
// warp shuffles) and the row-major sum of the 8 block means times 0.125,
// then scaled by t, rounded half-even, offset and clamped into the canvas.
//
// What bounds K1 and K2 on the H100: bytes. Per pixel K1 does ~26 flops for
// the coordinates and weights and ~9 per channel, K2 ~30 and ~20 per
// channel, against C*2..4 bytes of img read, C*2..4 of out written (K2: ct
// read, and 8 of cg plus 4..8 of grad_flow written) and 4..8 bytes of flow:
// a few flops per byte, far below the card's ~20 flop/byte (f32) balance.
// The design answer: a CTA of 256 threads owns one 32x256 output tile, or a
// row slice of it (16, 8 or 4 rows) where a launch has too few tiles to
// fill the card or a tile's window would not leave room for two CTAs per
// SM. It copies its window, (rows + nsh_y - 1) rows of (256 + nsh_x - 1)
// pixels x C, from device memory into shared memory once, as img stores it:
// each window row is one contiguous run of an image row, moved in 16-byte
// cp.async chunks, many in flight and none through registers. Then each
// thread takes one column of the tile (in an image narrower than the tile,
// one column of each of several rows) and reads its 2x2 taps per output
// pixel from shared memory, clamping a tap into the content (replicate) or
// zeroing it outside (constant), and rounding it to bf16 where the window
// is bf16. So every image byte of a tile's window is read from device
// memory once per tile, not once per tap, and the flow of the next rows is
// in flight while a row is computed. K1 stages each
// warp's output rows in shared memory and writes them as one contiguous
// run; K2 writes cg and grad_flow as pairs. The tap arithmetic, the
// rounding steps and their order are those of the plain twin
// (ops/cuda/warp.py::warp_windowed_plain).
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared
// library and loaded with ctypes. Each entry returns a cudaError_t: of the
// launch, or cudaErrorInvalidValue / cudaErrorMisalignedAddress for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kTh = 32, kTw = 256;  // output tile; ops/cuda/warp.py TILE
constexpr int kThreads = kTw;       // one thread per tile column
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 2;           // rows whose flow a thread loads ahead
constexpr int kMinBlocks = 3;       // CTAs per SM the registers are capped for
constexpr int kMaxSplit = 8;        // row slices per tile: at least 4 rows each
// dynamic shared memory of one CTA: two CTAs fit in an SM's 228 KB with
// kSmemTwo each; kSmemMax is one CTA's limit (227 KB less the static part)
constexpr size_t kSmemTwo = 112 * 1024, kSmemMax = 226 * 1024;
// the tile mean's halving chain: 32x32 blocks (g = 32), one per warp, then
// a 1x8 remainder, as window_origins takes it for a 32x256 tile
static_assert(kTw / kTh == kWarps, "one warp per 32x32 block of the tile");

struct Params {
  int n, h, w, c;
  int ty_n, tx_n;       // tiles per image (content rounded up to the tile)
  int pt, pl;           // content origin inside the canvas
  int ry, rx;           // residual radii
  int split, rows;      // CTAs per tile (row slices), output rows per CTA
  int lanes, subrows;   // threads per output row (w rounded up to 32, at most
                        // 256) and rows computed side by side
  int wh, ww;           // window rows and columns of a CTA
  int pitch;            // bytes per window row in shared memory
  int win_offset;       // byte offset of the window in dynamic shared memory
  int stage_offset;     // byte offset of K1's per-warp output staging buffers
  int t_stride;         // t[n * t_stride], or t_scalar where t is null
  float t_scalar;
  float ylo, yhi;       // source-coordinate clip bounds (canvas space)
  float xlo, xhi;
  float ry_max, rx_max;  // nsh - 1.001: residual clamp
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
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
__device__ __forceinline__ void st_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ float batch_t(const float* __restrict__ t, const Params& p, int n) {
  return t ? __ldg(t + n * p.t_stride) : p.t_scalar;
}

// One 2x2 halving step of the tile mean: e holds row 2i, o row 2i+1 of the
// level below, in lanes s apart; the result, valid in lanes that are
// multiples of 2s, is (((a00 + a01) + a10) + a11) * 0.25.
__device__ __forceinline__ float2 halve(float2 e, float2 o, int s) {
  const unsigned all = 0xffffffffu;
  const float ex = __shfl_down_sync(all, e.x, s), ey = __shfl_down_sync(all, e.y, s);
  const float ox = __shfl_down_sync(all, o.x, s), oy = __shfl_down_sync(all, o.y, s);
  return make_float2(__fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(e.x, ex), o.x), ox), 0.25f),
                     __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(e.y, ey), o.y), oy), 0.25f));
}

// The effective window origin of tile (n, ty, tx), canvas coordinates, as
// int2 (x: ox, y: oy), bit for bit as ops/cuda/warp.py::window_origins. Every
// thread of the CTA calls it (shuffles and one barrier) and gets the same
// result. Warp k reduces the tile's 32x32 block of columns 32k..32k+31, one
// column per lane, rows read 8 at a time; _rn intrinsics keep nvcc from
// contracting any step, since the order of the sums is what makes rounding
// ties fall as the reference's.
template <typename TF, bool kBf16>
__device__ int2 tile_origin(const TF* __restrict__ flow, float tn, const Params& p, int n,
                            int ty, int tx, float2* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = min(tx * kTw + static_cast<int>(threadIdx.x), p.w - 1);  // edge padding
  const TF* base = flow + static_cast<size_t>(n) * p.h * p.w * 2;
  float2 l3[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float2 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int y = min(ty * kTh + q * 8 + i, p.h - 1);
      const TF* f = base + (static_cast<size_t>(y) * p.w + x) * 2;
      v[i] = make_float2(ld(f), ld(f + 1));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = halve(v[2 * i], v[2 * i + 1], 1);
    v[0] = halve(v[0], v[1], 2);
    v[1] = halve(v[2], v[3], 2);
    l3[q] = halve(v[0], v[1], 4);
  }
  const float2 m = halve(halve(l3[0], l3[1], 8), halve(l3[2], l3[3], 8), 16);
  if (lane == 0) part[warp] = m;
  __syncthreads();
  float mx = part[0].x, my = part[0].y;
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    mx = __fadd_rn(mx, part[k].x);
    my = __fadd_rn(my, part[k].y);
  }
  // * g*g/(th*tw), then * t
  mx = __fmul_rn(__fmul_rn(mx, 0.125f), tn);
  my = __fmul_rn(__fmul_rn(my, 0.125f), tn);
  // round half-even (torch.round), as 64-bit ints like the reference's
  long long oy = p.pt + ty * kTh + __float2ll_rn(my) - (p.ry + 1);
  long long ox = p.pl + tx * kTw + __float2ll_rn(mx) - (p.rx + 1);
  oy = min(max(oy, 0LL), static_cast<long long>(p.pt + p.ty_n * kTh));
  ox = min(max(ox, 0LL), static_cast<long long>(p.pl + p.tx_n * kTw));
  if (kBf16) oy -= oy & 1;  // the TPU's bf16 rolls drop the odd row slack
  return make_int2(static_cast<int>(ox), static_cast<int>(oy));  // (x, y)
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Copies this CTA's window into shared memory, as the image stores it:
// window row i (canvas row oy_row + i) holds content row yc = oy_row + i - pt
// (clamped into the content; with the constant border a row outside it is
// not copied and row_off[i] = -1), columns [xa, xb) with all channels, so a
// row is one contiguous run of the image. Each run is copied as the 16-byte
// aligned chunks that cover it (cp.async, no registers), and row_off[i] is
// the byte offset of its first element in the window. A chunk may reach up
// to 15 bytes past either end of the run, never past the 16-byte aligned
// bounds of the device allocation that holds it (CUDA's and torch's
// allocations are at least 256-byte aligned and sized). Columns outside
// [xa, xb) are never read: the taps clamp into it (replicate) or read zero
// (constant).
template <typename TI, bool kConstant>
__device__ __forceinline__ void fill_window(const TI* __restrict__ src, unsigned char* win,
                                            int* row_off, int oy_row, int xa, int xb,
                                            const Params& p) {
  const int run = (xb - xa) * p.c * static_cast<int>(sizeof(TI));  // bytes
  const int chunks = run / 16 + 2;  // enough from any alignment; p.pitch holds them
  for (int e = threadIdx.x; e < p.wh * chunks; e += kThreads) {
    const int i = e / chunks, q = e - i * chunks;
    int yc = oy_row + i - p.pt;
    const bool ok = !kConstant || (yc >= 0 && yc < p.h);
    yc = min(max(yc, 0), p.h - 1);
    const unsigned char* g = reinterpret_cast<const unsigned char*>(
        src + (static_cast<size_t>(yc) * p.w + xa) * p.c);
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
    if (q == 0) row_off[i] = ok ? i * p.pitch + off : -1;
    if (ok && q * 16 < off + run) cp_async16(win + i * p.pitch + q * 16, g - off + q * 16);
  }
  cp_async_wait_all();
}

// One window value as the window dtype holds it: img's element, rounded to
// bf16 with a bf16 window (exact for a bf16 img).
template <typename TI, bool kBf16>
__device__ __forceinline__ float win_val(const unsigned char* a);
template <>
__device__ __forceinline__ float win_val<float, false>(const unsigned char* a) {
  return *reinterpret_cast<const float*>(a);
}
template <>
__device__ __forceinline__ float win_val<float, true>(const unsigned char* a) {
  return bf16_round(*reinterpret_cast<const float*>(a));
}
template <>
__device__ __forceinline__ float win_val<__nv_bfloat16, false>(const unsigned char* a) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(a));
}
template <>
__device__ __forceinline__ float win_val<__nv_bfloat16, true>(const unsigned char* a) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(a));
}

// Where one output pixel samples: everything K1 and K2 compute once for all
// channels of a pass.
struct Sample {
  float sy_raw, sx_raw;  // source coordinate before the clip (canvas)
  float ry_raw, rx_raw;  // residual inside the window before its clamp
  float wy0, wy1;        // vertical hat weights at the two taps
  float wx0, wx1;        // horizontal hat weights (bf16-rounded with kBf16)
  int wi, wj;            // this CTA's window row and column of the upper-left tap
};

// Explicit fmaf and _rn intrinsics fix where each step rounds (nvcc would
// otherwise contract at will): the source coordinate p + flow*t is one
// fused multiply-add, as XLA compiles the reference's expression. rows and
// cols: the pixel's place in its tile; row0: the tile row of window row 0.
template <bool kBf16>
__device__ __forceinline__ Sample sample_at(float fx, float fy, float tn, int2 o,
                                            const Params& p, int y, int x, int rows, int cols,
                                            int row0) {
  Sample s;
  s.sy_raw = __fmaf_rn(fy, tn, static_cast<float>(p.pt + y));
  s.sx_raw = __fmaf_rn(fx, tn, static_cast<float>(p.pl + x));
  const float sy = fminf(fmaxf(s.sy_raw, p.ylo), p.yhi);
  const float sx = fminf(fmaxf(s.sx_raw, p.xlo), p.xhi);
  s.ry_raw = __fsub_rn(__fsub_rn(sy, static_cast<float>(o.y)), static_cast<float>(rows));
  s.rx_raw = __fsub_rn(__fsub_rn(sx, static_cast<float>(o.x)), static_cast<float>(cols));
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
  s.wi = rows - row0 + static_cast<int>(a0);
  s.wj = cols + static_cast<int>(b0);
  return s;
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

// The CTA's place: tile (n, ty, tx) and its row slice, whose first output
// row is the tile's row0 and which has `rows_n` rows inside the content.
struct Place {
  int n, ty, tx, row0, y0, rows_n;
};

__device__ __forceinline__ Place place(const Params& p) {
  Place c;
  c.n = blockIdx.z;
  c.ty = blockIdx.y / p.split;
  c.tx = blockIdx.x;
  c.row0 = (blockIdx.y % p.split) * p.rows;
  c.y0 = c.ty * kTh + c.row0;
  c.rows_n = min(p.rows, p.h - c.y0);
  return c;
}

// The flow of slice rows r + g * subrows (g < kGroup) at this thread's
// column (fl points at row 0 of the slice), 0 past the slice or the content.
template <typename TF>
__device__ __forceinline__ void load_flow(const TF* __restrict__ fl, int r, int rows_n, bool live,
                                          const Params& p, float* fx, float* fy) {
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int rg = r + g * p.subrows;
    const bool ok = live && rg < rows_n;
    const TF* f = fl + static_cast<size_t>(ok ? rg : 0) * p.w * 2;
    fx[g] = ok ? ld(f) : 0.f;
    fy[g] = ok ? ld(f + 1) : 0.f;
  }
}

// Where a pixel's 2x2 taps lie in the window: byte offsets of the two rows
// and the two columns (clamped into the copied columns [xa, xb)), and
// whether each tap is inside the content (constant border; always with
// replicate).
struct Taps {
  int row[2], col[2];
  bool ok[2][2];
};

template <typename TI, bool kConstant>
__device__ __forceinline__ Taps taps_at(const Sample& s, const int* row_off, int xc0, int xa,
                                        int xb, const Params& p) {
  Taps q;
  bool okr[2], okc[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ro = row_off[s.wi + k];
    okr[k] = !kConstant || ro >= 0;
    q.row[k] = max(ro, 0);
    const int xq = xc0 + s.wj + k;  // content column of the tap
    okc[k] = !kConstant || (xq >= 0 && xq < p.w);
    q.col[k] = (min(max(xq, xa), xb - 1) - xa) * p.c * static_cast<int>(sizeof(TI));
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) q.ok[a][b] = okr[a] && okc[b];
  return q;
}

// The 2x2 taps of channel ch, as the window dtype holds them.
template <typename TI, bool kBf16>
__device__ __forceinline__ void tap_values(const unsigned char* win, const Taps& q, int ch,
                                           float v[2][2]) {
  const int cb = ch * static_cast<int>(sizeof(TI));
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float val = win_val<TI, kBf16>(win + q.row[a] + q.col[b] + cb);
      v[a][b] = q.ok[a][b] ? val : 0.f;
    }
}

// The shared memory every CTA of a launch lays out the same way, and the
// columns of the content its window copies.
struct Window {
  int* row_off;        // [wh]: byte offset of each window row's run, -1: zeros
  unsigned char* win;  // [wh][pitch] bytes
  int xc0, xa, xb;     // content column of window column 0; copied columns
};

__device__ __forceinline__ Window window_of(unsigned char* smem, int2 o, const Params& p) {
  Window wd;
  wd.row_off = reinterpret_cast<int*>(smem);
  wd.win = smem + p.win_offset;
  wd.xc0 = o.x - p.pl;
  wd.xa = min(max(wd.xc0, 0), p.w - 1);
  wd.xb = min(max(wd.xc0 + p.ww - 1, 0), p.w - 1) + 1;
  return wd;
}

// K1. kBf16: window values, horizontal weights and horizontal sums in bf16
// (compute_dtype=bfloat16); the vertical accumulation stays f32.
// kConstant: zero canvas outside the content instead of edge replication.
template <typename TI, typename TF, bool kBf16, bool kConstant>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    warp_windowed_kernel(const TI* __restrict__ img, const TF* __restrict__ flow,
                         const float* __restrict__ t, TI* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 part[kWarps];
  const Place c = place(p);
  const float tn = batch_t(t, p, c.n);
  const int2 o = tile_origin<TF, kBf16>(flow, tn, p, c.n, c.ty, c.tx, part);
  if (c.rows_n <= 0) return;  // a slice of the tile's edge padding: the whole CTA
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // an image narrower than the tile computes subrows rows side by side
  const int sub = threadIdx.x / p.lanes, cols = threadIdx.x - sub * p.lanes;
  const int x = c.tx * kTw + cols;
  const int xw = x - lane;  // the warp's first column
  const bool live = sub < p.subrows && x < p.w;
  const Window wd = window_of(smem, o, p);
  TI* stage = reinterpret_cast<TI*>(smem + p.stage_offset) + warp * (kGroup * 32 * p.c);
  const TF* fl = flow + ((static_cast<size_t>(c.n) * p.h + c.y0) * p.w + x) * 2;
  const int step = kGroup * p.subrows;
  float fx[kGroup], fy[kGroup];
  load_flow(fl, sub, c.rows_n, live, p, fx, fy);  // in flight during the copy
  fill_window<TI, kConstant>(img + static_cast<size_t>(c.n) * p.h * p.w * p.c, wd.win,
                             wd.row_off, o.y + c.row0, wd.xa, wd.xb, p);
  __syncthreads();
  if (sub >= p.subrows) return;  // whole warps: lanes is a multiple of 32
  for (int r = sub; r < c.rows_n; r += step) {
    float nfx[kGroup], nfy[kGroup];
    load_flow(fl, r + step, c.rows_n, live, p, nfx, nfy);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (!live || r + g * p.subrows >= c.rows_n) continue;
      const int y = c.y0 + r + g * p.subrows;
      const Sample s = sample_at<kBf16>(fx[g], fy[g], tn, o, p, y, x, y - c.ty * kTh, cols,
                                        c.row0);
      const Taps q = taps_at<TI, kConstant>(s, wd.row_off, wd.xc0, wd.xa, wd.xb, p);
      TI* dst = stage + (g * 32 + lane) * p.c;
      for (int ch = 0; ch < p.c; ++ch) {
        float v[2][2];
        tap_values<TI, kBf16>(wd.win, q, ch, v);
        const float in0 = row_sum<kBf16>(s.wx0, v[0][0], s.wx1, v[0][1]);
        const float in1 = row_sum<kBf16>(s.wx0, v[1][0], s.wx1, v[1][1]);
        st(dst + ch, __fadd_rn(__fmul_rn(s.wy0, in0), __fmul_rn(s.wy1, in1)));
      }
    }
    // each of the warp's rows: one contiguous run of 32 pixels
    __syncwarp();
    const int run = min(32, p.w - xw) * p.c;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int rg = r + g * p.subrows;
      if (rg >= c.rows_n) break;
      TI* dst = out + ((static_cast<size_t>(c.n) * p.h + c.y0 + rg) * p.w + xw) * p.c;
      const TI* from = stage + g * 32 * p.c;
      for (int k = lane; k < run; k += 32) dst[k] = from[k];
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      fx[g] = nfx[g];
      fy[g] = nfy[g];
    }
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
// channels in f32, in channel order: cg = (d loss/d sx, d loss/d sy), and
// grad_flow = cg * t. The cotangent is read kCt channels of a row group at
// a time, all in flight together.
constexpr int kCt = 4;

template <typename TI, typename TF, bool kBf16, bool kConstant>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    warp_windowed_grad_kernel(const TI* __restrict__ img, const TF* __restrict__ flow,
                              const float* __restrict__ t, const TI* __restrict__ ct,
                              TF* __restrict__ grad_flow, float* __restrict__ cg, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 part[kWarps];
  const Place c = place(p);
  const float tn = batch_t(t, p, c.n);
  const int2 o = tile_origin<TF, kBf16>(flow, tn, p, c.n, c.ty, c.tx, part);
  if (c.rows_n <= 0) return;
  const int sub = threadIdx.x / p.lanes, cols = threadIdx.x - sub * p.lanes;
  const int x = c.tx * kTw + cols;
  const bool live = sub < p.subrows && x < p.w;
  const Window wd = window_of(smem, o, p);
  const size_t pix0 = (static_cast<size_t>(c.n) * p.h + c.y0) * p.w + x;  // row 0 of the slice
  const TF* fl = flow + pix0 * 2;
  const int step = kGroup * p.subrows;
  float fx[kGroup], fy[kGroup];
  load_flow(fl, sub, c.rows_n, live, p, fx, fy);
  fill_window<TI, kConstant>(img + static_cast<size_t>(c.n) * p.h * p.w * p.c, wd.win,
                             wd.row_off, o.y + c.row0, wd.xa, wd.xb, p);
  __syncthreads();
  if (sub >= p.subrows) return;
  for (int r = sub; r < c.rows_n; r += step) {
    float nfx[kGroup], nfy[kGroup];
    load_flow(fl, r + step, c.rows_n, live, p, nfx, nfy);
    float2 acc[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) acc[g] = make_float2(0.f, 0.f);
    for (int c0 = 0; c0 < p.c; c0 += kCt) {
      float cv[kGroup][kCt];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int u = 0; u < kCt; ++u) {
          const int rg = r + g * p.subrows;
          const bool ok = live && rg < c.rows_n && c0 + u < p.c;
          cv[g][u] = ok ? ld(ct + (pix0 + static_cast<size_t>(rg) * p.w) * p.c + c0 + u) : 0.f;
        }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (!live || r + g * p.subrows >= c.rows_n) continue;
        const int y = c.y0 + r + g * p.subrows;
        const Sample s = sample_at<kBf16>(fx[g], fy[g], tn, o, p, y, x, y - c.ty * kTh, cols,
                                          c.row0);
        const float my = (s.sy_raw >= p.ylo && s.sy_raw < p.yhi && s.ry_raw >= 0.f &&
                          s.ry_raw < p.ry_max) ? 1.f : 0.f;
        const float mx = (s.sx_raw >= p.xlo && s.sx_raw < p.xhi && s.rx_raw >= 0.f &&
                          s.rx_raw < p.rx_max) ? 1.f : 0.f;
        const Taps q = taps_at<TI, kConstant>(s, wd.row_off, wd.xc0, wd.xa, wd.xb, p);
#pragma unroll
        for (int u = 0; u < kCt; ++u) {
          if (c0 + u >= p.c) break;
          float v[2][2];
          tap_values<TI, kBf16>(wd.win, q, c0 + u, v);
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
          acc[g].y = __fadd_rn(acc[g].y, __fmul_rn(cv[g][u], gy));
          acc[g].x = __fadd_rn(acc[g].x, __fmul_rn(cv[g][u], gx));
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (!live || r + g * p.subrows >= c.rows_n) continue;
      const size_t pix = pix0 + static_cast<size_t>(r + g * p.subrows) * p.w;
      reinterpret_cast<float2*>(cg)[pix] = acc[g];
      st_pair(grad_flow + pix * 2, __fmul_rn(acc[g].x, tn), __fmul_rn(acc[g].y, tn));
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      fx[g] = nfx[g];
      fy[g] = nfy[g];
    }
  }
}

// The tile origins alone, [n, ty_n, tx_n, 2] int32 (oy, ox): what K1 and K2
// compute in their prologue, for tests that hold it against window_origins.
template <typename TF, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    origins_kernel(const TF* __restrict__ flow, const float* __restrict__ t,
                   int* __restrict__ origin, Params p) {
  __shared__ float2 part[kWarps];
  const int n = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
  const int2 o = tile_origin<TF, kBf16>(flow, batch_t(t, p, n), p, n, ty, tx, part);
  if (threadIdx.x == 0) {
    int* d = origin + ((static_cast<size_t>(n) * p.ty_n + ty) * p.tx_n + tx) * 2;
    d[0] = o.y;
    d[1] = o.x;
  }
}

size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// Tiles, row slices and shared memory of a launch. split: row slices per
// tile (1, 2, 4 or 8), the fewest that give two CTAs per SM (so a small
// image still spreads over the card) and a window that leaves room for two
// CTAs per SM, else for one; a window that fits neither at 4 rows per CTA
// is refused (cudaErrorInvalidValue). K1 (staging) also holds its output
// staging buffers. Returns the dynamic shared memory in *smem.
cudaError_t plan(Params& p, int nsh_y, int nsh_x, size_t img_bytes, bool staging, int* dev,
                 size_t* smem) {
  if (p.n <= 0 || p.h <= 0 || p.w <= 0 || p.c <= 0 || nsh_y < 2 || nsh_x < 2)
    return cudaErrorInvalidValue;
  p.ty_n = (p.h + kTh - 1) / kTh;
  p.tx_n = (p.w + kTw - 1) / kTw;
  int sms = 0;
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(p.n) * p.ty_n * p.tx_n;
  int split = 1;
  while (split < kMaxSplit && tiles * split < 2LL * sms) split *= 2;
  p.lanes = min(kTw, (p.w + 31) / 32 * 32);
  p.subrows = kThreads / p.lanes;
  p.ww = kTw + nsh_x - 1;
  p.pitch = static_cast<int>(round16(p.ww * p.c * img_bytes) + 32);  // + alignment slack
  const size_t stage = staging ? static_cast<size_t>(kWarps) * kGroup * 32 * p.c * img_bytes : 0;
  size_t bytes = 0;
  for (const size_t budget : {kSmemTwo, kSmemMax}) {
    for (int s = split; s <= kMaxSplit; s *= 2) {
      const int wh = kTh / s + nsh_y - 1;
      const size_t win_offset = round16(sizeof(int) * wh);
      bytes = win_offset + static_cast<size_t>(wh) * p.pitch + stage;
      if (bytes <= budget) {
        p.split = s;
        p.rows = kTh / s;
        p.wh = wh;
        p.win_offset = static_cast<int>(win_offset);
        p.stage_offset = static_cast<int>(bytes - stage);
        if (p.n > 65535 || static_cast<long long>(p.ty_n) * s > 65535)
          return cudaErrorInvalidValue;
        *smem = bytes;
        return cudaSuccess;
      }
    }
  }
  return cudaErrorInvalidValue;  // the window does not fit in shared memory
}

// Lets `kernel` take up to kSmemMax of dynamic shared memory on device dev,
// once per kernel and device (done: the kernel's own flags), so that no
// attribute call falls inside a CUDA-graph capture after the first launch.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, int dev, bool* done) {
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemMax));
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename TI, typename TF>
struct Interp {
  template <bool kBf16, bool kConstant>
  static cudaError_t run(dim3 grid, size_t smem, int dev, cudaStream_t stream, const Params& p,
                         const void* img, const void* flow, const float* t, void* out) {
    static bool done[kMaxDevices] = {};
    auto kernel = warp_windowed_kernel<TI, TF, kBf16, kConstant>;
    const cudaError_t err = set_smem(kernel, dev, done);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const TI*>(img),
                                             static_cast<const TF*>(flow), t,
                                             static_cast<TI*>(out), p);
    return cudaGetLastError();
  }
};

template <typename TI, typename TF>
struct Grad {
  template <bool kBf16, bool kConstant>
  static cudaError_t run(dim3 grid, size_t smem, int dev, cudaStream_t stream, const Params& p,
                         const void* img, const void* flow, const float* t, const void* ct,
                         void* grad_flow, float* cg) {
    static bool done[kMaxDevices] = {};
    auto kernel = warp_windowed_grad_kernel<TI, TF, kBf16, kConstant>;
    const cudaError_t err = set_smem(kernel, dev, done);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const TI*>(img), static_cast<const TF*>(flow), t,
        static_cast<const TI*>(ct), static_cast<TF*>(grad_flow), cg, p);
    return cudaGetLastError();
  }
};

// Instantiates and launches K1 or K2 (Kernel::run) for the window dtype and
// border of the call.
template <typename Kernel, typename... Args>
cudaError_t launch_modes(dim3 grid, size_t smem, int dev, int bf16_window, int constant,
                         cudaStream_t stream, const Params& p, Args... args) {
  if (bf16_window)
    return constant ? Kernel::template run<true, true>(grid, smem, dev, stream, p, args...)
                    : Kernel::template run<true, false>(grid, smem, dev, stream, p, args...);
  return constant ? Kernel::template run<false, true>(grid, smem, dev, stream, p, args...)
                  : Kernel::template run<false, false>(grid, smem, dev, stream, p, args...);
}

// Picks the kernel's img and flow element types.
template <template <typename, typename> class Kernel, typename... Args>
cudaError_t launch_typed(int img_bf16, int flow_bf16, Args... args) {
  using bf16 = __nv_bfloat16;
  if (img_bf16)
    return flow_bf16 ? launch_modes<Kernel<bf16, bf16>>(args...)
                     : launch_modes<Kernel<bf16, float>>(args...);
  return flow_bf16 ? launch_modes<Kernel<float, bf16>>(args...)
                   : launch_modes<Kernel<float, float>>(args...);
}

Params make_params(int n, int h, int w, int c, float t_scalar, int t_stride, int ry, int rx,
                   int pt, int pl, float ylo, float yhi, float xlo, float xhi, float ry_max,
                   float rx_max) {
  Params p{};
  p.n = n, p.h = h, p.w = w, p.c = c;
  p.t_scalar = t_scalar, p.t_stride = t_stride;
  p.ry = ry, p.rx = rx, p.pt = pt, p.pl = pl;
  p.ylo = ylo, p.yhi = yhi, p.xlo = xlo, p.xhi = xhi;
  p.ry_max = ry_max, p.rx_max = rx_max;
  return p;
}

}  // namespace

// K1. img/out: [n, h, w, c] f32 or bf16 (img_bf16); flow: [n, h, w, 2] f32 or
// bf16 (flow_bf16), (dx, dy); t: [n] f32 read as t[i * t_stride], or null
// for t_scalar. (ry, rx): residual radii; (pt, pl): the content's origin in
// the canvas; nsh_y, nsh_x: taps per axis; the clip bounds and residual
// clamps as ops/cuda/warp.py::_geometry gives them. All contiguous, all on
// the device of `stream`. Returns the cudaError_t of the launch.
extern "C" int warp_windowed_launch(
    const void* img, const void* flow, const void* t, float t_scalar, int t_stride, void* out,
    int n, int h, int w, int c, int img_bf16, int flow_bf16, int bf16_window, int constant,
    int ry, int rx, int pt, int pl, int nsh_y, int nsh_x, float ylo, float yhi, float xlo,
    float xhi, float ry_max, float rx_max, void* stream) {
  Params p = make_params(n, h, w, c, t_scalar, t_stride, ry, rx, pt, pl, ylo, yhi, xlo, xhi,
                         ry_max, rx_max);
  size_t smem = 0;
  int dev = 0;
  cudaError_t err = plan(p, nsh_y, nsh_x, img_bf16 ? 2 : 4, true, &dev, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.tx_n, p.ty_n * p.split, p.n);
  return static_cast<int>(launch_typed<Interp>(
      img_bf16, flow_bf16, grid, smem, dev, bf16_window, constant,
      static_cast<cudaStream_t>(stream), p, img, flow, static_cast<const float*>(t), out));
}

// K2. The arguments of warp_windowed_launch, plus ct: [n, h, w, c] in img's
// type (the cotangent of out); grad_flow: [n, h, w, 2] in flow's type; cg:
// [n, h, w, 2] f32, (d loss/d sx, d loss/d sy); both written as pairs, so
// aligned to a pair. Returns the cudaError_t.
extern "C" int warp_windowed_grad_launch(
    const void* img, const void* flow, const void* t, float t_scalar, int t_stride,
    const void* ct, void* grad_flow, void* cg, int n, int h, int w, int c, int img_bf16,
    int flow_bf16, int bf16_window, int constant, int ry, int rx, int pt, int pl, int nsh_y,
    int nsh_x, float ylo, float yhi, float xlo, float xhi, float ry_max, float rx_max,
    void* stream) {
  if (reinterpret_cast<uintptr_t>(cg) % 8 ||
      reinterpret_cast<uintptr_t>(grad_flow) % (flow_bf16 ? 4 : 8))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p = make_params(n, h, w, c, t_scalar, t_stride, ry, rx, pt, pl, ylo, yhi, xlo, xhi,
                         ry_max, rx_max);
  size_t smem = 0;
  int dev = 0;
  cudaError_t err = plan(p, nsh_y, nsh_x, img_bf16 ? 2 : 4, false, &dev, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.tx_n, p.ty_n * p.split, p.n);
  return static_cast<int>(launch_typed<Grad>(
      img_bf16, flow_bf16, grid, smem, dev, bf16_window, constant,
      static_cast<cudaStream_t>(stream), p, img, flow, static_cast<const float*>(t), ct,
      grad_flow, static_cast<float*>(cg)));
}

// The tile origins K1 and K2 compute, alone: origin [n, ceil(h/32),
// ceil(w/256), 2] int32 (oy, ox), canvas coordinates. The other arguments
// as warp_windowed_launch's. Returns the cudaError_t of the launch.
extern "C" int warp_windowed_origins_launch(
    const void* flow, const void* t, float t_scalar, int t_stride, void* origin, int n, int h,
    int w, int flow_bf16, int bf16_window, int ry, int rx, int pt, int pl, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(n, h, w, 2, t_scalar, t_stride, ry, rx, pt, pl, 0.f, 0.f, 0.f, 0.f,
                         0.f, 0.f);
  p.ty_n = (h + kTh - 1) / kTh;
  p.tx_n = (w + kTw - 1) / kTw;
  if (p.ty_n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.tx_n, p.ty_n, p.n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(t);
  int* o = static_cast<int*>(origin);
  using bf16 = __nv_bfloat16;
  if (flow_bf16) {
    const bf16* f = static_cast<const bf16*>(flow);
    if (bf16_window)
      origins_kernel<bf16, true><<<grid, kThreads, 0, s>>>(f, tp, o, p);
    else
      origins_kernel<bf16, false><<<grid, kThreads, 0, s>>>(f, tp, o, p);
  } else {
    const float* f = static_cast<const float*>(flow);
    if (bf16_window)
      origins_kernel<float, true><<<grid, kThreads, 0, s>>>(f, tp, o, p);
    else
      origins_kernel<float, false><<<grid, kThreads, 0, s>>>(f, tp, o, p);
  }
  return static_cast<int>(cudaGetLastError());
}
