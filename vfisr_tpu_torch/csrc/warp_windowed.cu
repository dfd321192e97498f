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
// Channel groups (warp_grouped_kernel: K1 and K2). A window of all C
// channels that fits in shared memory at 4 rows per CTA takes the whole-C
// layout above (warp_windowed_kernel, warp_windowed_grad_kernel). A wider
// one (SAFA's 176-channel feature warps: past 9 channels at f32, r = 8 in
// K1, 10 in K2) is walked in channel groups of one 16-byte vector each (4
// f32 or 8 bf16 channels). What bounds it is bytes too: img read once and
// out written once (K2: img and ct read once), ~0.02 ms at SAFA's shapes.
// Against that stand the window's halo (nsh - 1 = 17 rows and columns at
// r = 8) and the image's layout: a pixel's 176 channels are one 704-byte
// run, so a copy or store of one group per pixel moves 16 bytes per
// 704-byte line, and the memory system then spends a request on every 16
// bytes. The design:
// - A CTA's unit is (tile, 16x16 pixel block, channel chunk), one pixel
//   per thread, so no thread idles on a 48- or 144-wide image. The plan
//   takes the fewest chunks (runs of consecutive groups) per tile that
//   give every SM a CTA: one at SAFA's shapes.
// - The prologue runs once per CTA, not once per group: the tile origin,
//   each pixel's coordinates, weights and tap offsets, and the footprint:
//   the box of content rows and columns that the block's taps reach, after
//   the residual clamp. Only that box is copied, so SAFA's small trained
//   flows copy a few halo rows and columns, not 17; a flow up to the clamp
//   still finds its taps (a ring slot is sized for one group of the worst
//   box at launch).
// - A ring of kRingSlots slots in shared memory: cp.async with commit
//   groups, the next slots in flight while one is computed (one barrier per
//   slot). A slot holds as many groups of the box as fit (a power of two,
//   up to 8): each box column's groups are one run, copied from one
//   contiguous run of img (up to a 128-byte line) and swizzled so that the
//   lanes reading one group of consecutive columns hit distinct banks.
// - K1 gives a slot's (pixel, group) items to the threads group fastest,
//   reading each pixel's taps and weights from a table in shared memory,
//   so a warp writes each pixel's groups of the slot as one run of 16-byte
//   stores.
// - K2 keeps its pixel per thread and accumulates it over all C channels
//   in channel order, across the slots, as the whole-C kernel does; the
//   block's cotangent rides in the same slot (copied the same way); it
//   writes cg and grad_flow = cg * t itself: one launch. Where the plan
//   takes several chunks per tile the chunks' partial sums go to an f32
//   scratch [chunks, n, h, w, 2] and grad_chunks_sum_kernel adds them in
//   chunk order. No atomics: two launches give the same bits.
// Where C channels are not whole 16-byte vectors or a pointer is not
// 16-byte aligned, the same ring is filled and written element by element.
// The per-channel arithmetic is the whole-C kernels': grouped K1 gives the
// plain twin's bits.
//
// Plain C interface, no PyTorch headers: built by nvcc into a shared
// library and loaded with ctypes. Each entry returns a cudaError_t: of the
// launch, or cudaErrorInvalidValue / cudaErrorMisalignedAddress for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>
#include <type_traits>

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
  int grouped;          // 1: channel groups (warp_grouped_kernel); 0: whole C
  int groups, cg;       // channel groups per pixel and channels per group
                        // (whole C: 1 and c; grouped: 16-byte groups)
  int vec16;            // grouped: 16-byte copies and stores (else element
                        // by element)
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

// The rest of a channel-group plan, a kernel parameter of the grouped
// kernels only: a larger Params changes how NVVM compiles the whole-C
// kernels (it made them up to 5% slower on the H100).
struct GroupPlan {
  int bx_n;                 // pixel blocks across a tile (split per tile)
  int chunks, chunk_vec;    // chunks of chunk_vec groups per tile
  int stage_bytes;          // bytes of a ring slot
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
  constexpr int kB = static_cast<int>(sizeof(TI));
  const int run = (xb - xa) * p.c * kB;  // bytes
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

// The CTA's place: tile (n, ty, tx), its row slice, whose first output
// row is the tile's row0 and which has `rows_n` rows inside the content,
// and its channels (all C).
struct Place {
  int n, ty, tx, row0, y0, rows_n, c0, cn;
};

__device__ __forceinline__ Place place(const Params& p) {
  Place c;
  c.n = blockIdx.z;
  c.ty = blockIdx.y / p.split;
  c.tx = blockIdx.x;
  c.c0 = 0;
  c.cn = p.c;
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
// and the two columns (clamped into the copied columns [xa, xb), px bytes
// per column), and
// whether each tap is inside the content (constant border; always with
// replicate).
struct Taps {
  int row[2], col[2];
  bool ok[2][2];
};

template <bool kConstant>
__device__ __forceinline__ Taps taps_at(const Sample& s, const int* row_off, int xc0, int xa,
                                        int xb, int px, const Params& p) {
  Taps q;
  bool okr[2], okc[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ro = row_off[s.wi + k];
    okr[k] = !kConstant || ro >= 0;
    q.row[k] = max(ro, 0);
    const int xq = xc0 + s.wj + k;  // content column of the tap
    okc[k] = !kConstant || (xq >= 0 && xq < p.w);
    q.col[k] = (min(max(xq, xa), xb - 1) - xa) * px;
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
  int px;              // bytes per window column: the CTA's channels
};

__device__ __forceinline__ Window window_of(unsigned char* smem, int2 o, int cn, int img_bytes,
                                            const Params& p) {
  Window wd;
  wd.px = cn * img_bytes;
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
// All C channels per CTA (channel groups: warp_grouped_kernel).
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
  const Window wd = window_of(smem, o, c.cn, static_cast<int>(sizeof(TI)), p);
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
      const Taps q = taps_at<kConstant>(s, wd.row_off, wd.xc0, wd.xa, wd.xb, wd.px, p);
      TI* dst = stage + (g * 32 + lane) * p.c;  // the warp's staging row
      for (int ch = 0; ch < c.cn; ++ch) {
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
// a time, all in flight together. All C channels per CTA (channel groups:
// warp_grouped_kernel).
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
  const int cn = p.c, ch0 = 0;  // the CTA's channels: all C
  const Window wd = window_of(smem, o, cn, static_cast<int>(sizeof(TI)), p);
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
    for (int c0 = 0; c0 < cn; c0 += kCt) {
      float cv[kGroup][kCt];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
#pragma unroll
        for (int u = 0; u < kCt; ++u) {
          const int rg = r + g * p.subrows;
          const bool ok = live && rg < c.rows_n && c0 + u < cn;
          cv[g][u] = ok ? ld(ct + (pix0 + static_cast<size_t>(rg) * p.w) * p.c + ch0 + c0 + u)
                        : 0.f;
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
        const Taps q = taps_at<kConstant>(s, wd.row_off, wd.xc0, wd.xa, wd.xb, wd.px, p);
#pragma unroll
        for (int u = 0; u < kCt; ++u) {
          if (c0 + u >= cn) break;
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

// ---- Channel groups (see the note at the top) ------------------------------

// A grouped CTA's pixels: a kBh x kBw block of its tile, one per thread
// (thread i: block row i / kBw, column i % kBw).
constexpr int kBh = 16, kBw = 16, kLgBw = 4;
static_assert(kBh * kBw == kThreads && (1 << kLgBw) == kBw, "one pixel of the block per thread");
constexpr int kLgMaxNv = 3;  // most groups per ring slot, 8: a 128-byte run per column
static_assert(kThreads % (1 << kLgMaxNv) == 0, "a thread's group is the same in all its units");
constexpr int kRingSlots = 2;  // ring slots in shared memory (2 CTAs per SM)
static_assert(kRingSlots >= 2, "the ring copies one slot while another is computed");

// A grouped CTA's place: tile (n, ty, tx), its block's first pixel (y0,
// x0), image coordinates, and its chunk: channel groups [v0, v1). grid: x
// = block of the tile * chunks + chunk, y = ty * tx_n + tx.
struct GPlace {
  int n, ty, tx, y0, x0, chunk, v0, v1;
};

__device__ __forceinline__ GPlace gplace(const Params& p, const GroupPlan& gp) {
  GPlace c;
  c.n = blockIdx.z;
  c.ty = blockIdx.y / p.tx_n;
  c.tx = blockIdx.y - c.ty * p.tx_n;
  const int blk = blockIdx.x / gp.chunks;
  c.chunk = blockIdx.x - blk * gp.chunks;
  const int by = blk / gp.bx_n;
  c.y0 = c.ty * kTh + by * kBh;
  c.x0 = c.tx * kTw + (blk - by * gp.bx_n) * kBw;
  c.v0 = c.chunk * gp.chunk_vec;
  c.v1 = min(p.groups, c.v0 + gp.chunk_vec);
  return c;
}

// The ring's geometry, the same for all threads of the CTA: the footprint
// box (content rows ya.., columns xa.., rows x cols); nv = 2^lg groups per
// slot; a box row's bytes; where K2's cotangent starts in a slot. A slot
// holds box row r, column c, group j at r * rowpitch + c * nv * 16 +
// swz(j, c), and the cotangent of pixel i, group j at ct_off + i * nv * 16
// + swz(j, i): each column's (pixel's) nv groups are one run, the groups
// swizzled so that lanes reading one group of consecutive columns hit
// distinct banks.
struct Ring {
  int ya, xa, rows, cols, nv, lg, sh, rowpitch, ct_off;
  __device__ __forceinline__ int key(int c) const { return (c >> sh) & (nv - 1); }
  __device__ __forceinline__ int swz(int j, int c) const { return (j ^ key(c)) * 16; }
};

// One pixel of a grouped CTA (the thread's own), from the prologue: where
// its 2x2 taps' column runs start in a slot (off[2a + b]: row a, column
// b), the swizzle keys of its two columns, which taps lie inside the
// content (constant border: bit 2a + b), its weights and K2's masks.
struct GPix {
  int off[4], key0, key1;
  unsigned ok;
  bool live;
  float wy0, wy1, wx0, wx1, my, mx;
};

// K1's table of its block's pixels in shared memory (the items of a slot
// are spread over the threads by group, not by pixel): tap offsets,
// weights and key = key0 | key1 << 3 | ok << 6 | live << 10.
struct GTable {
  int4 off[kThreads];
  float4 wt[kThreads];
  int key[kThreads];
};
constexpr int kLive = 1 << 10;

// A 16-byte group's element e as the window dtype holds it (as win_val).
template <typename TI, bool kBf16>
__device__ __forceinline__ float vec_val(const uint4& q, int e) {
  if constexpr (sizeof(TI) == 4) {
    const float v = __uint_as_float((&q.x)[e]);
    return kBf16 ? bf16_round(v) : v;
  } else {
    const unsigned u = (&q.x)[e >> 1];
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>((e & 1) ? (u >> 16) : (u & 0xffffu))));
  }
}

// Sets element e of a 16-byte group to v, rounded to TI (as st).
template <typename TI>
__device__ __forceinline__ void vec_set(uint4& q, int e, float v) {
  if constexpr (sizeof(TI) == 4) {
    (&q.x)[e] = __float_as_uint(v);
  } else {
    const unsigned b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    unsigned& u = (&q.x)[e >> 1];
    u = (e & 1) ? ((u & 0xffffu) | (b << 16)) : ((u & 0xffff0000u) | b);
  }
}

// Copies the first n (< 16 / sizeof(TI) where ragged) elements of a group
// element by element into the 16 bytes at dst, zero past them.
template <typename TI>
__device__ __forceinline__ void copy_elems(unsigned char* dst, const TI* src, int n) {
  constexpr int kVe = 16 / static_cast<int>(sizeof(TI));
  using U = typename std::conditional<sizeof(TI) == 4, unsigned, unsigned short>::type;
  const U* s = reinterpret_cast<const U*>(src);
  U* d = reinterpret_cast<U*>(dst);
#pragma unroll
  for (int e = 0; e < kVe; ++e) d[e] = e < n ? __ldg(s + e) : U(0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most kN of this thread's commit groups are in flight.
template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

// The prologue, one pixel per thread: its sample and taps (content rows and
// columns first), the CTA's footprint box (one barrier), the ring's
// geometry (as many groups per slot as fit, a power of two; one always
// fits: the plan sizes a slot for the worst box), and the pixel's tap
// offsets and swizzle keys.
template <typename TF, bool kBf16, bool kConstant, bool kGrad>
__device__ __forceinline__ Ring grouped_prologue(const TF* __restrict__ flow, float tn, int2 o,
                                                 const Params& p, int stage_bytes,
                                                 const GPlace& c, int4* box, GPix& q) {
  const int y = c.y0 + (threadIdx.x >> kLgBw), x = c.x0 + (threadIdx.x & (kBw - 1));
  q.live = y < p.h && x < p.w;
  int4 b = make_int4(0x7fffffff, -1, 0x7fffffff, -1);  // row min, row max, col min, col max
  int yc[2] = {0, 0}, xc[2] = {0, 0};
  if (q.live) {
    const TF* f = flow + ((static_cast<size_t>(c.n) * p.h + y) * p.w + x) * 2;
    const Sample s = sample_at<kBf16>(ld(f), ld(f + 1), tn, o, p, y, x, y - c.ty * kTh,
                                      x - c.tx * kTw, 0);
    q.wy0 = s.wy0, q.wy1 = s.wy1, q.wx0 = s.wx0, q.wx1 = s.wx1;
    if constexpr (kGrad) {
      q.my = (s.sy_raw >= p.ylo && s.sy_raw < p.yhi && s.ry_raw >= 0.f &&
              s.ry_raw < p.ry_max) ? 1.f : 0.f;
      q.mx = (s.sx_raw >= p.xlo && s.sx_raw < p.xhi && s.rx_raw >= 0.f &&
              s.rx_raw < p.rx_max) ? 1.f : 0.f;
    }
    // the taps' content rows and columns (window row s.wi holds canvas row
    // o.y + s.wi), clamped into the content; outside it a constant
    // border's tap reads zero
    unsigned okr = 0, okc = 0;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int yr = o.y + s.wi + a - p.pt, xr = o.x - p.pl + s.wj + a;
      okr |= (yr >= 0 && yr < p.h) << a;
      okc |= (xr >= 0 && xr < p.w) << a;
      yc[a] = min(max(yr, 0), p.h - 1);
      xc[a] = min(max(xr, 0), p.w - 1);
    }
    q.ok = kConstant ? ((okr & 1) * okc) | ((okr >> 1) * okc << 2) : 0xfu;
    b = make_int4(yc[0], yc[1], xc[0], xc[1]);
  }
  const unsigned all = 0xffffffffu;
  b.x = __reduce_min_sync(all, b.x), b.y = __reduce_max_sync(all, b.y);
  b.z = __reduce_min_sync(all, b.z), b.w = __reduce_max_sync(all, b.w);
  if ((threadIdx.x & 31) == 0) box[threadIdx.x >> 5] = b;
  __syncthreads();
  b = box[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    const int4 v = box[k];
    b.x = min(b.x, v.x), b.y = max(b.y, v.y), b.z = min(b.z, v.z), b.w = max(b.w, v.w);
  }
  Ring g;
  g.ya = b.x, g.xa = b.z, g.rows = b.y - b.x + 1, g.cols = b.w - b.z + 1;
  const int per_group = (g.rows * g.cols + (kGrad ? kThreads : 0)) * 16;
  g.lg = 0;
  while (g.lg < kLgMaxNv && (2 << g.lg) * per_group <= stage_bytes) ++g.lg;
  g.nv = 1 << g.lg;
  g.sh = kLgMaxNv - g.lg;  // columns per 128-byte line: 8 / nv
  g.rowpitch = g.cols * g.nv * 16;
  g.ct_off = g.rows * g.rowpitch;
  if (q.live) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        q.off[2 * a + e] = (yc[a] - g.ya) * g.rowpitch + (xc[e] - g.xa) * g.nv * 16;
    q.key0 = g.key(xc[0] - g.xa);
    q.key1 = g.key(xc[1] - g.xa);
  }
  return g;
}

// Starts the copies of groups [vb, vb + nvl) (nvl <= nv) into a ring slot
// and commits them: the footprint box, units (row, column, group) with
// the group fastest, so that a column's groups are one contiguous run of
// img; K2 also the block's cotangent, units (pixel, group). A thread's
// group is the same in every unit (kThreads is a multiple of nv): j.
template <typename TI, bool kGrad>
__device__ __forceinline__ void start_copies(const TI* __restrict__ img_n,
                                             const TI* __restrict__ ct, unsigned char* slot,
                                             const Ring& g, int vb, int nvl, const GPlace& c,
                                             const Params& p) {
  constexpr int kVe = 16 / static_cast<int>(sizeof(TI));
  const int j = threadIdx.x & (g.nv - 1);
  if (j < nvl) {
    const int n_el = min(kVe, p.c - (vb + j) * kVe);  // element copies: a ragged last group
    // this thread's first (row, column) and its step of kThreads / nv units
    const int rc = threadIdx.x >> g.lg, drc = kThreads >> g.lg;
    int r = rc / g.cols, cc = rc - r * g.cols;
    const int dr = drc / g.cols, dc = drc - dr * g.cols;
    while (r < g.rows) {
      const TI* src =
          img_n + (static_cast<size_t>(g.ya + r) * p.w + g.xa + cc) * p.c + (vb + j) * kVe;
      unsigned char* dst = slot + r * g.rowpitch + cc * g.nv * 16 + g.swz(j, cc);
      if (p.vec16)
        cp_async16(dst, src);
      else
        copy_elems<TI>(dst, src, n_el);
      cc += dc, r += dr;
      if (cc >= g.cols) cc -= g.cols, ++r;
    }
    if constexpr (kGrad) {
      for (int i = threadIdx.x >> g.lg; i < kThreads; i += drc) {
        const int y = c.y0 + (i >> kLgBw), x = c.x0 + (i & (kBw - 1));
        if (y >= p.h || x >= p.w) continue;
        const TI* src =
            ct + ((static_cast<size_t>(c.n) * p.h + y) * p.w + x) * p.c + (vb + j) * kVe;
        unsigned char* dst = slot + g.ct_off + i * g.nv * 16 + g.swz(j, i);
        if (p.vec16)
          cp_async16(dst, src);
        else
          copy_elems<TI>(dst, src, n_el);
      }
    }
  }
  cp_async_commit();
}

// K1 and K2 in channel groups (kGrad: K2). K1 writes out: a slot's items
// (pixel, group) go to the threads group fastest, so that a warp writes
// each pixel's groups as one run (its pixels' taps and weights from the
// table). K2 keeps a pixel per thread and sums its channels in channel
// order, across the slots, then writes cg and grad_flow, or with several
// chunks per tile its chunk's partial sums to cg = the scratch [chunks, n,
// h, w, 2] for grad_chunks_sum_kernel. The per-channel arithmetic is
// warp_windowed_kernel's and warp_windowed_grad_kernel's.
template <typename TI, typename TF, bool kBf16, bool kConstant, bool kGrad>
__global__ void __launch_bounds__(kThreads, 2)
    warp_grouped_kernel(const TI* __restrict__ img, const TF* __restrict__ flow,
                        const float* __restrict__ t, const TI* __restrict__ ct,
                        TI* __restrict__ out, TF* __restrict__ grad_flow, float* __restrict__ cg,
                        Params p, GroupPlan gp) {
  constexpr int kVe = 16 / static_cast<int>(sizeof(TI));
  constexpr int kTable = kGrad ? 0 : static_cast<int>(sizeof(GTable));
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 part[kWarps];
  __shared__ int4 box[kWarps];
  const GPlace c = gplace(p, gp);
  if (c.y0 >= p.h || c.x0 >= p.w) return;  // a block past a short tile: the whole CTA
  const float tn = batch_t(t, p, c.n);
  const int2 o = tile_origin<TF, kBf16>(flow, tn, p, c.n, c.ty, c.tx, part);
  GPix q;
  const Ring g = grouped_prologue<TF, kBf16, kConstant, kGrad>(flow, tn, o, p, gp.stage_bytes,
                                                                 c, box, q);
  GTable* table = reinterpret_cast<GTable*>(smem);
  if constexpr (!kGrad) {
    const int i = threadIdx.x;
    table->off[i] = make_int4(q.off[0], q.off[1], q.off[2], q.off[3]);
    table->wt[i] = make_float4(q.wy0, q.wy1, q.wx0, q.wx1);
    table->key[i] = q.live ? q.key0 | q.key1 << 3 | q.ok << 6 | kLive : 0;
  }
  unsigned char* ring = smem + kTable;
  const TI* img_n = img + static_cast<size_t>(c.n) * p.h * p.w * p.c;
  float2 acc = make_float2(0.f, 0.f);
  const int slots = (c.v1 - c.v0 + g.nv - 1) / g.nv;  // ring slots this CTA fills
  auto fill = [&](int s) {
    if (s < slots) {
      const int vb = c.v0 + s * g.nv;
      start_copies<TI, kGrad>(img_n, ct, ring + (s % kRingSlots) * gp.stage_bytes, g, vb,
                              min(g.nv, c.v1 - vb), c, p);
    } else {
      cp_async_commit();  // an empty group keeps the wait counts uniform
    }
  };
  for (int s = 0; s + 1 < kRingSlots; ++s) fill(s);
  for (int s = 0; s < slots; ++s) {
    cp_async_wait<kRingSlots - 2>();  // slot s's copies (this thread's) have landed
    __syncthreads();                  // everyone's have; everyone is done with slot s - 1
    fill(s + kRingSlots - 1);         // into slot s - 1's place
    const unsigned char* slot = ring + (s % kRingSlots) * gp.stage_bytes;
    const int vb = c.v0 + s * g.nv, nvl = min(g.nv, c.v1 - vb);
    if constexpr (!kGrad) {
      const int j = threadIdx.x & (g.nv - 1);
      if (j >= nvl) continue;
      const int ch0 = (vb + j) * kVe, n_ch = min(kVe, p.c - ch0);
      for (int i = threadIdx.x >> g.lg; i < kThreads; i += kThreads >> g.lg) {
        const int key = table->key[i];
        if (!(key & kLive)) continue;
        const int4 off = table->off[i];
        const float4 wt = table->wt[i];  // wy0, wy1, wx0, wx1
        const int s0 = (j ^ (key & 7)) * 16, s1 = (j ^ ((key >> 3) & 7)) * 16;
        uint4 tap[4] = {*reinterpret_cast<const uint4*>(slot + off.x + s0),
                        *reinterpret_cast<const uint4*>(slot + off.y + s1),
                        *reinterpret_cast<const uint4*>(slot + off.z + s0),
                        *reinterpret_cast<const uint4*>(slot + off.w + s1)};
        if constexpr (kConstant) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (!((key >> (6 + u)) & 1)) tap[u] = make_uint4(0u, 0u, 0u, 0u);
        }
        uint4 res = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int e = 0; e < kVe; ++e) {
          const float v00 = vec_val<TI, kBf16>(tap[0], e), v01 = vec_val<TI, kBf16>(tap[1], e);
          const float v10 = vec_val<TI, kBf16>(tap[2], e), v11 = vec_val<TI, kBf16>(tap[3], e);
          const float in0 = row_sum<kBf16>(wt.z, v00, wt.w, v01);
          const float in1 = row_sum<kBf16>(wt.z, v10, wt.w, v11);
          vec_set<TI>(res, e, __fadd_rn(__fmul_rn(wt.x, in0), __fmul_rn(wt.y, in1)));
        }
        TI* dst = out + ((static_cast<size_t>(c.n) * p.h + c.y0 + (i >> kLgBw)) * p.w + c.x0 +
                         (i & (kBw - 1))) * p.c + ch0;
        if (p.vec16) {
          *reinterpret_cast<uint4*>(dst) = res;
        } else {
#pragma unroll
          for (int e = 0; e < kVe; ++e)
            if (e < n_ch) st(dst + e, vec_val<TI, false>(res, e));
        }
      }
    } else {
      if (!q.live) continue;
      const int i = threadIdx.x;
      for (int j = 0; j < nvl; ++j) {
        const int ch0 = (vb + j) * kVe, n_ch = min(kVe, p.c - ch0);
        const int s0 = (j ^ q.key0) * 16, s1 = (j ^ q.key1) * 16;
        uint4 tap[4] = {*reinterpret_cast<const uint4*>(slot + q.off[0] + s0),
                        *reinterpret_cast<const uint4*>(slot + q.off[1] + s1),
                        *reinterpret_cast<const uint4*>(slot + q.off[2] + s0),
                        *reinterpret_cast<const uint4*>(slot + q.off[3] + s1)};
        if constexpr (kConstant) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (!((q.ok >> u) & 1)) tap[u] = make_uint4(0u, 0u, 0u, 0u);
        }
        const uint4 cv =
            *reinterpret_cast<const uint4*>(slot + g.ct_off + i * g.nv * 16 + g.swz(j, i));
#pragma unroll
        for (int e = 0; e < kVe; ++e) {
          if (e >= n_ch) break;
          const float v00 = vec_val<TI, kBf16>(tap[0], e), v01 = vec_val<TI, kBf16>(tap[1], e);
          const float v10 = vec_val<TI, kBf16>(tap[2], e), v11 = vec_val<TI, kBf16>(tap[3], e);
          // d out/d sy: vertical dhat over the interp rows
          const float in0 = row_sum<kBf16>(q.wx0, v00, q.wx1, v01);
          const float in1 = row_sum<kBf16>(q.wx0, v10, q.wx1, v11);
          float gy = __fadd_rn(__fmul_rn(-q.my, in0), __fmul_rn(q.my, in1));
          // d out/d sx: horizontal dhat (exact in bf16), vertical hat
          const float dx0 = row_sum<kBf16>(-q.mx, v00, q.mx, v01);
          const float dx1 = row_sum<kBf16>(-q.mx, v10, q.mx, v11);
          float gx = __fadd_rn(__fmul_rn(q.wy0, dx0), __fmul_rn(q.wy1, dx1));
          gy = as_stored<TI>(gy);
          gx = as_stored<TI>(gx);
          const float cvf = vec_val<TI, false>(cv, e);
          acc.y = __fadd_rn(acc.y, __fmul_rn(cvf, gy));
          acc.x = __fadd_rn(acc.x, __fmul_rn(cvf, gx));
        }
      }
    }
  }
  if constexpr (kGrad) {
    if (!q.live) return;
    const size_t pix = (static_cast<size_t>(c.n) * p.h + c.y0 + (threadIdx.x >> kLgBw)) * p.w +
                       c.x0 + (threadIdx.x & (kBw - 1));
    if (gp.chunks == 1) {
      reinterpret_cast<float2*>(cg)[pix] = acc;
      st_pair(grad_flow + pix * 2, __fmul_rn(acc.x, tn), __fmul_rn(acc.y, tn));
    } else {
      const size_t npix = static_cast<size_t>(p.n) * p.h * p.w;
      reinterpret_cast<float2*>(cg)[static_cast<size_t>(c.chunk) * npix + pix] = acc;
    }
  }
}

// Grouped K2 with several chunks per tile, second pass: one thread per
// pixel adds the chunks' partial sums part[chunks, n, h, w] in chunk order,
// then writes cg and grad_flow = cg * t.
template <typename TF>
__global__ void __launch_bounds__(kThreads)
    grad_chunks_sum_kernel(const float2* __restrict__ part, const float* __restrict__ t,
                           TF* __restrict__ grad_flow, float2* __restrict__ cg, Params p,
                           int chunks) {
  const size_t hw = static_cast<size_t>(p.h) * p.w, npix = hw * p.n;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= npix) return;
  float2 s = part[i];
  for (int g = 1; g < chunks; ++g) {
    const float2 v = part[g * npix + i];
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
  }
  cg[i] = s;
  const float tn = batch_t(t, p, static_cast<int>(i / hw));
  st_pair(grad_flow + i * 2, __fmul_rn(s.x, tn), __fmul_rn(s.y, tn));
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

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The channel-group plan (warp_grouped_kernel) of a launch whose window of
// all C channels does not fit (see plan): kBh x kBw pixel blocks of each
// tile, a ring of kRingSlots slots (two CTAs per SM, else one) each sized
// for one group of the worst footprint box (the block plus nsh - 1 halo
// rows and columns; K2 also the block's cotangent), K1's pixel table, and
// the fewest chunks of groups per tile that give every SM a CTA (K2 with
// more than one chunk adds a second pass).
cudaError_t plan_grouped(Params& p, GroupPlan& gp, int nsh_y, int nsh_x, size_t img_bytes,
                         bool grad, int sms, size_t* smem) {
  p.groups = static_cast<int>((p.c * img_bytes + 15) / 16);
  p.cg = static_cast<int>(16 / img_bytes);
  const int th_full = min(kTh, p.h), wt_full = min(kTw, p.w);
  const int th_last = p.h - (p.ty_n - 1) * kTh, wt_last = p.w - (p.tx_n - 1) * kTw;
  const int by_n = (th_full + kBh - 1) / kBh;
  gp.bx_n = (wt_full + kBw - 1) / kBw;
  // blocks with pixels, over all tiles (the last tile row and column are short)
  const long long rows_full = by_n, rows_last = cdiv(th_last, kBh);
  const long long cols_full = gp.bx_n, cols_last = cdiv(wt_last, kBw);
  const long long live = p.n * ((p.ty_n - 1) * rows_full + rows_last) *
                         ((p.tx_n - 1) * cols_full + cols_last);
  const size_t need = static_cast<size_t>(std::min(kBh + nsh_y - 1, p.h)) *
                          std::min(kBw + nsh_x - 1, p.w) * 16 +
                      (grad ? kThreads * 16 : 0);
  const size_t table = grad ? 0 : sizeof(GTable);
  for (const size_t budget : {kSmemTwo, kSmemMax}) {
    const size_t slot = (budget - table) / kRingSlots / 16 * 16;
    if (slot < need) continue;
    p.grouped = 1;
    p.split = by_n * gp.bx_n;
    p.rows = kBh;
    gp.chunk_vec =
        static_cast<int>(cdiv(p.groups, std::min<long long>(cdiv(sms, live), p.groups)));
    gp.chunks = static_cast<int>(cdiv(p.groups, gp.chunk_vec));
    gp.stage_bytes = static_cast<int>(slot);
    p.vec16 = (p.c * img_bytes) % 16 == 0;
    if (static_cast<long long>(p.ty_n) * p.tx_n > 65535 ||
        static_cast<long long>(p.split) * gp.chunks > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    *smem = table + kRingSlots * slot;
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

// Tiles, row slices and shared memory of a launch. split: row slices per
// tile (1, 2, 4 or 8), the fewest that give two CTAs per SM (so a small
// image still spreads over the card) and a window that leaves room for two
// CTAs per SM, else for one. K1 (staging) also holds its output staging
// buffers. A window of all C channels that fits neither at 4 rows per CTA
// takes channel groups (K1 and K2). Returns the dynamic shared memory in
// *smem, or cudaErrorInvalidValue for a launch the kernels do not take.
cudaError_t plan(Params& p, GroupPlan& gp, int nsh_y, int nsh_x, size_t img_bytes, bool staging,
                 int* dev, size_t* smem) {
  if (p.n <= 0 || p.h <= 0 || p.w <= 0 || p.c <= 0 || nsh_y < 2 || nsh_x < 2)
    return cudaErrorInvalidValue;
  p.ty_n = (p.h + kTh - 1) / kTh;
  p.tx_n = (p.w + kTw - 1) / kTw;
  int sms = 0;
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err != cudaSuccess) return err;
  if (p.n > 65535) return cudaErrorInvalidValue;
  const long long tiles = static_cast<long long>(p.n) * p.ty_n * p.tx_n;
  int split = 1;
  while (split < kMaxSplit && tiles * split < 2LL * sms) split *= 2;
  p.lanes = min(kTw, (p.w + 31) / 32 * 32);
  p.subrows = kThreads / p.lanes;
  p.ww = kTw + nsh_x - 1;
  p.grouped = 0, p.groups = 1, p.cg = p.c, p.vec16 = 0;
  gp = GroupPlan{0, 1, 1, 0};
  p.pitch = static_cast<int>(round16(p.ww * p.c * img_bytes) + 32);  // + alignment slack
  const size_t stage = staging ? static_cast<size_t>(kWarps) * kGroup * 32 * p.c * img_bytes : 0;
  for (const size_t budget : {kSmemTwo, kSmemMax}) {
    for (int s = split; s <= kMaxSplit; s *= 2) {
      const int wh = kTh / s + nsh_y - 1;
      const size_t win_offset = round16(sizeof(int) * wh);
      const size_t bytes = win_offset + static_cast<size_t>(wh) * p.pitch + stage;
      if (bytes <= budget) {
        p.split = s;
        p.rows = kTh / s;
        p.wh = wh;
        p.win_offset = static_cast<int>(win_offset);
        p.stage_offset = static_cast<int>(bytes - stage);
        if (static_cast<long long>(p.ty_n) * s > 65535) return cudaErrorInvalidValue;
        *smem = bytes;
        return cudaSuccess;
      }
    }
  }
  return plan_grouped(p, gp, nsh_y, nsh_x, img_bytes, !staging, sms, smem);
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

// Launches `kernel` with up to kSmemMax of dynamic shared memory on device
// dev (done: the kernel's own flags).
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel* kernel, bool* done, dim3 grid, size_t smem, int dev,
                             cudaStream_t stream, Args... args) {
  const cudaError_t err = set_smem(kernel, dev, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename TI, typename TF>
struct Interp {
  template <bool kBf16, bool kConstant>
  static cudaError_t run(dim3 grid, size_t smem, int dev, cudaStream_t stream, const Params& p,
                         const GroupPlan& gp, const void* img, const void* flow, const float* t,
                         void* out) {
    const TI* im = static_cast<const TI*>(img);
    const TF* fl = static_cast<const TF*>(flow);
    if (p.grouped) {
      static bool done[kMaxDevices] = {};
      return launch_with_smem(warp_grouped_kernel<TI, TF, kBf16, kConstant, false>, done, grid,
                              smem, dev, stream, im, fl, t, static_cast<const TI*>(nullptr),
                              static_cast<TI*>(out), static_cast<TF*>(nullptr),
                              static_cast<float*>(nullptr), p, gp);
    }
    static bool done[kMaxDevices] = {};
    return launch_with_smem(warp_windowed_kernel<TI, TF, kBf16, kConstant>, done, grid, smem,
                            dev, stream, im, fl, t, static_cast<TI*>(out), p);
  }
};

template <typename TI, typename TF>
struct Grad {
  // part: the chunks' scratch [chunks, n, h, w, 2] f32 of a grouped launch
  // with several chunks per tile
  template <bool kBf16, bool kConstant>
  static cudaError_t run(dim3 grid, size_t smem, int dev, cudaStream_t stream, const Params& p,
                         const GroupPlan& gp, const void* img, const void* flow, const float* t,
                         const void* ct, void* grad_flow, float* cg, float* part) {
    const TI* im = static_cast<const TI*>(img);
    const TF* fl = static_cast<const TF*>(flow);
    const TI* c = static_cast<const TI*>(ct);
    TF* gf = static_cast<TF*>(grad_flow);
    if (!p.grouped) {
      static bool done[kMaxDevices] = {};
      return launch_with_smem(warp_windowed_grad_kernel<TI, TF, kBf16, kConstant>, done, grid,
                              smem, dev, stream, im, fl, t, c, gf, cg, p);
    }
    static bool done[kMaxDevices] = {};
    const cudaError_t err = launch_with_smem(
        warp_grouped_kernel<TI, TF, kBf16, kConstant, true>, done, grid, smem, dev, stream, im,
        fl, t, c, static_cast<TI*>(nullptr), gf, gp.chunks > 1 ? part : cg, p, gp);
    if (err != cudaSuccess || gp.chunks == 1) return err;
    const size_t npix = static_cast<size_t>(p.n) * p.h * p.w;
    grad_chunks_sum_kernel<TF><<<static_cast<unsigned>((npix + kThreads - 1) / kThreads),
                                 kThreads, 0, stream>>>(
        reinterpret_cast<const float2*>(part), t, gf, reinterpret_cast<float2*>(cg), p,
        gp.chunks);
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

// The grid of a planned launch: whole C, x = tiles across and y = tile
// rows x row slices; channel groups, x = pixel blocks x chunks and y = the
// tiles of an image.
dim3 grid_of(const Params& p, const GroupPlan& gp) {
  return p.grouped ? dim3(p.split * gp.chunks, p.ty_n * p.tx_n, p.n)
                   : dim3(p.tx_n, p.ty_n * p.split, p.n);
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
  GroupPlan gp;
  size_t smem = 0;
  int dev = 0;
  cudaError_t err = plan(p, gp, nsh_y, nsh_x, img_bf16 ? 2 : 4, true, &dev, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte group copies and stores need 16-byte aligned tensors (a view
  // may not be)
  if ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) % 16) p.vec16 = 0;
  return static_cast<int>(launch_typed<Interp>(
      img_bf16, flow_bf16, grid_of(p, gp), smem, dev, bf16_window, constant,
      static_cast<cudaStream_t>(stream), p, gp, img, flow, static_cast<const float*>(t), out));
}

// K2. The arguments of warp_windowed_launch, plus ct: [n, h, w, c] in img's
// type (the cotangent of out); grad_flow: [n, h, w, 2] in flow's type; cg:
// [n, h, w, 2] f32, (d loss/d sx, d loss/d sy); both written as pairs, so
// aligned to a pair; part: f32 scratch of [chunks, n, h, w, 2] for a launch
// whose plan takes channel groups in several chunks per tile
// (warp_windowed_plan), else unused (may be null). Returns the cudaError_t.
extern "C" int warp_windowed_grad_launch(
    const void* img, const void* flow, const void* t, float t_scalar, int t_stride,
    const void* ct, void* grad_flow, void* cg, void* part, int n, int h, int w, int c,
    int img_bf16, int flow_bf16, int bf16_window, int constant, int ry, int rx, int pt, int pl,
    int nsh_y, int nsh_x, float ylo, float yhi, float xlo, float xhi, float ry_max, float rx_max,
    void* stream) {
  if (reinterpret_cast<uintptr_t>(cg) % 8 || reinterpret_cast<uintptr_t>(part) % 8 ||
      reinterpret_cast<uintptr_t>(grad_flow) % (flow_bf16 ? 4 : 8))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Params p = make_params(n, h, w, c, t_scalar, t_stride, ry, rx, pt, pl, ylo, yhi, xlo, xhi,
                         ry_max, rx_max);
  GroupPlan gp;
  size_t smem = 0;
  int dev = 0;
  cudaError_t err = plan(p, gp, nsh_y, nsh_x, img_bf16 ? 2 : 4, false, &dev, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.grouped && gp.chunks > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte group copies need 16-byte aligned tensors (a view may not be)
  if ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(ct)) % 16) p.vec16 = 0;
  return static_cast<int>(launch_typed<Grad>(
      img_bf16, flow_bf16, grid_of(p, gp), smem, dev, bf16_window, constant,
      static_cast<cudaStream_t>(stream), p, gp, img, flow, static_cast<const float*>(t), ct,
      grad_flow, static_cast<float*>(cg), static_cast<float*>(part)));
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

// The plan of a K1 (grad = 0) or K2 (grad = 1) launch on the current
// device, for the wrappers and the checks: out[0..9] = split (row slices,
// or with channel groups pixel blocks, per tile), rows per CTA (grouped: a
// block's rows), grouped (0: the whole-C layout), channel groups
// per pixel, channels per group, dynamic shared memory bytes, CTAs,
// chunks of groups per tile, pixels per CTA, ring slots. Whole C: one
// group of c channels, one chunk, one slot. Returns the cudaError_t of
// the plan (cudaErrorInvalidValue: the launch would be refused).
extern "C" int warp_windowed_plan(int n, int h, int w, int c, int img_bf16, int nsh_y, int nsh_x,
                                  int grad, long long* out) {
  Params p = make_params(n, h, w, c, 0.f, 0, 0, 0, 0, 0, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
  GroupPlan gp;
  size_t smem = 0;
  int dev = 0;
  const cudaError_t err = plan(p, gp, nsh_y, nsh_x, img_bf16 ? 2 : 4, !grad, &dev, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid = grid_of(p, gp);
  const long long v[10] = {p.split, p.rows, p.grouped, p.groups, p.cg,
                           static_cast<long long>(smem),
                           static_cast<long long>(grid.x) * grid.y * grid.z, gp.chunks,
                           p.grouped ? kThreads : static_cast<long long>(p.rows) * min(w, kTw),
                           p.grouped ? kRingSlots : 1};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}
