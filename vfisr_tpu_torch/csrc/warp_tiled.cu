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
// hang on. Here (th, tw) are run-time arguments, so one build serves every
// tile.
//
// The function, as ops/cuda/warp.py::warp_windowed_plain computes it for
// `tile`: out[p] = bilinear sample of img at p + t*flow[p], the sample
// position clipped to the content (replicate border) or to r px past it
// over zeros (constant border), its offset inside the tile's window clamped
// to [0, nsh-1.001]; K2 gives cg = (d loss/d sx, d loss/d sy), the channel
// sums of the cotangent times the per-channel derivatives, and grad_flow =
// cg * t.
//
// What bounds it on the H100: bytes. Per pixel K1 does ~26 flops for the
// coordinates and weights and ~9 per channel against C*2..4 bytes of img
// read, as many of out written and 4..8 of flow read (K2 reads ct and
// writes 8 + 4..8 bytes): a few flops per byte, far below the card's ~20
// flop/byte f32 balance. The bound is those bytes once over 3.35 TB/s. The
// design, after warp_windowed.cu's with (th, tw) at run time:
// - The footprint, not the window. A CTA of 256 threads owns a band of W
//   <= 256 columns of one tile and a segment of its rows, which it walks in
//   slabs of R rows. Because the residual clamp keeps floor(ry) in
//   [0, nsh_y - 2], a slab's taps lie in window rows [r0, r0 + R + nsh_y -
//   1) and band columns [c0, c0 + W + nsh_x - 1) whatever the flow: the CTA
//   copies exactly that from device memory into shared memory, as image
//   rows in 16-byte cp.async runs (no registers), and reads every tap from
//   there. The copy is a ring of image rows: while a slab is computed, the
//   next slab's R new rows are in flight, and the nsh_y - 1 halo rows two
//   slabs share are copied once. So a segment's image bytes are read
//   (rows + nsh_y - 1)(W + nsh_x - 1)/(rows * W) times whatever the tile:
//   the window amplification the reference's tile sweep is about.
// - Any C. Where the ring of all C channels does not fit beside kMinCtas
//   CTAs per SM, a CTA takes a narrower block (32 columns, up to 16 rows)
//   and walks channel chunks of 16-byte groups through a ring of two slots:
//   the next chunk's footprint in flight while one is computed. A pixel's
//   groups are padded to an odd number of 16 bytes, so lanes reading one
//   group of consecutive pixels hit distinct banks. K2 keeps each pixel's
//   channel sum in channel order in one thread across the chunks, so two
//   launches give the same bits.
// - The origins, bit for bit as window_origins: the tile's flow, edge-padded
//   to tile multiples, reduced by 2x2 halvings ((a00 + a01) + a10) + a11,
//   times 0.25, down to g x g cells (g the largest power of two dividing th
//   and tw), then the cells added in row-major order, scaled by
//   g*g/(th*tw) and t, rounded half-even, offset, clamped, and a bf16
//   window's row taken even. A warp reduces a step of whole cells (g = 8:
//   four cells of 8 lanes; g >= 16: one of 32; smaller cells 32/(g*g)),
//   each lane loading a Morton-consecutive block of 8-byte flow pixels and
//   halving it in registers, the upper levels by shuffles; each warp loads
//   kCellBatch steps at once. The row-major sum is a chain of dependent adds
//   by definition of its order: two threads (x and y) run it, from shared
//   memory. Where one CTA holds a whole tile of at most kFuseCells cells
//   (the plan's `fused`: 16x256, 8x128), it computes the origin in its
//   prologue (tile_origin): no second launch, no scratch, and the flow it
//   reads there its pixels read again from L2. Elsewhere the plan cuts each
//   tile into several CTAs (bands of columns, segments of rows), and an
//   origins pass runs first, on the same device functions: one kernel
//   reduces every cell of every tile in parallel into a scratch (all
//   threads busy, the flow read in whole pixels), a second stages each
//   tile's cells in shared memory and sums them into the origin table. A
//   fused prologue of more cells costs its CTA that many dependent load
//   rounds before its first copy, which the pass, bound by the flow's
//   bytes, does not. kernel_origins runs tile_origin (one CTA per tile) at
//   tiles of at most kFuseCells cells and the pass at larger ones, so the
//   checks that hold it against window_origins see both.
// - Index arithmetic per CTA: n, tile, band and segment come from blockIdx,
//   a thread's column and first row from threadIdx once; no thread divides
//   by a run-time value per pixel.
// - Stores. K1 stages each warp's 32 output pixels in shared memory and
//   writes them as one run (16-byte stores where aligned). K2 copies the
//   slab's cotangent into the ring beside the image (contiguous runs), and
//   writes cg and grad_flow as pairs.
// The per-pixel arithmetic (fmaf for p + t*flow, _rn intrinsics so that
// nvcc contracts nothing, the bf16 rounding steps) is the twin's, so K1
// gives its bits; a bf16 window's horizontal sums run as packed bf16 pairs
// of channels (interp_pair), which round where the twin rounds.
//
// Plain C interface, no PyTorch headers: built by nvcc into its own shared
// library and loaded with ctypes (ops/cuda/warp.py::build_tiled). Each entry
// returns a cudaError_t: of the launch, or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 256;        // band columns: one thread per column of a slab row
constexpr int kMaxR = 32;         // slab rows
constexpr int kChunkW = 32;       // channel chunks: band columns
constexpr int kChunkR = 16;       // channel chunks: slab rows (<= kMaxItems per thread)
constexpr int kMaxItems = 2;      // channel chunks: a thread's pixels in a slab (K2 sums)
constexpr int kMaxChunkVec = 8;   // channel chunks: 16-byte groups per chunk
constexpr int kMinCtas = 3;       // CTAs per SM the warp kernel's registers are capped for
constexpr int kWaveCtas = 4;      // CTAs per SM a launch should give work to
constexpr int kCellChunk = 256;   // cells of a tile per pass of tile_origin (two buffers)
constexpr int kCellBatch = 4;     // warp steps of cells a warp loads at once
constexpr int kSumChunk = 2048;   // cells of a tile the origins pass stages per pass
constexpr int kFuseCells = 64;    // a fused prologue's most cells
constexpr int kMaxLevels = 15;    // halvings of a cell: g up to 2^15
// dynamic shared memory of one CTA: kMinCtas fit in an SM's 228 KB with
// kSmemCta each, beside their static parts and the 1 KB the SM reserves
constexpr int kSmemCta = 72 * 1024;
constexpr int kSmemSm = 228 * 1024;
constexpr int kSmemStatic = 16;   // the warp kernel's static shared memory (the origin)

struct Tiled {
  int n, h, w, c;
  int th, tw;           // output tile
  int ty_n, tx_n;       // tiles per image (content rounded up to the tile)
  int g, levels;        // cell side (a power of two) and its log2
  int cy, cx;           // cells per tile: th / g, tw / g
  float cell_scale;     // g*g/(th*tw) rounded to f32; unused with one cell
  int pt, pl;           // content origin inside the canvas
  int ry, rx;           // residual radii
  int nsh_y, nsh_x;     // taps per axis of a window
  int t_stride;         // t[n * t_stride], or t_scalar where t is null
  float t_scalar;
  float ylo, yhi, xlo, xhi;  // source-coordinate clip bounds (canvas space)
  float ry_max, rx_max;      // nsh - 1.001: residual clamp
};

// How a launch is cut (ops/cuda/warp.py::tiled_plan mirrors it): per tile,
// `bands` column bands of `cols` columns and `segs` row segments of
// `seg_rows` rows, one CTA each, walked in slabs of `rows` rows; whole C or
// channel chunks of `cvec` 16-byte groups; the ring's rows and pitch; byte
// offsets of the parts of dynamic shared memory.
struct Plan {
  int rows, cols, bands, segs, seg_rows, slabs;
  int lanes, subrows;   // threads per slab row (cols rounded up to 32), rows side by side
  int chunked;          // 1: channel chunks of 16-byte groups
  int cvec, chunks;     // groups per chunk, chunks per pixel (whole C: 0, 1)
  int slots;            // units the ring holds: 2 where a CTA walks more than one
  int qrows, pitch, px;  // ring rows, bytes per ring row, bytes per pixel of a ring row
  int ct_pitch;         // K2: bytes per cotangent row of a slot
  int ring_off, ctoff_off, ct_off, stage_off;  // offsets in dynamic shared memory
  int smem, fused, vec16;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void st_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
template <typename T>
__device__ __forceinline__ float as_stored(float v) {
  return std::is_same<T, float>::value ? v : bf16_round(v);
}
// an element of img's type at a shared-memory byte address, as a float
template <typename TI>
__device__ __forceinline__ float sval(const unsigned char* a) {
  if constexpr (sizeof(TI) == 4) return *reinterpret_cast<const float*>(a);
  else return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(a));
}
// a window value: img's element, rounded to bf16 with a bf16 window
template <typename TI, bool kBf16>
__device__ __forceinline__ float win_val(const unsigned char* a) {
  const float v = sval<TI>(a);
  return (kBf16 && sizeof(TI) == 4) ? bf16_round(v) : v;
}
// element e of a 16-byte group, as img's type holds it
template <typename TI>
__device__ __forceinline__ float vec_val(const uint4& q, int e) {
  if constexpr (sizeof(TI) == 4) {
    return __uint_as_float((&q.x)[e]);
  } else {
    const unsigned u = (&q.x)[e >> 1];
    return __bfloat162float(__ushort_as_bfloat16(
        static_cast<unsigned short>((e & 1) ? (u >> 16) : (u & 0xffffu))));
  }
}

// one flow pixel (dx, dy) in one load (the entries require pair-aligned flow)
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ float batch_t(const float* __restrict__ t, const Tiled& p, int n) {
  return t ? __ldg(t + n * p.t_stride) : p.t_scalar;
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN));
}

// ---- The tile origin --------------------------------------------------------

// (((a + b) + c) + d) * 0.25: one node of the halving chain
__device__ __forceinline__ float2 quad(float2 a, float2 b, float2 c, float2 d) {
  return make_float2(__fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a.x, b.x), c.x), d.x), 0.25f),
                     __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a.y, b.y), c.y), d.y), 0.25f));
}
__device__ __forceinline__ float2 shfl_down2(float2 v, int s) {
  return make_float2(__shfl_down_sync(0xffffffffu, v.x, s), __shfl_down_sync(0xffffffffu, v.y, s));
}
// one cross-lane level: the node of lanes l, l+s, l+2s, l+3s, valid in lane l
__device__ __forceinline__ float2 level(float2 v, int s) {
  return quad(v, shfl_down2(v, s), shfl_down2(v, 2 * s), shfl_down2(v, 3 * s));
}
// the flow pixel (y, x) of one image, the content's last row and column
// repeated past it (the reference's edge padding to tile multiples)
template <typename TF>
__device__ __forceinline__ float2 flow_px(const TF* __restrict__ base, const Tiled& p, int y,
                                          int x) {
  return ld_pair(base + (static_cast<size_t>(min(y, p.h - 1)) * p.w + min(x, p.w - 1)) * 2);
}
// Morton index k -> (row, column): bit 2i is column bit i, bit 2i+1 row bit i
__device__ __forceinline__ int2 morton(int k) {
  int yy = 0, xx = 0;
#pragma unroll
  for (int b = 0; b < 15; ++b) {
    xx |= ((k >> (2 * b)) & 1) << b;
    yy |= ((k >> (2 * b + 1)) & 1) << b;
  }
  return make_int2(xx, yy);
}
// The mean of the 2^b x 2^b square at (y, x) by the halving chain: its
// 2x2 nodes in Morton order, each level's four children combined in order.
template <typename TF>
__device__ float2 square_mean(const TF* __restrict__ base, const Tiled& p, int y, int x, int b) {
  if (b == 0) return flow_px(base, p, y, x);
  float2 acc[kMaxLevels];
  float2 v = make_float2(0.f, 0.f);
  const int count = 1 << (2 * (b - 1));
  for (int k = 0; k < count; ++k) {
    const int2 m = morton(k);
    const int yy = y + 2 * m.y, xx = x + 2 * m.x;
    v = quad(flow_px(base, p, yy, xx), flow_px(base, p, yy, xx + 1), flow_px(base, p, yy + 1, xx),
             flow_px(base, p, yy + 1, xx + 1));
    for (int lvl = 0; lvl < b - 1; ++lvl) {
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
  return v;
}

// How a warp reduces cells (g x g, g the largest power of two dividing th
// and tw). A cell of g = 8 takes 8 lanes, g >= 16 all 32: lane l of a cell
// holds the 2*4^b Morton-consecutive pixels from l*2*4^b, two 2^b squares
// side by side (b = 1 at g = 8, levels - 3 beyond), reduced in the lane;
// then lane pairs, then lanes 2 apart (and 8 apart with 32 lanes) hold the
// next levels. A smaller cell (g = 1, 2, 4) takes E = g*g lanes. per_step:
// cells per warp step; slot: the lane's cell of a step.
struct CellLane {
  int b, per_step, slot;
  int2 d0;  // the lane's first pixel in its cell
  bool big, wide;  // g >= 8; g >= 16 (32 lanes per cell)
};

__device__ __forceinline__ CellLane cell_lane(const Tiled& p) {
  const int lane = threadIdx.x & 31;
  CellLane c;
  c.big = p.levels >= 3;
  c.wide = p.levels >= 4;
  if (c.big) {
    const int lg = c.wide ? 5 : 3;  // lanes per cell: 2^lg
    c.b = c.wide ? p.levels - 3 : 1;
    c.per_step = 32 >> lg, c.slot = lane >> lg;
    c.d0 = morton((lane & ((1 << lg) - 1)) << (2 * c.b + 1));
  } else {
    const int e_lg = 2 * p.levels;  // E = 2^e_lg lanes per cell
    c.b = 0, c.per_step = 32 >> e_lg, c.slot = lane >> e_lg;
    c.d0 = morton(lane & ((1 << e_lg) - 1));
  }
  return c;
}

// One warp step's loads: the lane's pixels of the cell whose top-left pixel
// is (y, x) of the image at base.
template <typename TF>
__device__ __forceinline__ void cell_loads(const TF* __restrict__ base, const Tiled& p,
                                           const CellLane& cl, int y, int x, float2& v0,
                                           float2& v1) {
  v0 = square_mean(base, p, y + cl.d0.y, x + cl.d0.x, cl.b);
  v1 = cl.big ? square_mean(base, p, y + cl.d0.y, x + cl.d0.x + (1 << cl.b), cl.b) : v0;
}

// The step's cell means from its loads, valid in the lanes where
// cell_owner is true.
__device__ __forceinline__ float2 cell_reduce(const Tiled& p, const CellLane& cl, float2 v0,
                                              float2 v1) {
  if (cl.big) {
    const float2 n0 = shfl_down2(v0, 1), n1 = shfl_down2(v1, 1);
    const float2 v = level(quad(v0, v1, n0, n1), 2);  // lane pairs, then lanes 2 apart
    return cl.wide ? level(v, 8) : v;
  }
  float2 v = v0;
  if (p.levels >= 1) v = level(v, 1);
  if (p.levels >= 2) v = level(v, 4);
  return v;
}
__device__ __forceinline__ bool cell_owner(const CellLane& cl) {
  return ((threadIdx.x & 31) & ((32 / cl.per_step) - 1)) == 0;
}

// One axis of the origin from the row-major sum of the tile's cell means:
// times g*g/(th*tw) (more than one cell), times t, rounded half-even (as
// 64-bit ints like the reference's), offset and clamped into the canvas;
// a bf16 window's row rounded down to even (the TPU's bf16 rolls drop the
// odd row slack). axis 0: ox, 1: oy.
template <bool kBf16>
__device__ __forceinline__ int finish_origin(float sum, int axis, float tn, const Tiled& p, int ty,
                                             int tx) {
  if (p.cy * p.cx > 1) sum = __fmul_rn(sum, p.cell_scale);
  sum = __fmul_rn(sum, tn);
  long long o;
  if (axis == 0) {
    o = p.pl + static_cast<long long>(tx) * p.tw + __float2ll_rn(sum) - (p.rx + 1);
    o = min(max(o, 0LL), static_cast<long long>(p.pl) + static_cast<long long>(p.tx_n) * p.tw);
  } else {
    o = p.pt + static_cast<long long>(ty) * p.th + __float2ll_rn(sum) - (p.ry + 1);
    o = min(max(o, 0LL), static_cast<long long>(p.pt) + static_cast<long long>(p.ty_n) * p.th);
    if (kBf16) o -= o & 1;
  }
  return static_cast<int>(o);
}

// The window origin of tile (n, ty, tx) inside one CTA (the fused
// prologue), canvas coordinates, as int2 (x: ox, y: oy), bit for bit as
// ops/cuda/warp.py::window_origins. All threads call it (shuffles and
// barriers) and get the same result. The warps reduce the tile's cells,
// kCellBatch steps at once, into shared memory, kCellChunk at a time in two
// buffers (cells: 2 * kCellChunk float2); threads 0 (x) and 1 (y) add one
// chunk in row-major order while the others reduce the next. res: one int2.
template <typename TF, bool kBf16>
__device__ int2 tile_origin(const TF* __restrict__ flow, float tn, const Tiled& p, int n, int ty,
                            int tx, float2* cells, int2* res) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const TF* base = flow + static_cast<size_t>(n) * p.h * p.w * 2;
  const int ncells = p.cy * p.cx;
  const int y_t = ty * p.th, x_t = tx * p.tw;
  const CellLane cl = cell_lane(p);
  float sum = 0.f;  // threads 0 (x) and 1 (y)
  int prev = 0;     // cells of the chunk before this one
  for (int k0 = 0, buf = 0;; k0 += kCellChunk, buf ^= 1) {
    if (threadIdx.x < 2 && prev > 0) {  // row-major, as the twin's final reduce
      const float* cf = reinterpret_cast<const float*>(cells + (buf ^ 1) * kCellChunk) +
                        threadIdx.x;
      int k = 0;
      if (k0 == kCellChunk) sum = cf[0], k = 1;
#pragma unroll 8
      for (; k < prev; ++k) sum = __fadd_rn(sum, cf[2 * k]);
    }
    if (k0 >= ncells) break;
    const int kn = min(kCellChunk, ncells - k0);
    float2* out = cells + buf * kCellChunk;
    // step j of warp w in an iteration: cells it0 + (j * warps + w) * per_step,
    // so that every warp has a step before any has two
    const int wstep = warps * cl.per_step;
    for (int it0 = 0; it0 < kn; it0 += wstep * kCellBatch) {
      float2 v0[kCellBatch], v1[kCellBatch];
      const int c0 = it0 + warp * cl.per_step;
#pragma unroll
      for (int j = 0; j < kCellBatch; ++j) {
        if (c0 + j * wstep >= kn) break;  // warp-uniform: past the chunk's cells
        const int k = k0 + min(c0 + j * wstep + cl.slot, kn - 1);
        const int ci = k / p.cx, cj = k - ci * p.cx;
        cell_loads(base, p, cl, y_t + ci * p.g, x_t + cj * p.g, v0[j], v1[j]);
      }
#pragma unroll
      for (int j = 0; j < kCellBatch; ++j) {
        if (c0 + j * wstep >= kn) break;
        const float2 v = cell_reduce(p, cl, v0[j], v1[j]);
        const int kk = c0 + j * wstep + cl.slot;
        if (kk < kn && cell_owner(cl)) out[kk] = v;
      }
    }
    __syncthreads();
    prev = kn;
  }
  if (threadIdx.x < 2) {
    const int o = finish_origin<kBf16>(sum, threadIdx.x, tn, p, ty, tx);
    if (threadIdx.x == 0) res->x = o;
    else res->y = o;
  }
  __syncthreads();
  return *res;
}

// The origins of tiles of at most kFuseCells cells, one CTA per tile (x:
// tx, y: ty, z: n), by tile_origin, the fused prologue's own function:
// origin [n, ty_n, tx_n, 2] int32 (oy, ox).
template <typename TF, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    tile_origins_kernel(const TF* __restrict__ flow, const float* __restrict__ t,
                        int* __restrict__ origin, Tiled p) {
  __shared__ float2 cells[2 * kCellChunk];
  __shared__ int2 res;
  const int n = blockIdx.z, ty = blockIdx.y, tx = blockIdx.x;
  const int2 o = tile_origin<TF, kBf16>(flow, batch_t(t, p, n), p, n, ty, tx, cells, &res);
  if (threadIdx.x == 0) {
    int* d = origin + ((static_cast<size_t>(n) * p.ty_n + ty) * p.tx_n + tx) * 2;
    d[0] = o.y;
    d[1] = o.x;
  }
}

// The origins pass, first kernel: grid (x: tile of all images, tile-major;
// y: runs of kWarps * kCellBatch warp steps of the tile's cells), the warps
// of a CTA interleaved as in tile_origin; cells[tile * cells per tile + k]
// the mean of the tile's cell k (row-major), float2.
template <typename TF>
__global__ void __launch_bounds__(kThreads)
    cell_means_kernel(const TF* __restrict__ flow, float2* __restrict__ cells, Tiled p) {
  const CellLane cl = cell_lane(p);
  const int ncells = p.cy * p.cx;
  const int tile = blockIdx.x;
  const int tx = tile % p.tx_n, nty = tile / p.tx_n;
  const int ty = nty % p.ty_n, n = nty / p.ty_n;
  const TF* base = flow + static_cast<size_t>(n) * p.h * p.w * 2;
  const int wstep = kWarps * cl.per_step;
  const int c0 = blockIdx.y * wstep * kCellBatch + (threadIdx.x >> 5) * cl.per_step;
  if (c0 >= ncells) return;  // a whole warp
  float2* out = cells + static_cast<size_t>(tile) * ncells;
  float2 v0[kCellBatch], v1[kCellBatch];
#pragma unroll
  for (int j = 0; j < kCellBatch; ++j) {
    if (c0 + j * wstep >= ncells) break;  // warp-uniform
    const int k = min(c0 + j * wstep + cl.slot, ncells - 1);
    const int ci = k / p.cx, cj = k - ci * p.cx;
    cell_loads(base, p, cl, ty * p.th + ci * p.g, tx * p.tw + cj * p.g, v0[j], v1[j]);
  }
#pragma unroll
  for (int j = 0; j < kCellBatch; ++j) {
    if (c0 + j * wstep >= ncells) break;
    const float2 v = cell_reduce(p, cl, v0[j], v1[j]);
    const int k = c0 + j * wstep + cl.slot;
    if (k < ncells && cell_owner(cl)) out[k] = v;
  }
}

// The origins pass, second kernel, one CTA per tile: its cell means are
// staged in shared memory kSumChunk at a time (all threads, coalesced),
// then threads 0 (x) and 1 (y) add them in row-major order and finish the
// origin: origin [n, ty_n, tx_n, 2] int32 (oy, ox), canvas coordinates, as
// window_origins lays it out.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    origins_sum_kernel(const float2* __restrict__ cells, const float* __restrict__ t,
                       int* __restrict__ origin, Tiled p) {
  __shared__ float2 buf[kSumChunk];
  const int tile = blockIdx.x;
  const int ncells = p.cy * p.cx;
  const float2* mine = cells + static_cast<size_t>(tile) * ncells;
  float sum = 0.f;
  for (int k0 = 0; k0 < ncells; k0 += kSumChunk) {
    const int kn = min(kSumChunk, ncells - k0);
    for (int k = threadIdx.x; k < kn; k += kThreads) buf[k] = mine[k0 + k];
    __syncthreads();
    if (threadIdx.x < 2) {
      const float* cf = reinterpret_cast<const float*>(buf) + threadIdx.x;
      int k = 0;
      if (k0 == 0) sum = cf[0], k = 1;
#pragma unroll 8
      for (; k < kn; ++k) sum = __fadd_rn(sum, cf[2 * k]);
    }
    __syncthreads();
  }
  if (threadIdx.x >= 2) return;
  const int tx = tile % p.tx_n, nty = tile / p.tx_n;
  const int ty = nty % p.ty_n, n = nty / p.ty_n;
  origin[static_cast<size_t>(tile) * 2 + (1 - threadIdx.x)] =
      finish_origin<kBf16>(sum, threadIdx.x, batch_t(t, p, n), p, ty, tx);
}

// ---- The warp ---------------------------------------------------------------

// Where one output pixel samples: everything K1 and K2 compute once for all
// its channels.
struct Sample {
  float sy_raw, sx_raw;  // source coordinate before the clip (canvas)
  float ry_raw, rx_raw;  // residual inside the window before its clamp
  float wy0, wy1;        // vertical hat weights at the two taps
  float wx0, wx1;        // horizontal hat weights (bf16-rounded with kBf16)
  int a0, b0;            // floor of the clamped residuals: the upper-left tap
};

// Explicit fmaf and _rn intrinsics fix where each step rounds (nvcc would
// otherwise contract at will): the source coordinate p + flow*t is one
// fused multiply-add, as XLA compiles the reference's expression. (y, x):
// the pixel; (rows, cols): its place in its tile.
template <bool kBf16>
__device__ __forceinline__ Sample sample_at(float fx, float fy, float tn, int2 o, const Tiled& p,
                                            int y, int x, int rows, int cols) {
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
  s.a0 = static_cast<int>(a0);
  s.b0 = static_cast<int>(b0);
  return s;
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

// K1's value of one channel from its 2x2 taps
template <bool kBf16>
__device__ __forceinline__ float interp(const Sample& s, float v00, float v01, float v10,
                                        float v11) {
  const float in0 = row_sum<kBf16>(s.wx0, v00, s.wx1, v01);
  const float in1 = row_sum<kBf16>(s.wx0, v10, s.wx1, v11);
  return __fadd_rn(__fmul_rn(s.wy0, in0), __fmul_rn(s.wy1, in1));
}

// K2's two derivatives of one channel, rounded to img's type (the Pallas
// output's cast): d out/d sy (vertical dhat over the interp rows) and d
// out/d sx (horizontal dhat, exact in bf16, vertical hat). my, mx: 0 where
// the forward saturates.
template <typename TI, bool kBf16>
__device__ __forceinline__ float2 derivs(const Sample& s, float my, float mx, float v00, float v01,
                                         float v10, float v11) {
  const float in0 = row_sum<kBf16>(s.wx0, v00, s.wx1, v01);
  const float in1 = row_sum<kBf16>(s.wx0, v10, s.wx1, v11);
  const float gy = __fadd_rn(__fmul_rn(-my, in0), __fmul_rn(my, in1));
  const float dx0 = row_sum<kBf16>(-mx, v00, mx, v01);
  const float dx1 = row_sum<kBf16>(-mx, v10, mx, v11);
  const float gx = __fadd_rn(__fmul_rn(s.wy0, dx0), __fmul_rn(s.wy1, dx1));
  return make_float2(as_stored<TI>(gx), as_stored<TI>(gy));
}

// A CTA's place: image n, tile (ty, tx), its segment's first tile row ra
// and rows inside the content, its band's first tile column cb and columns
// inside the content; the tile's first image row and column.
struct Place {
  int n, ty, tx, ra, rows_n, cb, cols_n, y_t, x_t;
};

__device__ __forceinline__ Place place(const Tiled& p, const Plan& q) {
  Place c;
  c.n = blockIdx.z;
  c.ty = blockIdx.y / q.segs;
  c.tx = blockIdx.x / q.bands;
  c.ra = (blockIdx.y - c.ty * q.segs) * q.seg_rows;
  c.cb = (blockIdx.x - c.tx * q.bands) * q.cols;
  c.y_t = c.ty * p.th;
  c.x_t = c.tx * p.tw;
  c.rows_n = min(q.seg_rows, min(p.th, p.h - c.y_t) - c.ra);
  c.cols_n = min(q.cols, min(p.tw, p.w - c.x_t) - c.cb);
  return c;
}

// The band's footprint columns: window column j of the band is content
// column xc0 + j; the copied columns [xa, xb) are those clamped into the
// content (the taps clamp into them, or read zero outside the content).
struct Cols {
  int xc0, xa, xb;
};

// One thread's place in a slab: its column cl of the band, its first slab
// row, the warp's first column; whether the column is inside the band.
struct Lane {
  int lane, warp, sub, cl, xw;
  bool live;
};

// Starts the copies of window rows [lo, hi) of the segment (ring row of
// row i: (i - lo + q0) mod qrows) for one unit and its channel chunk
// (groups [v0, v0 + nvl)): whole C, each row one contiguous run of the
// image in 16-byte chunks from the aligned address below it (up to 15
// bytes either side, never past the 16-byte aligned bounds of the
// allocation); channel chunks, each pixel's groups of the chunk. row_off
// gets each ring row's byte offset of its first copied column, or -1 for a
// row outside the content with the constant border (not copied).
template <typename TI, bool kConstant, bool kChunked>
__device__ __forceinline__ void fill_rows(const TI* __restrict__ img_n, unsigned char* ring,
                                          int* row_off, int lo, int hi, int q0, int oy_row,
                                          const Cols& k, int v0, int nvl, const Tiled& p,
                                          const Plan& q) {
  constexpr int kB = static_cast<int>(sizeof(TI));
  constexpr int kVe = 16 / kB;
  const int nrows = hi - lo;
  if (nrows <= 0) return;
  if constexpr (!kChunked) {
    const int run = (k.xb - k.xa) * p.c * kB;
    const int per = run / 16 + 2;  // chunks of a row from any alignment; q.pitch holds them
    int i = threadIdx.x / per, e = threadIdx.x - i * per;
    const int di = kThreads / per, de = kThreads - di * per;
    for (; i < nrows; i += di, e += de) {
      if (e >= per) e -= per, ++i;
      if (i >= nrows) break;
      int yc = oy_row + lo + i;
      const bool ok = !kConstant || (yc >= 0 && yc < p.h);
      yc = min(max(yc, 0), p.h - 1);
      int r = q0 + i;
      if (r >= q.qrows) r -= q.qrows;
      const unsigned char* g = reinterpret_cast<const unsigned char*>(
          img_n + (static_cast<size_t>(yc) * p.w + k.xa) * p.c);
      const int off = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
      if (e == 0) row_off[r] = ok ? r * q.pitch + off : -1;
      if (ok && e * 16 < off + run) cp_async16(ring + r * q.pitch + e * 16, g - off + e * 16);
    }
  } else {
    // items (row, column, group), the group fastest; cvec is a power of two
    const int lg = __ffs(q.cvec) - 1;
    const int per = (k.xb - k.xa) << lg;
    int i = threadIdx.x / per, e = threadIdx.x - i * per;
    const int di = kThreads / per, de = kThreads - di * per;
    for (; i < nrows; i += di, e += de) {
      if (e >= per) e -= per, ++i;
      if (i >= nrows) break;
      int yc = oy_row + lo + i;
      const bool ok = !kConstant || (yc >= 0 && yc < p.h);
      yc = min(max(yc, 0), p.h - 1);
      int r = q0 + i;
      if (r >= q.qrows) r -= q.qrows;
      const int j = e >> lg, v = e & (q.cvec - 1);
      if (e == 0) row_off[r] = ok ? r * q.pitch : -1;
      if (!ok || v >= nvl) continue;
      const int ch = (v0 + v) * kVe;
      const TI* src = img_n + (static_cast<size_t>(yc) * p.w + k.xa + j) * p.c + ch;
      unsigned char* dst = ring + r * q.pitch + j * q.px + v * 16;
      if (q.vec16) {
        cp_async16(dst, src);
      } else {  // a ragged or unaligned channel run, element by element, zeros past C
        using U = typename std::conditional<sizeof(TI) == 4, unsigned, unsigned short>::type;
        const U* s = reinterpret_cast<const U*>(src);
        U* d = reinterpret_cast<U*>(dst);
#pragma unroll
        for (int u = 0; u < kVe; ++u) d[u] = ch + u < p.c ? __ldg(s + u) : U(0);
      }
    }
  }
}

// Starts the copies of K2's cotangent of one slab (rows [0, rn) of the
// slab whose first image row is y0, the band's columns from image column
// x0) into a slot: whole C, each row one run (ct_row gets its byte offset
// in the slot); channel chunks, each pixel's groups of the chunk at (row *
// cols + column) * px.
template <typename TI, bool kChunked>
__device__ __forceinline__ void fill_ct(const TI* __restrict__ ct, unsigned char* slot,
                                        int* ct_row, int rn, int y0, int x0, int cols_n, int n,
                                        int v0, int nvl, const Tiled& p, const Plan& q) {
  constexpr int kB = static_cast<int>(sizeof(TI));
  constexpr int kVe = 16 / kB;
  if constexpr (!kChunked) {
    const int run = cols_n * p.c * kB;
    const int per = run / 16 + 2;
    int i = threadIdx.x / per, e = threadIdx.x - i * per;
    const int di = kThreads / per, de = kThreads - di * per;
    for (; i < rn; i += di, e += de) {
      if (e >= per) e -= per, ++i;
      if (i >= rn) break;
      const unsigned char* g = reinterpret_cast<const unsigned char*>(
          ct + ((static_cast<size_t>(n) * p.h + y0 + i) * p.w + x0) * p.c);
      const int off = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
      if (e == 0) ct_row[i] = i * q.ct_pitch + off;
      if (e * 16 < off + run) cp_async16(slot + i * q.ct_pitch + e * 16, g - off + e * 16);
    }
  } else {
    const int lg = __ffs(q.cvec) - 1;
    const int per = cols_n << lg;
    int i = threadIdx.x / per, e = threadIdx.x - i * per;
    const int di = kThreads / per, de = kThreads - di * per;
    for (; i < rn; i += di, e += de) {
      if (e >= per) e -= per, ++i;
      if (i >= rn) break;
      const int j = e >> lg, v = e & (q.cvec - 1);
      if (v >= nvl) continue;
      const int ch = (v0 + v) * kVe;
      const TI* src = ct + ((static_cast<size_t>(n) * p.h + y0 + i) * p.w + x0 + j) * p.c + ch;
      unsigned char* dst = slot + (i * q.cols + j) * q.px + v * 16;
      if (q.vec16) {
        cp_async16(dst, src);
      } else {
        using U = typename std::conditional<sizeof(TI) == 4, unsigned, unsigned short>::type;
        const U* s = reinterpret_cast<const U*>(src);
        U* d = reinterpret_cast<U*>(dst);
#pragma unroll
        for (int u = 0; u < kVe; ++u) d[u] = ch + u < p.c ? __ldg(s + u) : U(0);
      }
    }
  }
}

// Where a pixel's 2x2 taps lie in the ring: byte offsets of its two rows
// and two columns, and whether each tap is inside the content (constant
// border; always with replicate).
struct Taps {
  int row[2], col[2];
  bool ok[2][2];
};

// rr: the ring row of the upper tap row (its lower one follows, mod
// qrows); j: the band's window column of the left tap.
template <bool kConstant>
__device__ __forceinline__ Taps taps_at(const int* row_off, int rr, int j, const Cols& k,
                                        const Tiled& p, const Plan& q) {
  Taps t;
  bool okr[2], okc[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    int r = rr + a;
    if (r >= q.qrows) r -= q.qrows;
    const int ro = row_off[r];
    okr[a] = !kConstant || ro >= 0;
    t.row[a] = max(ro, 0);
    const int xq = k.xc0 + j + a;  // content column of the tap
    okc[a] = !kConstant || (xq >= 0 && xq < p.w);
    t.col[a] = (min(max(xq, k.xa), k.xb - 1) - k.xa) * q.px;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) t.ok[a][b] = okr[a] && okc[b];
  return t;
}

// Copies a warp's run of n elements from its staging buffer (16-byte
// aligned) to dst: 16-byte stores where dst and the run allow them.
template <typename TI>
__device__ __forceinline__ void store_run(TI* dst, const TI* src, int n, int lane) {
  const int bytes = n * static_cast<int>(sizeof(TI));
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && (bytes & 15) == 0) {
    for (int i = lane; i < bytes / 16; i += 32)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  } else {
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
  }
}

// Packed bf16 pairs, each result rounded to nearest even. The explicit .rn
// keeps ptxas from contracting a product and a sum into one fma, which
// would skip the product's rounding.
__device__ __forceinline__ __nv_bfloat162 mul_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  __nv_bfloat162 r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(*reinterpret_cast<unsigned*>(&r))
      : "r"(*reinterpret_cast<const unsigned*>(&a)), "r"(*reinterpret_cast<const unsigned*>(&b)));
  return r;
}
__device__ __forceinline__ __nv_bfloat162 add_rn(__nv_bfloat162 a, __nv_bfloat162 b) {
  __nv_bfloat162 r;
  asm("add.rn.bf16x2 %0, %1, %2;\n"
      : "=r"(*reinterpret_cast<unsigned*>(&r))
      : "r"(*reinterpret_cast<const unsigned*>(&a)), "r"(*reinterpret_cast<const unsigned*>(&b)));
  return r;
}

// K1's channels ch and ch + 1 (the last channel paired with itself where C
// is odd) with a bf16 window, as packed bf16 pairs: bf16 products of bf16
// values are exact in f32, so rounding them once (mul.rn.bf16x2) is the
// twin's f32 product rounded to bf16, and the pair's sum (add.rn.bf16x2)
// its f32 sum rounded; the vertical step stays f32.
template <typename TI, bool kConstant>
__device__ __forceinline__ float2 interp_pair(const unsigned char* ring, const Taps& tp,
                                              const Sample& s, int ch, int c1) {
  constexpr int kB = static_cast<int>(sizeof(TI));
  __nv_bfloat162 v[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const unsigned char* at = ring + tp.row[a] + tp.col[b];
      v[a][b] = __floats2bfloat162_rn(sval<TI>(at + ch * kB), sval<TI>(at + c1 * kB));
      if (kConstant && !tp.ok[a][b]) v[a][b] = __float2bfloat162_rn(0.f);
    }
  const __nv_bfloat162 w0 = __float2bfloat162_rn(s.wx0), w1 = __float2bfloat162_rn(s.wx1);
  const __nv_bfloat162 in0 = add_rn(mul_rn(w0, v[0][0]), mul_rn(w1, v[0][1]));
  const __nv_bfloat162 in1 = add_rn(mul_rn(w0, v[1][0]), mul_rn(w1, v[1][1]));
  return make_float2(
      __fadd_rn(__fmul_rn(s.wy0, __low2float(in0)), __fmul_rn(s.wy1, __low2float(in1))),
      __fadd_rn(__fmul_rn(s.wy0, __high2float(in0)), __fmul_rn(s.wy1, __high2float(in1))));
}

// K1 (kGrad false) and K2 (kGrad true); kChunked: channel chunks, else
// whole C. A CTA walks its units, (slab, channel chunk) with the chunk
// fastest, through the ring: unit u + 1's copies are in flight while unit
// u is computed. K1 writes out; K2 reads ct from the ring and sums each
// pixel's channels in channel order, across the chunks, then writes cg and
// grad_flow = cg * t. origin: the origins pass's table, or null where the
// plan is fused.
template <typename TI, typename TF, bool kBf16, bool kConstant, bool kGrad, bool kChunked>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    tiled_kernel(const TI* __restrict__ img, const TF* __restrict__ flow,
                 const float* __restrict__ t, const int* __restrict__ origin,
                 const TI* __restrict__ ct, TI* __restrict__ out, float* __restrict__ cg,
                 TF* __restrict__ grad_flow, Tiled p, Plan q) {
  constexpr int kB = static_cast<int>(sizeof(TI));
  constexpr int kVe = 16 / kB;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int2 res;
  const Place c = place(p, q);
  if (c.rows_n <= 0 || c.cols_n <= 0) return;  // past the content: the whole CTA
  const float tn = batch_t(t, p, c.n);
  int2 o;  // (x: ox, y: oy)
  if (q.fused) {
    o = tile_origin<TF, kBf16>(flow, tn, p, c.n, c.ty, c.tx, reinterpret_cast<float2*>(smem),
                               &res);
  } else {
    const int* ot = origin + ((static_cast<size_t>(c.n) * p.ty_n + c.ty) * p.tx_n + c.tx) * 2;
    o = make_int2(ot[1], ot[0]);
  }
  int* row_off = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + q.ring_off;
  int* ct_rows = reinterpret_cast<int*>(smem + q.ctoff_off);
  unsigned char* ct_slots = smem + q.ct_off;
  Cols k;
  k.xc0 = o.x - p.pl + c.cb;
  k.xa = min(max(k.xc0, 0), p.w - 1);
  k.xb = min(max(k.xc0 + c.cols_n + p.nsh_x - 2, 0), p.w - 1) + 1;
  const int oy_row = o.y - p.pt + c.ra;  // content row of the segment's window row 0
  Lane l;
  l.lane = threadIdx.x & 31;
  l.warp = threadIdx.x >> 5;
  l.sub = threadIdx.x / q.lanes;
  l.cl = threadIdx.x - l.sub * q.lanes;
  l.xw = l.cl - l.lane;
  l.live = l.sub < q.subrows && l.cl < c.cols_n;
  const int x = c.x_t + c.cb + l.cl;  // the thread's image column
  const TI* img_n = img + static_cast<size_t>(c.n) * p.h * p.w * p.c;
  const int nslab = (c.rows_n + q.rows - 1) / q.rows;
  const int nch = kChunked ? q.chunks : 1;
  const int units = nslab * nch;
  const int F = q.rows + p.nsh_y - 1;  // window rows of a full slab
  const int groups = (p.c * kB + 15) / 16;

  // unit u's copies: its window rows not yet in the ring (whole C rolls:
  // slab s adds rows [sR + nsh_y - 1, (s+1)R + nsh_y - 1), slab 0 all of
  // its rows; channel chunks copy the slab's rows into their slot), and
  // K2's cotangent of the slab; then one commit group
  auto fill = [&](int u) {
    if (u < units) {
      const int s = u / nch, ck = u - s * nch;
      const int r0 = s * q.rows, rn = min(q.rows, c.rows_n - r0);
      // channel chunks: groups [v0, v0 + nv) of the pixel's 16-byte groups
      const int v0 = ck * q.cvec, nv = min(q.cvec, groups - v0);
      if constexpr (!kChunked) {
        const int lo = s == 0 ? 0 : r0 + p.nsh_y - 1, hi = r0 + rn + p.nsh_y - 1;
        fill_rows<TI, kConstant, false>(img_n, ring, row_off, lo, hi, lo % q.qrows, oy_row, k,
                                        0, 0, p, q);
      } else {
        fill_rows<TI, kConstant, true>(img_n, ring, row_off, r0, r0 + rn + p.nsh_y - 1,
                                       (u & 1) * F, oy_row, k, v0, nv, p, q);
      }
      if constexpr (kGrad) {
        const int sl = q.slots > 1 ? (u & 1) : 0;
        fill_ct<TI, kChunked>(ct, ct_slots + sl * q.rows * q.ct_pitch, ct_rows + sl * q.rows, rn,
                              c.y_t + c.ra + r0, c.x_t + c.cb, c.cols_n, c.n, v0, nv, p, q);
      }
    }
    cp_async_commit();  // an empty group past the last unit keeps the wait counts uniform
  };

  float2 acc[kChunked && kGrad ? kMaxItems : 1];  // K2 over channel chunks: the thread's pixels
#pragma unroll
  for (int i = 0; i < (kChunked && kGrad ? kMaxItems : 1); ++i) acc[i] = make_float2(0.f, 0.f);
  int base = 0;  // whole C: the ring row of the slab's window row 0
  fill(0);
  for (int u = 0; u < units; ++u) {
    if (q.slots > 1) {
      fill(u + 1);
      cp_async_wait<1>();  // unit u's copies (this thread's) have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // everyone's have
    const int s = u / nch, ck = u - s * nch;
    const int r0 = s * q.rows, rn = min(q.rows, c.rows_n - r0);
    const int sl = q.slots > 1 ? (u & 1) : 0;
    const int rbase = kChunked ? sl * F : base;
    const int* ct_row = ct_rows + sl * q.rows;
    const unsigned char* ct_slot = ct_slots + sl * q.rows * q.ct_pitch;
    // the rows of the slab this thread computes: sub, sub + subrows, ...
    if (l.sub < q.subrows && l.xw < c.cols_n) {  // whole warps: lanes is a multiple of 32
      const int y0 = c.y_t + c.ra + r0;             // the slab's first image row
      const int rows0 = c.ra + r0;                  // its first tile row
      const TF* fl = flow + ((static_cast<size_t>(c.n) * p.h + y0) * p.w + x) * 2;
      if constexpr (!kChunked) {
        const int npx = min(32, c.cols_n - l.xw);  // the warp's pixels of a row
        float2 f = make_float2(0.f, 0.f);
        if (l.live && l.sub < rn) f = ld_pair(fl + static_cast<size_t>(l.sub) * p.w * 2);
        for (int r = l.sub; r < rn; r += q.subrows) {
          float2 nf = make_float2(0.f, 0.f);  // the next row's flow, in flight
          const int r2 = r + q.subrows;
          if (l.live && r2 < rn) nf = ld_pair(fl + static_cast<size_t>(r2) * p.w * 2);
          if constexpr (!kGrad) {
            TI* stage = reinterpret_cast<TI*>(smem + q.stage_off) + l.warp * 32 * p.c;
            if (l.live) {
              const Sample sm = sample_at<kBf16>(f.x, f.y, tn, o, p, y0 + r, x, rows0 + r,
                                                 c.cb + l.cl);
              int rr = rbase + r + sm.a0;
              if (rr >= q.qrows) rr -= q.qrows;
              const Taps tp = taps_at<kConstant>(row_off, rr, l.cl + sm.b0, k, p, q);
              TI* dst = stage + l.lane * p.c;
              if constexpr (kBf16) {
                for (int ch = 0; ch < p.c; ch += 2) {
                  const int c1 = min(ch + 1, p.c - 1);
                  const float2 v = interp_pair<TI, kConstant>(ring, tp, sm, ch, c1);
                  st(dst + ch, v.x);
                  if (c1 > ch) st(dst + c1, v.y);
                }
              } else {
                for (int ch = 0; ch < p.c; ++ch) {
                  float v[2][2];
#pragma unroll
                  for (int a = 0; a < 2; ++a)
#pragma unroll
                    for (int b = 0; b < 2; ++b) {
                      const float val = sval<TI>(ring + tp.row[a] + tp.col[b] + ch * kB);
                      v[a][b] = tp.ok[a][b] ? val : 0.f;
                    }
                  st(dst + ch, interp<false>(sm, v[0][0], v[0][1], v[1][0], v[1][1]));
                }
              }
            }
            __syncwarp();
            store_run(out + ((static_cast<size_t>(c.n) * p.h + y0 + r) * p.w + c.x_t + c.cb +
                             l.xw) * p.c,
                      stage, npx * p.c, l.lane);
            __syncwarp();
          } else {
            if (l.live) {
              const Sample sm = sample_at<kBf16>(f.x, f.y, tn, o, p, y0 + r, x, rows0 + r,
                                                 c.cb + l.cl);
              const float my = (sm.sy_raw >= p.ylo && sm.sy_raw < p.yhi && sm.ry_raw >= 0.f &&
                                sm.ry_raw < p.ry_max) ? 1.f : 0.f;
              const float mx = (sm.sx_raw >= p.xlo && sm.sx_raw < p.xhi && sm.rx_raw >= 0.f &&
                                sm.rx_raw < p.rx_max) ? 1.f : 0.f;
              int rr = rbase + r + sm.a0;
              if (rr >= q.qrows) rr -= q.qrows;
              const Taps tp = taps_at<kConstant>(row_off, rr, l.cl + sm.b0, k, p, q);
              const unsigned char* cv = ct_slot + ct_row[r] + l.cl * p.c * kB;
              float2 sum = make_float2(0.f, 0.f);
              for (int ch = 0; ch < p.c; ++ch) {
                float v[2][2];
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                  for (int b = 0; b < 2; ++b) {
                    const float val = win_val<TI, kBf16>(ring + tp.row[a] + tp.col[b] + ch * kB);
                    v[a][b] = tp.ok[a][b] ? val : 0.f;
                  }
                const float2 d = derivs<TI, kBf16>(sm, my, mx, v[0][0], v[0][1], v[1][0],
                                                   v[1][1]);
                const float cvf = sval<TI>(cv + ch * kB);
                sum.y = __fadd_rn(sum.y, __fmul_rn(cvf, d.y));
                sum.x = __fadd_rn(sum.x, __fmul_rn(cvf, d.x));
              }
              const size_t pix = (static_cast<size_t>(c.n) * p.h + y0 + r) * p.w + x;
              reinterpret_cast<float2*>(cg)[pix] = sum;
              st_pair(grad_flow + pix * 2, __fmul_rn(sum.x, tn), __fmul_rn(sum.y, tn));
            }
          }
          f = nf;
        }
      } else {
        // channel chunks: the thread's pixels (at most kMaxItems), this
        // chunk's groups as 16-byte vectors from the ring
        const int v0 = ck * q.cvec, nv = min(q.cvec, groups - v0);
        const int ncw = min(p.c - v0 * kVe, nv * kVe);  // the chunk's channels
        // a warp's output run: lane k of step i takes element 32i + k,
        // pixel and channel advancing by (dpx, de) per step, 32 = dpx * ncw + de
        const int dpx = 32 / ncw, de = 32 - dpx * ncw;
        const int px0 = l.lane / ncw, e0 = l.lane - px0 * ncw;
#pragma unroll
        for (int it = 0; it < kMaxItems; ++it) {
          const int r = l.sub + it * q.subrows;
          if (r >= rn) break;
          Sample sm;
          Taps tp;
          float my = 0.f, mx = 0.f;
          if (l.live) {
            const float2 f = ld_pair(fl + static_cast<size_t>(r) * p.w * 2);
            sm = sample_at<kBf16>(f.x, f.y, tn, o, p, y0 + r, x, rows0 + r, c.cb + l.cl);
            tp = taps_at<kConstant>(row_off, rbase + r + sm.a0, l.cl + sm.b0, k, p, q);
            if constexpr (kGrad) {
              my = (sm.sy_raw >= p.ylo && sm.sy_raw < p.yhi && sm.ry_raw >= 0.f &&
                    sm.ry_raw < p.ry_max) ? 1.f : 0.f;
              mx = (sm.sx_raw >= p.xlo && sm.sx_raw < p.xhi && sm.rx_raw >= 0.f &&
                    sm.rx_raw < p.rx_max) ? 1.f : 0.f;
            }
          }
          if constexpr (!kGrad) {
            TI* stage = reinterpret_cast<TI*>(smem + q.stage_off) + l.warp * 32 * q.cvec * kVe;
            if (l.live) {
              TI* dst = stage + l.lane * ncw;
              for (int v = 0; v < nv; ++v) {
                uint4 tv[2][2];
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                  for (int b = 0; b < 2; ++b)
                    tv[a][b] = tp.ok[a][b] ? *reinterpret_cast<const uint4*>(
                                                 ring + tp.row[a] + tp.col[b] + v * 16)
                                           : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
                for (int e = 0; e < kVe; ++e) {
                  if (v * kVe + e >= ncw) break;
                  float w4[2][2];
#pragma unroll
                  for (int a = 0; a < 2; ++a)
#pragma unroll
                    for (int b = 0; b < 2; ++b) {
                      const float val = vec_val<TI>(tv[a][b], e);
                      w4[a][b] = (kBf16 && kB == 4) ? bf16_round(val) : val;
                    }
                  st(dst + v * kVe + e, interp<kBf16>(sm, w4[0][0], w4[0][1], w4[1][0], w4[1][1]));
                }
              }
            }
            __syncwarp();
            // the warp's pixels, each a run of ncw channels of out
            const int npx = min(32, c.cols_n - l.xw);
            TI* row = out + ((static_cast<size_t>(c.n) * p.h + y0 + r) * p.w + c.x_t + c.cb +
                             l.xw) * p.c + v0 * kVe;
            int px = px0, e = e0;
            while (px < npx) {
              row[static_cast<size_t>(px) * p.c + e] = stage[px * ncw + e];
              px += dpx;
              e += de;
              if (e >= ncw) e -= ncw, ++px;
            }
            __syncwarp();
          } else {
            if (l.live) {
              const unsigned char* cv = ct_slot + (r * q.cols + l.cl) * q.px;
              float2 sum = acc[it];
              for (int v = 0; v < nv; ++v) {
                uint4 tv[2][2];
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                  for (int b = 0; b < 2; ++b)
                    tv[a][b] = tp.ok[a][b] ? *reinterpret_cast<const uint4*>(
                                                 ring + tp.row[a] + tp.col[b] + v * 16)
                                           : make_uint4(0u, 0u, 0u, 0u);
                const uint4 cvv = *reinterpret_cast<const uint4*>(cv + v * 16);
#pragma unroll
                for (int e = 0; e < kVe; ++e) {
                  if (v * kVe + e >= ncw) break;
                  float w4[2][2];
#pragma unroll
                  for (int a = 0; a < 2; ++a)
#pragma unroll
                    for (int b = 0; b < 2; ++b) {
                      const float val = vec_val<TI>(tv[a][b], e);
                      w4[a][b] = (kBf16 && kB == 4) ? bf16_round(val) : val;
                    }
                  const float2 d = derivs<TI, kBf16>(sm, my, mx, w4[0][0], w4[0][1], w4[1][0],
                                                     w4[1][1]);
                  const float cvf = vec_val<TI>(cvv, e);
                  sum.y = __fadd_rn(sum.y, __fmul_rn(cvf, d.y));
                  sum.x = __fadd_rn(sum.x, __fmul_rn(cvf, d.x));
                }
              }
              acc[it] = sum;
              if (ck == nch - 1) {
                const size_t pix = (static_cast<size_t>(c.n) * p.h + y0 + r) * p.w + x;
                reinterpret_cast<float2*>(cg)[pix] = sum;
                st_pair(grad_flow + pix * 2, __fmul_rn(sum.x, tn), __fmul_rn(sum.y, tn));
                acc[it] = make_float2(0.f, 0.f);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // everyone is done with unit u's slot and ring rows
    if constexpr (!kChunked) {
      base += q.rows;
      if (base >= q.qrows) base -= q.qrows;
    }
  }
}

// ---- Plans and launches -----------------------------------------------------

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }
int round16(long long b) { return static_cast<int>((b + 15) / 16 * 16); }

// The tile geometry of a launch; false where the kernels do not take it.
bool make_tiled(Tiled& p, int n, int h, int w, int c, int th, int tw, int ry, int rx, int pt,
                int pl, float t_scalar, int t_stride) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || th <= 0 || tw <= 0 || n > 65535) return false;
  p = Tiled{};
  p.n = n, p.h = h, p.w = w, p.c = c, p.th = th, p.tw = tw;
  p.ty_n = (h + th - 1) / th;
  p.tx_n = (w + tw - 1) / tw;
  if (p.ty_n > 65535 || p.tx_n > 65535 || static_cast<long long>(n) * h * w >= (1LL << 40))
    return false;
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

// Lays out a plan's shared memory (ring rows, row offsets, K2's cotangent
// slots, K1's staging) and returns its bytes.
int layout(Plan& q, int nsh_y, int nsh_x, int c, int b, bool grad) {
  const int F = q.rows + nsh_y - 1;
  const int wf = q.cols + nsh_x - 1;
  if (!q.chunked) {
    q.qrows = q.slabs > 1 ? 2 * q.rows + nsh_y - 1 : F;
    q.px = c * b;
    q.pitch = round16(static_cast<long long>(wf) * c * b) + 32;  // + alignment slack
    q.ct_pitch = round16(static_cast<long long>(q.cols) * c * b) + 32;
  } else {
    q.qrows = q.slots * F;
    q.px = q.cvec * 16 + ((q.cvec & 1) ? 0 : 16);  // an odd number of 16-byte groups
    q.pitch = wf * q.px;
    q.ct_pitch = q.cols * q.px;
  }
  const int ct_slots = grad ? q.slots : 0;
  q.ring_off = round16(4LL * q.qrows);
  q.ctoff_off = q.ring_off + q.qrows * q.pitch;
  q.ct_off = q.ctoff_off + round16(4LL * ct_slots * q.rows);
  q.stage_off = q.ct_off + ct_slots * q.rows * q.ct_pitch;
  const int stage = grad ? 0 : kWarps * 32 * (q.chunked ? q.cvec * (16 / b) : c) * b;
  return q.stage_off + stage;
}

// How a launch is cut (see Plan; ops/cuda/warp.py::tiled_plan mirrors this
// function). Whole C: bands of at most kMaxW columns; row segments halved
// until the launch has kWaveCtas CTAs per SM; the most rows per slab whose
// ring leaves room for two CTAs per SM, then slabs of equal rows. Where
// one row does not fit, channel chunks: kChunkW x kChunkR blocks (fewer
// rows where a group does not fit), the most 16-byte groups per chunk (a
// power of two, at most kMaxChunkVec) that fit. fused: one CTA per tile.
cudaError_t make_plan(Plan& q, int n, int h, int w, int c, int b, int th, int tw, int nsh_y,
                      int nsh_x, bool grad, int sms) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || th <= 0 || tw <= 0 || nsh_y < 2 || nsh_x < 2 ||
      sms <= 0)
    return cudaErrorInvalidValue;
  q = Plan{};
  const long long tiles = static_cast<long long>(n) * cdiv(h, th) * cdiv(w, tw);
  const int th_e = h < th ? h : th, tw_e = w < tw ? w : tw;
  q.bands = cdiv(tw_e, kMaxW);
  q.cols = tw_e;
  if (q.bands > 1) q.cols = (cdiv(tw_e, q.bands) + 31) / 32 * 32;
  q.bands = cdiv(tw_e, q.cols);
  // a CTA holding a whole tile computes its origin in its prologue: where
  // that takes more than one batch of cells per warp, the tile is cut in
  // two bands (or two segments) and the origins pass takes it
  int g = 1;
  while (th % (2 * g) == 0 && tw % (2 * g) == 0) g *= 2;
  q.segs = 1;
  if (q.bands == 1 && static_cast<long long>(th / g) * (tw / g) > kFuseCells) {
    if (tw_e >= 64) {
      q.cols = (cdiv(tw_e, 2) + 31) / 32 * 32;
      q.bands = cdiv(tw_e, q.cols);
    } else if (th_e >= 2) {
      q.segs = 2;
    }
  }
  while (tiles * q.bands * q.segs < static_cast<long long>(kWaveCtas) * sms && q.segs < th_e)
    q.segs *= 2;
  q.seg_rows = cdiv(th_e, q.segs);
  q.segs = cdiv(th_e, q.seg_rows);
  q.chunks = 1;
  int best = 0;
  for (int r = 1; r <= kMaxR && r <= q.seg_rows; ++r) {
    q.rows = r;
    q.slabs = cdiv(q.seg_rows, r);
    q.slots = q.slabs > 1 ? 2 : 1;
    if (layout(q, nsh_y, nsh_x, c, b, grad) <= kSmemCta) best = r;
  }
  if (best > 0) {
    q.slabs = cdiv(q.seg_rows, best);
    q.rows = cdiv(q.seg_rows, q.slabs);
    q.slabs = cdiv(q.seg_rows, q.rows);
    q.slots = q.slabs > 1 ? 2 : 1;
  } else {
    q.chunked = 1;
    q.cols = tw_e < kChunkW ? tw_e : kChunkW;
    q.bands = cdiv(tw_e, q.cols);
    const int groups = cdiv(static_cast<long long>(c) * b, 16);
    bool fit = false;
    for (int r = th_e < kChunkR ? th_e : kChunkR; r >= 1 && !fit; r = r / 2) {
      q.rows = r;
      for (int v = kMaxChunkVec; v >= 1; v /= 2) {
        if (v > groups && v > 1) continue;
        q.cvec = v;
        q.chunks = cdiv(groups, v);
        q.slots = q.chunks > 1 ? 2 : 1;
        if (layout(q, nsh_y, nsh_x, c, b, grad) <= kSmemCta) {
          fit = true;
          break;
        }
      }
    }
    if (!fit) return cudaErrorInvalidValue;
    q.seg_rows = q.rows;
    q.segs = cdiv(th_e, q.rows);
    q.slabs = 1;
    q.vec16 = (static_cast<long long>(c) * b) % 16 == 0;
  }
  q.lanes = q.cols < 32 ? 32 : (q.cols + 31) / 32 * 32;
  q.subrows = kThreads / q.lanes;
  q.fused = q.bands == 1 && q.segs == 1;
  const int bytes = layout(q, nsh_y, nsh_x, c, b, grad);
  const int cells = 2 * kCellChunk * 8;
  q.smem = q.fused && bytes < cells ? cells : bytes;
  if (static_cast<long long>(cdiv(w, tw)) * q.bands > 0x7fffffffLL ||
      static_cast<long long>(cdiv(h, th)) * q.segs > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t device_plan(Plan& q, int* dev, int n, int h, int w, int c, int b, int th, int tw,
                        int nsh_y, int nsh_x, bool grad) {
  int sms = 0;
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, *dev);
  if (err != cudaSuccess) return err;
  return make_plan(q, n, h, w, c, b, th, tw, nsh_y, nsh_x, grad, sms);
}

// Lets `kernel` take up to kSmemCta of dynamic shared memory on device dev,
// once per kernel and device (done: the kernel's own flags), so that no
// attribute call falls inside a CUDA-graph capture after the first launch.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, int dev, bool* done) {
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCta);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The origins pass: every tile's cell means into cells (f32 pairs, [n,
// ty_n, tx_n, cells per tile]), then each tile's ordered sum into origin.
template <typename TF, bool kBf16>
cudaError_t launch_origins(const Tiled& p, const void* flow, const float* t, float2* cells,
                           int* origin, cudaStream_t s) {
  const long long tiles = static_cast<long long>(p.n) * p.ty_n * p.tx_n;
  const int per_step = p.levels >= 4 ? 1 : p.levels == 3 ? 4 : 32 >> (2 * p.levels);
  const int per_cta = kWarps * per_step * kCellBatch;
  const long long runs = (static_cast<long long>(p.cy) * p.cx + per_cta - 1) / per_cta;
  if (tiles > 0x7fffffffLL || runs > 65535) return cudaErrorInvalidValue;
  cell_means_kernel<TF><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(runs)),
                          kThreads, 0, s>>>(static_cast<const TF*>(flow), cells, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  origins_sum_kernel<kBf16><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(cells, t, origin,
                                                                             p);
  return cudaGetLastError();
}

cudaError_t origins_typed(const Tiled& p, int flow_bf16, int bf16_window, const void* flow,
                          const float* t, float2* cells, int* origin, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (flow_bf16)
    return bf16_window ? launch_origins<bf16, true>(p, flow, t, cells, origin, s)
                       : launch_origins<bf16, false>(p, flow, t, cells, origin, s);
  return bf16_window ? launch_origins<float, true>(p, flow, t, cells, origin, s)
                     : launch_origins<float, false>(p, flow, t, cells, origin, s);
}

template <typename TF, bool kBf16>
cudaError_t launch_tile_origins(const Tiled& p, const void* flow, const float* t, int* origin,
                                cudaStream_t s) {
  tile_origins_kernel<TF, kBf16><<<dim3(p.tx_n, p.ty_n, p.n), kThreads, 0, s>>>(
      static_cast<const TF*>(flow), t, origin, p);
  return cudaGetLastError();
}

// The origins as the kernels compute them, for kernel_origins: tiles of at
// most kFuseCells cells by tile_origin (a fused kernel's prologue), others
// by the origins pass.
cudaError_t kernel_origins_typed(const Tiled& p, int flow_bf16, int bf16_window,
                                 const void* flow, const float* t, float2* cells, int* origin,
                                 cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (static_cast<long long>(p.cy) * p.cx <= kFuseCells) {
    if (flow_bf16)
      return bf16_window ? launch_tile_origins<bf16, true>(p, flow, t, origin, s)
                         : launch_tile_origins<bf16, false>(p, flow, t, origin, s);
    return bf16_window ? launch_tile_origins<float, true>(p, flow, t, origin, s)
                       : launch_tile_origins<float, false>(p, flow, t, origin, s);
  }
  return origins_typed(p, flow_bf16, bf16_window, flow, t, cells, origin, s);
}


template <typename TI, typename TF, bool kGrad, bool kBf16, bool kConstant, bool kChunked>
cudaError_t launch_kernel(const Tiled& p, const Plan& q, int dev, const void* img,
                          const void* flow, const float* t, const int* origin, const void* ct,
                          void* out, float* cg, void* grad_flow, cudaStream_t s) {
  static bool done[kMaxDevices] = {};
  auto* kernel = tiled_kernel<TI, TF, kBf16, kConstant, kGrad, kChunked>;
  const cudaError_t err = set_smem(kernel, dev, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.tx_n * q.bands, p.ty_n * q.segs, p.n);
  kernel<<<grid, kThreads, q.smem, s>>>(
      static_cast<const TI*>(img), static_cast<const TF*>(flow), t, origin,
      static_cast<const TI*>(ct), static_cast<TI*>(out), cg, static_cast<TF*>(grad_flow), p, q);
  return cudaGetLastError();
}

template <typename TI, typename TF, bool kGrad, bool kBf16, bool kConstant>
cudaError_t launch_one(const Tiled& p, const Plan& q, int dev, const void* img, const void* flow,
                       const float* t, const int* origin, const void* ct, void* out, float* cg,
                       void* grad_flow, cudaStream_t s) {
  return q.chunked ? launch_kernel<TI, TF, kGrad, kBf16, kConstant, true>(
                         p, q, dev, img, flow, t, origin, ct, out, cg, grad_flow, s)
                   : launch_kernel<TI, TF, kGrad, kBf16, kConstant, false>(
                         p, q, dev, img, flow, t, origin, ct, out, cg, grad_flow, s);
}

template <typename TI, typename TF, bool kGrad>
cudaError_t launch_modes(const Tiled& p, const Plan& q, int dev, int bf16_window, int constant,
                         const void* img, const void* flow, const float* t, const int* origin,
                         const void* ct, void* out, float* cg, void* grad_flow, cudaStream_t s) {
#define VFISR_TILED_ONE(B, K) \
  launch_one<TI, TF, kGrad, B, K>(p, q, dev, img, flow, t, origin, ct, out, cg, grad_flow, s)
  if (bf16_window) return constant ? VFISR_TILED_ONE(true, true) : VFISR_TILED_ONE(true, false);
  return constant ? VFISR_TILED_ONE(false, true) : VFISR_TILED_ONE(false, false);
#undef VFISR_TILED_ONE
}

template <bool kGrad>
cudaError_t warp_typed(const Tiled& p, const Plan& q, int dev, int img_bf16, int flow_bf16,
                       int bf16_window, int constant, const void* img, const void* flow,
                       const float* t, const int* origin, const void* ct, void* out, float* cg,
                       void* grad_flow, cudaStream_t s) {
  using bf16 = __nv_bfloat16;
  if (img_bf16)
    return flow_bf16 ? launch_modes<bf16, bf16, kGrad>(p, q, dev, bf16_window, constant, img,
                                                       flow, t, origin, ct, out, cg, grad_flow, s)
                     : launch_modes<bf16, float, kGrad>(p, q, dev, bf16_window, constant, img,
                                                        flow, t, origin, ct, out, cg, grad_flow, s);
  return flow_bf16 ? launch_modes<float, bf16, kGrad>(p, q, dev, bf16_window, constant, img, flow,
                                                      t, origin, ct, out, cg, grad_flow, s)
                   : launch_modes<float, float, kGrad>(p, q, dev, bf16_window, constant, img,
                                                       flow, t, origin, ct, out, cg, grad_flow, s);
}

}  // namespace

// The window origins at tile (th, tw) as the kernels compute them: by
// tile_origin where a tile has at most kFuseCells cells (the fused
// prologue's function), else by the origins pass: origin [n, ceil(h/th),
// ceil(w/tw), 2] int32 (oy, ox), canvas coordinates; cells: f32 scratch of
// [n, ceil(h/th), ceil(w/tw), (th/g) * (tw/g), 2] (g: the largest power of
// two dividing th and tw). flow: [n, h, w, 2] f32 or bf16 (flow_bf16); t:
// [n] f32 read as t[i * t_stride], or null for t_scalar; bf16_window: the
// window dtype (its row origin rounded down to even); (ry, rx): residual
// radii; (pt, pl): the content origin in the canvas for this tile. Returns
// the cudaError_t of the launches.
extern "C" int warp_tiled_origins_launch(const void* flow, const void* t, float t_scalar,
                                         int t_stride, void* cells, void* origin, int n, int h,
                                         int w, int flow_bf16, int bf16_window, int th, int tw,
                                         int ry, int rx, int pt, int pl, void* stream) {
  Tiled p;
  if (!make_tiled(p, n, h, w, 2, th, tw, ry, rx, pt, pl, t_scalar, t_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(cells) % 8 ||
      reinterpret_cast<uintptr_t>(flow) % (flow_bf16 ? 4 : 8))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(kernel_origins_typed(
      p, flow_bf16, bf16_window, flow, static_cast<const float*>(t),
      static_cast<float2*>(cells), static_cast<int*>(origin), static_cast<cudaStream_t>(stream)));
}

// K1 (grad = 0) or K2 (grad = 1) at tile (th, tw). img: [n, h, w, c] f32 or
// bf16 (img_bf16); K1 writes out (img's shape and type); K2 reads ct (img's
// shape and type) and writes cg [n, h, w, 2] f32 and grad_flow (flow's
// shape and type), both as pairs. cells, origin: the origins pass's
// scratch (as warp_tiled_origins_launch's) where the plan is not fused
// (warp_tiled_plan), which this call fills first; else unused (may be
// null).
// nsh_y, nsh_x: taps per axis; the clip bounds and residual clamps as
// ops/cuda/warp.py::_geometry gives them for this tile. All contiguous, all
// on the device of `stream`. Returns the cudaError_t of the launches.
extern "C" int warp_tiled_launch(const void* img, const void* flow, const void* t, float t_scalar,
                                 int t_stride, void* cells, void* origin, const void* ct,
                                 void* out, void* cg,
                                 void* grad_flow, int n, int h, int w, int c, int img_bf16,
                                 int flow_bf16, int bf16_window, int constant, int grad, int th,
                                 int tw, int ry, int rx, int pt, int pl, int nsh_y, int nsh_x,
                                 float ylo, float yhi, float xlo, float xhi, float ry_max,
                                 float rx_max, void* stream) {
  Tiled p;
  if (!make_tiled(p, n, h, w, c, th, tw, ry, rx, pt, pl, t_scalar, t_stride))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grad && (ct == nullptr || grad_flow == nullptr || cg == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(flow) % (flow_bf16 ? 4 : 8))
    return static_cast<int>(cudaErrorMisalignedAddress);  // flow is read as pixel pairs
  if (grad && (reinterpret_cast<uintptr_t>(cg) % 8 ||
               reinterpret_cast<uintptr_t>(grad_flow) % (flow_bf16 ? 4 : 8)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  p.nsh_y = nsh_y, p.nsh_x = nsh_x;
  p.ylo = ylo, p.yhi = yhi, p.xlo = xlo, p.xhi = xhi;
  p.ry_max = ry_max, p.rx_max = rx_max;
  Plan q;
  int dev = 0;
  cudaError_t err = device_plan(q, &dev, n, h, w, c, img_bf16 ? 2 : 4, th, tw, nsh_y, nsh_x,
                                grad != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte group copies need 16-byte aligned tensors (a view may not be)
  if (q.chunked && ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(ct)) % 16))
    q.vec16 = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(t);
  int* o = static_cast<int*>(origin);
  if (!q.fused) {
    if (o == nullptr || cells == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(cells) % 8)
      return static_cast<int>(cudaErrorMisalignedAddress);
    err = origins_typed(p, flow_bf16, bf16_window, flow, tp, static_cast<float2*>(cells), o, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* g = static_cast<float*>(cg);
  err = grad ? warp_typed<true>(p, q, dev, img_bf16, flow_bf16, bf16_window, constant, img, flow,
                                tp, o, ct, out, g, grad_flow, s)
             : warp_typed<false>(p, q, dev, img_bf16, flow_bf16, bf16_window, constant, img, flow,
                                 tp, o, ct, out, g, grad_flow, s);
  return static_cast<int>(err);
}

// The plan of a K1 (grad = 0) or K2 (grad = 1) launch on the current
// device (ops/cuda/warp.py::TILED_PLAN_FIELDS): out[0..13] = rows per slab,
// columns per band, bands and segments per tile, slabs per segment,
// chunked, channels per chunk (whole C: c), chunks, ring slots, ring rows,
// dynamic shared bytes, CTAs, CTAs per SM by shared memory, fused. Returns
// the cudaError_t of the plan (cudaErrorInvalidValue: the launch would be
// refused).
extern "C" int warp_tiled_plan(int n, int h, int w, int c, int img_bf16, int th, int tw,
                               int nsh_y, int nsh_x, int grad, long long* out) {
  Plan q;
  int dev = 0;
  const int b = img_bf16 ? 2 : 4;
  const cudaError_t err = device_plan(q, &dev, n, h, w, c, b, th, tw, nsh_y, nsh_x, grad != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas =
      static_cast<long long>(n) * cdiv(h, th) * q.segs * static_cast<long long>(cdiv(w, tw)) *
      q.bands;
  const int chunk = q.chunked ? q.cvec * (16 / b) : c;
  const long long v[14] = {q.rows,   q.cols,  q.bands,  q.segs,  q.slabs,
                           q.chunked, chunk < c ? chunk : c, q.chunks, q.slots, q.qrows,
                           q.smem,   ctas,    kSmemSm / (q.smem + kSmemStatic + 1024), q.fused};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}
