// Grayscale rollout rasterizer for Hopper (sm_90a): the kernel every step of
// a closed-loop fleet rollout runs.
//
// Replaces: carla_imitation_learning_tpu/ops/raster_fast.py `_fast_kernel`
// (Pallas TPU kernel, reached through `rasterize_luma_fast` with
// quads=False, vec=False).
//
// What it computes, per env and per band of `tile_rows` image rows: for every
// triangle on the band's list (13 coefficients: 9 edge, 3 depth numerator,
// 1 quantized luma), the three edge rows and the depth numerator in rank-1
// form a*px + (b*py + c); a pixel is inside when e0, e1 and e2 are all > 0;
// depth z = znum * rcp(e0 + e1 + e2), accepted when z > near; visibility is a
// running MIN of the int32 key (bits(z) & ~0xFFF) | luma12. The epilogue
// decodes hit pixels (key < far_key) to luma / (1 + 0.004 z), misses to the
// sky gradient, and applies exponential fog when fog_density > 0.
// Like the TPU kernel, the list is walked two entries at a time, so an odd
// count also evaluates the next list entry (a non-hit or padding triangle).
// Bands may share a coarser list: with `list_factor` f, render band r reads
// list row r / f (the TPU kernel's `list_band_factor`); the pixels, the
// warp-tile cull and the epilogue stay those of band r.
//
// What bounds it on this card: instruction issue in the pass loop (128
// lane-instructions per clock per SM) and the latency of the list gathers.
// Its bytes are 52 per listed triangle and 4 per pixel, far below. The TPU
// kernel evaluates every listed triangle on every pixel of the band, with a
// depth reciprocal each.
//
// Design, one answer per cost:
// - Depth only where covered: a thread first tests its 8 pixels; the depth
//   numerator, the reciprocal and the key run only when one of them is
//   inside (a branch the warp skips when no lane has a covered pixel), and a
//   key is taken only where its pixel is inside. A pair that is not inside
//   never lowers the key, so the result is unchanged.
// - Warp-tile culling: each warp owns a 16 x 16 pixel tile and, before the
//   pass, tests every staged entry against it (lanes over entries, ballot
//   and popc compact the surviving list positions, in list order, into a
//   per-warp list in shared memory); the pass walks only those. The test
//   evaluates each edge at the tile's extreme pixel centre, (last column if
//   a > 0 else first, last row if b > 0 else first), with the pass's own
//   expression and rounding, and drops the entry when one edge is not > 0
//   there. No margin is needed: every operation of the expression is a
//   rounded product or sum, and round-to-nearest is monotone, so the
//   evaluated edge is monotone in px (direction of a) and in py (direction
//   of b) over the pixel centres, and its largest value over the tile is the
//   one at that corner. If it is not > 0 (NaN included), no pixel of the
//   tile has that edge > 0 and the entry cannot lower a key there.
// - Register micro-tile: a thread owns 4 columns x 2 rows, so a*px is
//   computed once per column and b*py + c once per row, per entry; a pixel
//   costs 3 adds and the inside test.
// - Staging: a persistent grid (blocks = resident blocks per SM x SMs) walks
//   items of 64 x 16 pixels of one band of one env (4 warp tiles); the list
//   is staged in chunks of kChunk entries into double-buffered shared memory
//   with cp.async, each list index read once by the thread that stages its
//   entry, with no division; the next chunk (or the next item's first chunk)
//   is in flight while the current one is culled and walked. Entries are 16
//   floats apart, so the pass reads them with three 16-byte shared loads.
//   The block's barrier per chunk waits for its busiest warp, so blocks are
//   small: 4 warps, 8 blocks per SM.
// - Output: a thread stores its 4 adjacent columns of a row as one 16-byte
//   store, so each warp store writes whole 32-byte sectors.
// - Occupancy: 128 threads a block, at most 64 registers a thread
//   (__launch_bounds__(128, 8)): eight blocks, 32 warps, per SM.
// Rounding is pinned with __fmul_rn/__fadd_rn and the IEEE reciprocal
// __frcp_rn (the TPU kernel's approximate reciprocal is not reproduced), so
// the kernel equals its plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kPackWidth = 13;
constexpr int kStride = 16;      // floats per staged entry (16-byte aligned)
constexpr int kChunk = 128;      // list entries per staged chunk
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockX = 64, kBlockY = 16;   // pixels an item covers
constexpr int kWarpX = 16, kWarpY = 16;      // a warp's tile
constexpr int kCols = 4, kRows = 2;          // a thread's micro-tile
static_assert(kCols == 4, "the epilogue stores a thread's columns as one float4");
constexpr int kLumaMask = 0xFFF;
constexpr int kKeyMask = ~0xFFF;
constexpr int kMissKey = 0x7FFFFFFF;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Store a thread's kCols adjacent values of one row: one 16-byte store when
// rows are 16-byte aligned (W a multiple of 4; columns past W are whole
// groups then), else column by column up to W.
__device__ __forceinline__ void store_row(float* dst, const float (&v)[4], int x, int W) {
  if ((W & 3) == 0) {
    if (x < W) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j < W) dst[j] = v[j];
  }
}

struct Item {
  int b, r, x0, y0;   // env, band, first column, first row within the band
  int n_pass;         // list positions to walk (count rounded up to a pair)
};

struct Params {
  const float* tbl;
  const int* idx;
  const int* count;
  float* out;
  int T, R, K, H, W, tile_rows, n_xs, n_ys, n_items;
  float near_z;
  int far_key;
  float sky_top, sky_hor, t_scale, luma_scale, fog_density;
  int list_factor;    // render bands a list row serves
};

// The list row of band `r` of env `b`: lists cover list_factor bands each.
__device__ __forceinline__ size_t list_row(const Params& p, int b, int r) {
  return static_cast<size_t>(b) * (p.R / p.list_factor) + r / p.list_factor;
}

__device__ __forceinline__ Item decode(const Params& p, int item) {
  Item it;
  const int xs = item % p.n_xs;
  int rest = item / p.n_xs;
  const int ys = rest % p.n_ys;
  rest /= p.n_ys;
  it.r = rest % p.R;
  it.b = rest / p.R;
  it.x0 = xs * kBlockX;
  it.y0 = ys * kBlockY;
  const int cnt = p.count[list_row(p, it.b, it.r)];
  it.n_pass = min((cnt + 1) / 2 * 2, p.K);
  return it;
}

// Issue the cp.async copies of list positions [base, base + n) of `it`
// into `dst` (entry-major, kStride floats an entry), one commit group.
__device__ __forceinline__ void stage(const Params& p, const Item& it, int base,
                                      float* dst) {
  const int n = min(kChunk, it.n_pass - base);
  const float* env_tbl = p.tbl + static_cast<size_t>(it.b) * kPackWidth * p.T;
  const int* list = p.idx + list_row(p, it.b, it.r) * p.K + base;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float* src = env_tbl + __ldg(list + e);
    float* d = dst + e * kStride;
#pragma unroll
    for (int c = 0; c < kPackWidth; ++c) cp_async4(d + c, src + static_cast<size_t>(c) * p.T);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 8) fast_band_kernel(const Params p) {
  __shared__ __align__(16) float s_tbl[2][kChunk * kStride];
  __shared__ unsigned char s_wlist[kWarps][kChunk];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wx = (warp % (kBlockX / kWarpX)) * kWarpX;   // warp tile origin
  const int wy = (warp / (kBlockX / kWarpX)) * kWarpY;
  const int tx = wx + (lane % (kWarpX / kCols)) * kCols;  // thread micro-tile origin
  const int ty = wy + (lane / (kWarpX / kCols)) * kRows;

  int item = blockIdx.x;
  if (item >= p.n_items) return;
  Item cur = decode(p, item);
  stage(p, cur, 0, s_tbl[0]);
  int buf = 0;

  while (true) {
    // this thread's pixel centres and the warp tile's extreme ones
    const float y_off = __fadd_rn(static_cast<float>(cur.r * p.tile_rows), 0.5f);
    float px[kCols], py[kRows];
#pragma unroll
    for (int j = 0; j < kCols; ++j) px[j] = __fadd_rn(static_cast<float>(cur.x0 + tx + j), 0.5f);
#pragma unroll
    for (int k = 0; k < kRows; ++k) py[k] = __fadd_rn(static_cast<float>(cur.y0 + ty + k), y_off);
    const int cx0 = cur.x0 + wx, cy0 = cur.y0 + wy;
    const bool warp_live = cx0 < p.W && cy0 < p.tile_rows;
    const float cx_lo = __fadd_rn(static_cast<float>(cx0), 0.5f);
    const float cx_hi = __fadd_rn(static_cast<float>(min(cx0 + kWarpX, p.W) - 1), 0.5f);
    const float cy_lo = __fadd_rn(static_cast<float>(cy0), y_off);
    const float cy_hi = __fadd_rn(static_cast<float>(min(cy0 + kWarpY, p.tile_rows) - 1), y_off);

    int kmin[kRows][kCols];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int j = 0; j < kCols; ++j) kmin[k][j] = kMissKey;

    const int next_item = item + gridDim.x;
    Item next = cur;
    for (int base = 0;; base += kChunk) {
      const int n = max(0, min(kChunk, cur.n_pass - base));
      cp_async_wait_all();
      __syncthreads();   // chunk `buf` visible; everyone is done with buf ^ 1
      const bool more = base + kChunk < cur.n_pass;
      if (more) {
        stage(p, cur, base + kChunk, s_tbl[buf ^ 1]);
      } else if (next_item < p.n_items) {
        next = decode(p, next_item);
        stage(p, next, 0, s_tbl[buf ^ 1]);
      }
      const float* tb = s_tbl[buf];

      // warp-tile cull: surviving positions of this chunk, in list order
      int wcount = 0;
      for (int e0 = 0; e0 < n; e0 += 32) {
        const int e = e0 + lane;
        bool keep = false;
        if (warp_live && e < n) {
          const float* co = tb + e * kStride;
          keep = true;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float a = co[3 * i], bb = co[3 * i + 1], c = co[3 * i + 2];
            const float x = a > 0.0f ? cx_hi : cx_lo;
            const float y = bb > 0.0f ? cy_hi : cy_lo;
            const float emax = __fadd_rn(__fmul_rn(a, x), __fadd_rn(__fmul_rn(bb, y), c));
            keep = keep && emax > 0.0f;
          }
        }
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        if (keep) s_wlist[warp][wcount + __popc(m & ((1u << lane) - 1u))] = static_cast<unsigned char>(e);
        wcount += __popc(m);
      }
      __syncwarp();

      for (int q = 0; q < wcount; ++q) {
        const float* ce = tb + s_wlist[warp][q] * kStride;
        const float4* co = reinterpret_cast<const float4*>(ce);
        const float4 r0 = co[0], r1 = co[1], r2 = co[2];
        // r0 = (a0 b0 c0 a1), r1 = (b1 c1 a2 b2), r2 = (c2 az bz cz)
        float ax0[kCols], ax1[kCols], ax2[kCols], by0[kRows], by1[kRows], by2[kRows];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          ax0[j] = __fmul_rn(r0.x, px[j]);
          ax1[j] = __fmul_rn(r0.w, px[j]);
          ax2[j] = __fmul_rn(r1.z, px[j]);
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          by0[k] = __fadd_rn(__fmul_rn(r0.y, py[k]), r0.z);
          by1[k] = __fadd_rn(__fmul_rn(r1.x, py[k]), r1.y);
          by2[k] = __fadd_rn(__fmul_rn(r1.w, py[k]), r2.x);
        }
        unsigned inside = 0;
#pragma unroll
        for (int k = 0; k < kRows; ++k)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const bool in = __fadd_rn(ax0[j], by0[k]) > 0.0f && __fadd_rn(ax1[j], by1[k]) > 0.0f &&
                            __fadd_rn(ax2[j], by2[k]) > 0.0f;
            inside |= static_cast<unsigned>(in) << (k * kCols + j);
          }
        if (inside) {
          const int lum = static_cast<int>(ce[12]);
#pragma unroll
          for (int k = 0; k < kRows; ++k)
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              const float e0 = __fadd_rn(ax0[j], by0[k]);
              const float e1 = __fadd_rn(ax1[j], by1[k]);
              const float e2 = __fadd_rn(ax2[j], by2[k]);
              const float zn = __fadd_rn(__fmul_rn(r2.y, px[j]), __fadd_rn(__fmul_rn(r2.z, py[k]), r2.w));
              const float z = __fmul_rn(zn, __frcp_rn(__fadd_rn(__fadd_rn(e0, e1), e2)));
              const int key = (__float_as_int(z) & kKeyMask) | lum;
              const bool take = ((inside >> (k * kCols + j)) & 1u) && z > p.near_z;
              kmin[k][j] = take ? min(kmin[k][j], key) : kmin[k][j];
            }
        }
      }
      buf ^= 1;
      if (!more) break;
    }

    // epilogue: decode the keys of this thread's pixels, a row at a time
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int row = cur.y0 + ty + k;
      if (row < p.tile_rows) {
        const float t = __fmul_rn(__fsub_rn(py[k], 0.5f), p.t_scale);
        const float sky = __fadd_rn(__fmul_rn(p.sky_top, __fsub_rn(1.0f, t)),
                                    __fmul_rn(p.sky_hor, t));
        float v[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int key = kmin[k][j];
          const float depth = __int_as_float(key & kKeyMask);
          const float luma = __fmul_rn(static_cast<float>(key & kLumaMask), p.luma_scale);
          const float shade = __frcp_rn(__fadd_rn(1.0f, __fmul_rn(0.004f, depth)));
          float lit = __fmul_rn(luma, shade);
          if (p.fog_density > 0.0f) {
            const float f = expf(__fmul_rn(-p.fog_density, depth));
            lit = __fadd_rn(__fmul_rn(lit, f), __fmul_rn(sky, __fsub_rn(1.0f, f)));
          }
          v[j] = (key < p.far_key) ? lit : sky;
        }
        const int y = cur.r * p.tile_rows + row;
        const int x = cur.x0 + tx;
        store_row(p.out + (static_cast<size_t>(cur.b) * p.H + y) * p.W + x, v, x, p.W);
      }
    }

    item = next_item;
    if (item >= p.n_items) break;
    cur = next;
  }
}

int grid_size(int n_items) {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fast_band_kernel, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n_items < blocks ? n_items : blocks;
}

}  // namespace

extern "C" int raster_fast_launch(
    const float* tbl, const int* idx, const int* count, float* out,
    int B, int T, int R, int K, int H, int W, int tile_rows,
    float near_z, int far_key, float sky_top, float sky_hor, float t_scale,
    float luma_scale, float fog_density, int list_factor, void* stream) {
  Params p{tbl, idx, count, out, T, R, K, H, W, tile_rows,
           (W + kBlockX - 1) / kBlockX, (tile_rows + kBlockY - 1) / kBlockY, 0,
           near_z, far_key, sky_top, sky_hor, t_scale, luma_scale, fog_density,
           list_factor};
  p.n_items = p.n_xs * p.n_ys * R * B;
  if (p.n_items == 0) return 0;
  fast_band_kernel<<<grid_size(p.n_items), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts for reports: registers and local (spill) bytes a thread,
// static shared memory a block, threads a block and resident blocks per SM.
extern "C" int raster_fast_info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fast_band_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fast_band_kernel, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kThreads;
  out[4] = per_sm;
  return static_cast<int>(err);
}
