// Exact z-buffer rasterizer for Hopper (sm_90a).
//
// Replaces: carla_imitation_learning_tpu/ops/raster.py `_raster_kernel`
// (Pallas TPU kernel, reached through `_rasterize_core` by
// `rasterize_pallas` and `rasterize_pallas_luma`), both its flat variant and
// its textured one (`textures=True`, ops/raster.py:151-166).
//
// What it computes, per env and per band of `tile_rows` image rows: for every
// triangle on the band's nearest-first list (17 coefficients: 9 edge,
// 3 depth numerator, 3 colour, class, zmin), the edge values
// e_i = (a*px + b*py) + c; a pixel is inside when all three are > 0 or all
// three are < 0; depth z = znum(p) / den with den = (e0 + e1) + e2
// (0 → 1e-9) is an exact divide; the triangle is written where
// near < z < zbuf (first writer wins on ties, in list order). Outputs:
// class, 1 or 3 colour planes, depth (`far` where nothing was hit). Sky and
// distance shade are applied outside.
//
// Textured variant (TEXTURED=true, 23 rows: + 3 unum + 3 vnum): at the
// written triangle, u = unum(p) / den and v = vnum(p) / den, and each
// colour is multiplied by texture_factor(u, v, class) — ops/texture.py
// repeated operation for operation, with floorf and the accurate sinf (no
// fast math).
//
// What bounds it on this card: instruction issue in the pass loop (128
// lane-instructions per clock per SM), the latency of the list gathers, and
// the output stores (12-20 bytes per pixel). Its table bytes are 68 per
// listed triangle (92 textured), far below. The TPU kernel evaluates every
// listed triangle on every pixel of the band with a full-precision divide,
// and the texture (two more divides, a hash with a sinf) on every write,
// overdraw included.
//
// Design, one answer per cost:
// - Depth only where covered: the depth numerator and the divide run under
//   the inside predicate. A pair that is not inside never writes, so the
//   result is unchanged. (ptxas predicates these blocks rather than
//   branching around them, so within a walked entry they still issue; the
//   cull below is what keeps them off most pairs.)
// - Warp-tile culling: each warp owns a 16 x 16 pixel tile and, before the
//   pass, tests every staged entry against it (lanes over entries, ballot
//   and popc compact the surviving list positions, in list order, into a
//   per-warp list in shared memory); the pass walks only those, so the
//   first-writer-wins order is kept. Per edge, the test evaluates the pass's
//   own expression at the tile's extreme pixel centres: the largest value
//   at (last column if a > 0 else first, last row if b > 0 else first), the
//   smallest at the opposite corner. An entry is kept when every edge's
//   largest value is > 0 (a pixel could be inside with all edges positive)
//   or every edge's smallest value is < 0 (both windings). No margin is
//   needed: every operation of the expression is a rounded product or sum
//   and round-to-nearest is monotone, so the evaluated edge is monotone in
//   px (direction of a) and in py (direction of b) over the pixel centres,
//   and those corners hold its extremes over the tile exactly. A NaN edge
//   fails both tests, as it fails both in the pass.
// - Deferred colour and texture: the pass keeps only the z-buffer and the
//   winner's list position (the first strict minimum, in list order) per
//   pixel. The epilogue computes class, colour and, textured, den, u, v and
//   texture_factor once per pixel from the winner's coefficients, by the
//   same expressions at the same pixel: the same bits as writing them at
//   every pass, with no texture work per overdraw and no colour registers.
// - Register micro-tile: a thread owns 4 columns x 2 rows, so a*px is
//   computed once per column and b*py once per row, per entry.
// - Staging: a persistent grid (blocks = resident blocks per SM x SMs) walks
//   items of 128 x 16 pixels of one band of one env (8 warp tiles); the list
//   is staged in chunks of kChunk entries into double-buffered shared memory
//   with cp.async, each list index read once by the thread that stages its
//   entry, with no division; the next chunk (or the next item's first chunk)
//   is in flight while the current one is culled and walked. The epilogue
//   reads the winner from the last chunk in shared memory, or from the
//   table when it lies in an earlier chunk. The block's barrier per chunk
//   waits for its busiest warp, so blocks are small: 8 warps, 4 per SM.
// - Output: a thread stores its 4 adjacent columns of a row as one 16-byte
//   store per plane, so each warp store writes whole 32-byte sectors.
// - Occupancy: 256 threads a block, at most 64 registers a thread
//   (__launch_bounds__(256, 4)): four blocks, 32 warps, per SM.
// Rounding is pinned (__fmul_rn/__fadd_rn/__fdiv_rn) so the kernel equals
// its plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kFlatWidth = 17;
constexpr int kTexWidth = 23;
constexpr int kChunk = 128;      // list entries per staged chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockX = 128, kBlockY = 16;   // pixels an item covers
constexpr int kWarpX = 16, kWarpY = 16;      // a warp's tile
constexpr int kCols = 4, kRows = 2;          // a thread's micro-tile
static_assert(kCols == 4, "the epilogue stores a thread's columns as one 16-byte vector");
constexpr int kSemRoad = 2, kSemTerrain = 1, kSemBuilding = 3;

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

// fract(sin(cu*a + cv*b) * s) on the freq-spaced cell grid (ops/texture.py
// `_cell_noise`).
__device__ __forceinline__ float cell_noise(float u, float v, float freq) {
  const float cu = floorf(__fmul_rn(u, freq));
  const float cv = floorf(__fmul_rn(v, freq));
  const float h = __fmul_rn(
      sinf(__fadd_rn(__fmul_rn(cu, 12.9898f), __fmul_rn(cv, 78.233f))), 43758.5453f);
  return __fsub_rn(h, floorf(h));
}

// ops/texture.py `texture_factor` for one pixel.
__device__ __forceinline__ float texture_factor(float u, float v, int cls) {
  if (cls == kSemBuilding) {
    const float wx = __fsub_rn(__fmul_rn(u, 0.7f), floorf(__fmul_rn(u, 0.7f)));
    const float wy = __fsub_rn(__fmul_rn(v, 0.4f), floorf(__fmul_rn(v, 0.4f)));
    const bool window = wx > 0.2f && wx < 0.8f && wy > 0.25f && wy < 0.75f;
    return window ? 0.55f : 1.05f;
  }
  if (cls == kSemRoad) return __fadd_rn(0.88f, __fmul_rn(0.24f, cell_noise(u, v, 2.0f)));
  if (cls == kSemTerrain) return __fadd_rn(0.92f, __fmul_rn(0.16f, cell_noise(u, v, 0.5f)));
  return 1.0f;
}

// (a*px + b*py) + c, the kernel's edge and interpolation expression.
__device__ __forceinline__ float affine(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// Store a thread's kCols adjacent values of one row: one 16-byte store when
// rows are 16-byte aligned (W a multiple of 4; columns past W are whole
// groups then), else column by column up to W.
template <typename V, typename V4>
__device__ __forceinline__ void store_row(V* dst, const V (&v)[4], int x, int W) {
  if ((W & 3) == 0) {
    if (x < W) *reinterpret_cast<V4*>(dst) = V4{v[0], v[1], v[2], v[3]};
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j < W) dst[j] = v[j];
  }
}

struct Item {
  int b, r, x0, y0;   // env, band, first column, first row within the band
  int cnt;            // listed entries
};

struct Params {
  const float* tbl;
  const int* idx;
  const int* count;
  int* sem;
  float* col;
  float* depth;
  int T, R, K, H, W, tile_rows, n_xs, n_ys, n_items;
  float near_z, far_z;
};

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
  it.cnt = min(p.count[it.b * p.R + it.r], p.K);
  return it;
}

template <bool TEXTURED>
struct Layout {
  static constexpr int kWidth = TEXTURED ? kTexWidth : kFlatWidth;
  static constexpr int kStride = (kWidth + 3) / 4 * 4;   // 16-byte aligned entries
};

// Issue the cp.async copies of list positions [base, base + n) of `it`
// into `dst` (entry-major, kStride floats an entry), one commit group.
template <bool TEXTURED>
__device__ __forceinline__ void stage(const Params& p, const Item& it, int base,
                                      float* dst) {
  using L = Layout<TEXTURED>;
  const int n = min(kChunk, it.cnt - base);
  const float* env_tbl = p.tbl + static_cast<size_t>(it.b) * L::kWidth * p.T;
  const int* list = p.idx + (static_cast<size_t>(it.b) * p.R + it.r) * p.K + base;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const float* src = env_tbl + __ldg(list + e);
    float* d = dst + e * L::kStride;
#pragma unroll
    for (int c = 0; c < L::kWidth; ++c) cp_async4(d + c, src + static_cast<size_t>(c) * p.T);
  }
  cp_async_commit();
}

template <int C, bool TEXTURED>
__global__ void __launch_bounds__(kThreads, 4) exact_band_kernel(const Params p) {
  using L = Layout<TEXTURED>;
  __shared__ __align__(16) float s_tbl[2][kChunk * L::kStride];
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
  stage<TEXTURED>(p, cur, 0, s_tbl[0]);
  int buf = 0;

  while (true) {
    // this thread's pixel centres and the warp tile's extreme ones
    const float y0 = static_cast<float>(cur.r * p.tile_rows);
    float px[kCols], py[kRows];
#pragma unroll
    for (int j = 0; j < kCols; ++j) px[j] = __fadd_rn(static_cast<float>(cur.x0 + tx + j), 0.5f);
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      py[k] = __fadd_rn(__fadd_rn(y0, static_cast<float>(cur.y0 + ty + k)), 0.5f);
    const int cx0 = cur.x0 + wx, cy0 = cur.y0 + wy;
    const bool warp_live = cx0 < p.W && cy0 < p.tile_rows;
    const float cx_lo = __fadd_rn(static_cast<float>(cx0), 0.5f);
    const float cx_hi = __fadd_rn(static_cast<float>(min(cx0 + kWarpX, p.W) - 1), 0.5f);
    const float cy_lo = __fadd_rn(__fadd_rn(y0, static_cast<float>(cy0)), 0.5f);
    const float cy_hi = __fadd_rn(
        __fadd_rn(y0, static_cast<float>(min(cy0 + kWarpY, p.tile_rows) - 1)), 0.5f);

    float zbuf[kRows][kCols];
    int win[kRows][kCols];   // list position of the written triangle, -1 = none
#pragma unroll
    for (int k = 0; k < kRows; ++k)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        zbuf[k][j] = p.far_z;
        win[k][j] = -1;
      }

    const int next_item = item + gridDim.x;
    Item next = cur;
    int last_base = 0, last_buf = 0;
    for (int base = 0;; base += kChunk) {
      const int n = max(0, min(kChunk, cur.cnt - base));
      cp_async_wait_all();
      __syncthreads();   // chunk `buf` visible; everyone is done with buf ^ 1
      const bool more = base + kChunk < cur.cnt;
      if (more) {
        stage<TEXTURED>(p, cur, base + kChunk, s_tbl[buf ^ 1]);
      } else if (next_item < p.n_items) {
        next = decode(p, next_item);
        stage<TEXTURED>(p, next, 0, s_tbl[buf ^ 1]);
      }
      const float* tb = s_tbl[buf];

      // warp-tile cull: surviving positions of this chunk, in list order
      int wcount = 0;
      for (int e0 = 0; e0 < n; e0 += 32) {
        const int e = e0 + lane;
        bool keep = false;
        if (warp_live && e < n) {
          const float* co = tb + e * L::kStride;
          bool pos = true, neg = true;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float a = co[3 * i], bb = co[3 * i + 1], c = co[3 * i + 2];
            const bool ax = a > 0.0f, by = bb > 0.0f;
            const float emax = affine(a, bb, c, ax ? cx_hi : cx_lo, by ? cy_hi : cy_lo);
            const float emin = affine(a, bb, c, ax ? cx_lo : cx_hi, by ? cy_lo : cy_hi);
            pos = pos && emax > 0.0f;
            neg = neg && emin < 0.0f;
          }
          keep = pos || neg;
        }
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        if (keep) s_wlist[warp][wcount + __popc(m & ((1u << lane) - 1u))] = static_cast<unsigned char>(e);
        wcount += __popc(m);
      }
      __syncwarp();

      for (int q = 0; q < wcount; ++q) {
        const int e = s_wlist[warp][q];
        const float4* co = reinterpret_cast<const float4*>(tb + e * L::kStride);
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
          by0[k] = __fmul_rn(r0.y, py[k]);
          by1[k] = __fmul_rn(r1.x, py[k]);
          by2[k] = __fmul_rn(r1.w, py[k]);
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const float e0 = __fadd_rn(__fadd_rn(ax0[j], by0[k]), r0.z);
            const float e1 = __fadd_rn(__fadd_rn(ax1[j], by1[k]), r1.y);
            const float e2 = __fadd_rn(__fadd_rn(ax2[j], by2[k]), r2.x);
            if ((e0 > 0.0f && e1 > 0.0f && e2 > 0.0f) ||
                (e0 < 0.0f && e1 < 0.0f && e2 < 0.0f)) {
              float den = __fadd_rn(__fadd_rn(e0, e1), e2);
              den = (den == 0.0f) ? 1e-9f : den;
              const float z = __fdiv_rn(affine(r2.y, r2.z, r2.w, px[j], py[k]), den);
              if (z > p.near_z && z < zbuf[k][j]) {
                zbuf[k][j] = z;
                win[k][j] = base + e;
              }
            }
          }
        }
      }
      last_base = base;
      last_buf = buf;
      buf ^= 1;
      if (!more) break;
    }

    // epilogue: class, colour and texture of each pixel's winner, a row at a
    // time
    const float* env_tbl = p.tbl + static_cast<size_t>(cur.b) * L::kWidth * p.T;
    const int* list = p.idx + (static_cast<size_t>(cur.b) * p.R + cur.r) * p.K;
    const size_t plane = static_cast<size_t>(p.H) * p.W;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int row = cur.y0 + ty + k;
      if (row >= p.tile_rows) continue;
      int cls[kCols];
      float colour[C][kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        cls[j] = 0;
#pragma unroll
        for (int c = 0; c < C; ++c) colour[c][j] = 0.0f;
        const int w = win[k][j];
        if (w >= 0) {
          // coefficient c of the winner is wp[c * ws]
          const float* wp;
          size_t ws;
          if (w >= last_base) {
            wp = s_tbl[last_buf] + (w - last_base) * L::kStride;
            ws = 1;
          } else {
            wp = env_tbl + list[w];
            ws = p.T;
          }
          cls[j] = static_cast<int>(wp[15 * ws]);
          float fac = 1.0f;
          if constexpr (TEXTURED) {
            const float e0 = affine(wp[0], wp[ws], wp[2 * ws], px[j], py[k]);
            const float e1 = affine(wp[3 * ws], wp[4 * ws], wp[5 * ws], px[j], py[k]);
            const float e2 = affine(wp[6 * ws], wp[7 * ws], wp[8 * ws], px[j], py[k]);
            float den = __fadd_rn(__fadd_rn(e0, e1), e2);
            den = (den == 0.0f) ? 1e-9f : den;
            const float u = __fdiv_rn(affine(wp[17 * ws], wp[18 * ws], wp[19 * ws], px[j], py[k]), den);
            const float v = __fdiv_rn(affine(wp[20 * ws], wp[21 * ws], wp[22 * ws], px[j], py[k]), den);
            fac = texture_factor(u, v, cls[j]);
          }
#pragma unroll
          for (int c = 0; c < C; ++c) {
            colour[c][j] = TEXTURED ? __fmul_rn(wp[(12 + c) * ws], fac) : wp[(12 + c) * ws];
          }
        }
      }
      const int x = cur.x0 + tx;
      const size_t pix = static_cast<size_t>(cur.r * p.tile_rows + row) * p.W + x;
      store_row<int, int4>(p.sem + cur.b * plane + pix, cls, x, p.W);
      store_row<float, float4>(p.depth + cur.b * plane + pix, zbuf[k], x, p.W);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        store_row<float, float4>(p.col + (static_cast<size_t>(cur.b) * C + c) * plane + pix,
                                 colour[c], x, p.W);
      }
    }

    item = next_item;
    if (item >= p.n_items) break;
    cur = next;
  }
}

template <int C, bool TEXTURED>
int grid_size(int n_items) {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exact_band_kernel<C, TEXTURED>,
                                                  kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n_items < blocks ? n_items : blocks;
}

template <int C, bool TEXTURED>
void launch(const Params& p, cudaStream_t s) {
  exact_band_kernel<C, TEXTURED><<<grid_size<C, TEXTURED>(p.n_items), kThreads, 0, s>>>(p);
}

template <int C, bool TEXTURED>
int info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, exact_band_kernel<C, TEXTURED>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, exact_band_kernel<C, TEXTURED>,
                                                      kThreads, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kThreads;
  out[4] = per_sm;
  return static_cast<int>(err);
}

}  // namespace

extern "C" int raster_exact_launch(
    const float* tbl, const int* idx, const int* count, int* sem, float* col,
    float* depth, int B, int T, int R, int K, int H, int W, int tile_rows,
    int n_channels, int textured, float near_z, float far_z, void* stream) {
  Params p{tbl, idx, count, sem, col, depth, T, R, K, H, W, tile_rows,
           (W + kBlockX - 1) / kBlockX, (tile_rows + kBlockY - 1) / kBlockY, 0,
           near_z, far_z};
  p.n_items = p.n_xs * p.n_ys * R * B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_channels != 1 && n_channels != 3) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n_items == 0) return 0;
  if (n_channels == 1 && !textured) {
    launch<1, false>(p, s);
  } else if (n_channels == 3 && !textured) {
    launch<3, false>(p, s);
  } else if (n_channels == 1) {
    launch<1, true>(p, s);
  } else {
    launch<3, true>(p, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch facts for reports, per variant (n_channels, textured): registers and
// local (spill) bytes a thread, static shared memory a block, threads a block
// and resident blocks per SM.
extern "C" int raster_exact_info(int n_channels, int textured, int* out) {
  if (n_channels == 1 && !textured) return info<1, false>(out);
  if (n_channels == 3 && !textured) return info<3, false>(out);
  if (n_channels == 1) return info<1, true>(out);
  if (n_channels == 3) return info<3, true>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
