// Fused-quad grayscale rollout rasterizer for Hopper (sm_90a): kernel C.
//
// Replaces: carla_imitation_learning_tpu/ops/raster_fast.py `_prim_kernel`
// (Pallas TPU kernel, reached through `rasterize_luma_fast` with quads=True).
//
// What it computes, per env and per band of `tile_rows` image rows: for every
// primitive on the band's list (16 coefficients: 4 sign-normalized border
// rows, the screen-affine 1/z row, 1 quantized luma; a fused quad or a
// triangle with its first edge row repeated), the four border values and
// zi = 1/z in rank-1 form a*px + (b*py + c); a pixel counts when
// e0, e1, e2 and e3 are all > 0 and zi < 1/near; visibility is a running MAX
// of the int32 key (bits(zi) & ~0xFFF) | luma12, 0 meaning no hit (larger 1/z
// is nearer). There is no divide in the pass. The epilogue decodes hit pixels
// (key > far_key) to luma * zi * rcp(zi + 0.004), misses to the sky gradient,
// and with fog_density > 0 blends toward the sky at depth rcp(max(zi, 1e-9)).
// Like the TPU kernel, the list is walked two entries at a time, so positions
// below n_pass = min(ceil2(count), K) are evaluated: an odd count also
// evaluates the next list entry.
// Bands may share a coarser list: with `list_factor` f, render band r reads
// list row r / f (the TPU kernel's `list_band_factor`); the pixels, the
// warp-tile cull and the epilogue stay those of band r.
//
// What bounds it on this card: instruction issue in the pass and the latency
// of gathering a chunk of the coefficient-major (B, 16, P) table through the
// band's list and of waiting for it. Its bytes are 64 of table and 4 of list
// index per walked entry and 4 per pixel.
//
// Design, one answer per cost (kernel D's, csrc/raster_vec.cu, with its own
// staging, four borders and a max key):
// - Gathered staging on a ring of kStages stages with full and empty
//   mbarriers in place of a block barrier: the whole producer warp walks the
//   block's items and chunks in order, waits on a stage's empty barrier (one
//   arrival per consumer warp), and each lane reads the list index of its
//   entries once, with no division, and issues the entry's 16 4-byte
//   `cp.async` copies into one 64-byte shared row; each lane signals their
//   completion on the stage's full barrier with `cp.async.mbarrier.arrive
//   .noinc`, and lane 0 arrives once more after writing the stage's item,
//   entry count and first/last flags. A consumer warp waits only on the full
//   barrier of the chunk it needs, so a fast warp runs up to kStages chunks
//   ahead of a slow one. 4 stages of 64 entries, as in kernel D; an
//   entry-major copy of the table, staged with 16-byte copies, measured no
//   faster and its copy costs half the kernel.
// - Items (64 x 16 pixels of one band of one env, 4 warp tiles) handed out by
//   an atomic counter, so that bands of very different list lengths spread
//   over the blocks (a fixed assignment measured 1.5x slower). The counter
//   stays on the card between launches and the last producer to finish sets
//   it back to zero, as in kernel D.
// - Warp-tile culling on the four borders: each consumer warp tests each
//   staged entry at its 16 x 16 tile's extreme pixel centre with the pass's
//   own expression and rounding (exact, no margin: rounded products and sums
//   are monotone) and compacts the survivors' positions, in list order, by
//   ballot and popc; the pass walks only those.
// - Register micro-tile: a thread owns 4 columns x 2 rows, so a*px is
//   computed once per column and b*py + c once per row, per entry.
// - 1/z on every pixel, beside the border test: with no reciprocal to save,
//   a branch around it (kernel D's) costs more than it skips. The five
//   comparisons are joined with a bitwise & (a short-circuit && chain
//   measured 1.3x slower). Each border is compared on its own, so a NaN
//   border fails the test as it does in the plain version's
//   torch.minimum; fminf would drop it.
// - Output: a thread stores its 4 adjacent columns of a row as one 16-byte
//   store.
// - Occupancy: 4 consumer warps and 1 producer warp a block, at most 64
//   registers a thread (__launch_bounds__(160, kBlocksPerSm)).
// Rounding is pinned with __fmul_rn/__fadd_rn, and the IEEE reciprocal
// __frcp_rn stands where the TPU kernel takes pl.reciprocal(approx=True), so
// the kernel equals its plain PyTorch version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPackWidth = 16;   // coefficient rows of the table, floats per staged entry
constexpr int kStages = 4;       // ring depth
constexpr int kChunk = 64;       // list entries a stage holds
constexpr int kBlocksPerSm = 6;
static_assert(kChunk <= 256, "survivor positions are kept as bytes");
constexpr int kWarps = 4;                       // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;     // plus the producer warp
constexpr int kBlockX = 64, kBlockY = 16;       // pixels an item covers
constexpr int kWarpX = 16, kWarpY = 16;         // a consumer warp's tile
constexpr int kCols = 4, kRows = 2;             // a thread's micro-tile
static_assert(kCols == 4, "the epilogue stores a thread's columns as one float4");
constexpr int kLumaMask = 0xFFF;
constexpr int kKeyMask = ~0xFFF;

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem(bar)) : "memory");
}
// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem(bar)) : "memory");
}
// Wait until the phase of parity `parity` of `bar` has completed. A wait
// that outlasts 2^26 tries (seconds) means a lost arrival: the launch traps
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem(dst)), "l"(src) : "memory");
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

struct Params {
  const float* tbl;
  const int* idx;
  const int* count;
  float* out;
  int* queue;         // next item to hand out and producers done, 0 at launch
  int P, R, K, H, W, tile_rows, n_xs, n_ys, n_items;
  float inv_near;
  int far_key;
  float sky_top, sky_hor, t_scale, luma_scale, fog_density;
  int list_factor;    // render bands a list row serves
};

// The list row of item row `br` (env * R + band): lists cover list_factor
// bands each.
__device__ __forceinline__ size_t list_row(const Params& p, int br) {
  return static_cast<size_t>(br / p.R) * (p.R / p.list_factor) + (br % p.R) / p.list_factor;
}

struct Ring {
  float tbl[kStages][kChunk * kPackWidth];
  int4 meta[kStages];           // item (-1: no more), entries, first chunk, last chunk
  uint64_t full[kStages];       // 32 cp.async arrivals + lane 0's after the meta
  uint64_t empty[kStages];      // 1 arrival per consumer warp
  unsigned char wlist[kWarps][kChunk];
};

// Called once by each block's producer after it has taken its last item.
// The last of the grid's producers to finish leaves the counters at zero.
__device__ void release_queue(const Params& p) {
  __threadfence();
  if (atomicAdd(p.queue + 1, 1) == static_cast<int>(gridDim.x) - 1) {
    p.queue[0] = 0;
    p.queue[1] = 0;
  }
}

// The producer: the last warp. Walks items from the queue and their chunks
// in order, one ring stage per chunk (an empty item still takes one stage,
// with no entries, so that its consumers write its sky).
__device__ void produce(const Params& p, Ring& ring, int lane) {
  int item = 0, n_pass = 0, base = 0;
  const float* env_tbl = nullptr;
  const int* list = nullptr;
  bool need_item = true;
  for (unsigned g = 0;; ++g) {
    const int s = g % kStages;
    if (g >= kStages) mbar_wait(&ring.empty[s], (g / kStages + 1) & 1);
    const bool first = need_item;
    if (need_item) {
      item = __shfl_sync(0xffffffffu, lane == 0 ? atomicAdd(p.queue, 1) : 0, 0);
      if (item >= p.n_items) {
        if (lane == 0) ring.meta[s] = make_int4(-1, 0, 0, 0);
        mbar_arrive_cp_async(&ring.full[s]);
        if (lane == 0) {
          mbar_arrive(&ring.full[s]);
          release_queue(p);
        }
        return;
      }
      const int br = item / (p.n_xs * p.n_ys);   // env * R + band
      n_pass = min((__ldg(p.count + list_row(p, br)) + 1) / 2 * 2, p.K);
      env_tbl = p.tbl + static_cast<size_t>(br / p.R) * kPackWidth * p.P;
      list = p.idx + list_row(p, br) * p.K;
      base = 0;
      need_item = false;
    }
    const int n = min(kChunk, n_pass - base);
    need_item = base + n >= n_pass;
    float* dst = ring.tbl[s];
    for (int e = lane; e < n; e += 32) {
      const float* src = env_tbl + __ldg(list + base + e);
#pragma unroll
      for (int c = 0; c < kPackWidth; ++c)
        cp_async4(dst + e * kPackWidth + c, src + static_cast<size_t>(c) * p.P);
    }
    mbar_arrive_cp_async(&ring.full[s]);
    if (lane == 0) {
      ring.meta[s] = make_int4(item, n, first, need_item);
      mbar_arrive(&ring.full[s]);
    }
    base += n;
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) prim_band_kernel(const Params p) {
  __shared__ __align__(128) Ring ring;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 33);
      mbar_init(&ring.empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps) {
    produce(p, ring, lane);
    return;
  }

  const int wx = (warp % (kBlockX / kWarpX)) * kWarpX;    // warp tile origin
  const int wy = (warp / (kBlockX / kWarpX)) * kWarpY;
  const int tx = wx + (lane % (kWarpX / kCols)) * kCols;  // thread micro-tile origin
  const int ty = wy + (lane / (kWarpX / kCols)) * kRows;

  int b = 0, r = 0, x0 = 0, y0 = 0;
  float px[kCols], py[kRows];
  float cx_lo = 0.0f, cx_hi = 0.0f, cy_lo = 0.0f, cy_hi = 0.0f;
  bool warp_live = false;
  int kmax[kRows][kCols];

  for (unsigned g = 0;; ++g) {
    const int s = g % kStages;
    mbar_wait(&ring.full[s], (g / kStages) & 1);
    const int4 m = ring.meta[s];
    if (m.x < 0) break;
    const int n = m.y;
    if (m.z) {   // an item's first chunk: its pixel centres and warp-tile corners
      const int xs = m.x % p.n_xs;
      int rest = m.x / p.n_xs;
      y0 = (rest % p.n_ys) * kBlockY;
      rest /= p.n_ys;
      r = rest % p.R;
      b = rest / p.R;
      x0 = xs * kBlockX;
      const float y_off = __fadd_rn(static_cast<float>(r * p.tile_rows), 0.5f);
#pragma unroll
      for (int j = 0; j < kCols; ++j) px[j] = __fadd_rn(static_cast<float>(x0 + tx + j), 0.5f);
#pragma unroll
      for (int k = 0; k < kRows; ++k) py[k] = __fadd_rn(static_cast<float>(y0 + ty + k), y_off);
      const int cx0 = x0 + wx, cy0 = y0 + wy;
      warp_live = cx0 < p.W && cy0 < p.tile_rows;
      cx_lo = __fadd_rn(static_cast<float>(cx0), 0.5f);
      cx_hi = __fadd_rn(static_cast<float>(min(cx0 + kWarpX, p.W) - 1), 0.5f);
      cy_lo = __fadd_rn(static_cast<float>(cy0), y_off);
      cy_hi = __fadd_rn(static_cast<float>(min(cy0 + kWarpY, p.tile_rows) - 1), y_off);
#pragma unroll
      for (int k = 0; k < kRows; ++k)
#pragma unroll
        for (int j = 0; j < kCols; ++j) kmax[k][j] = 0;
    }
    const float* tb = ring.tbl[s];

    // warp-tile cull on the four borders: surviving positions, in list order
    int wcount = 0;
    for (int e0 = 0; e0 < n; e0 += 32) {
      const int e = e0 + lane;
      bool keep = false;
      if (warp_live && e < n) {
        const float4* co = reinterpret_cast<const float4*>(tb + e * kPackWidth);
        const float4 q0 = co[0], q1 = co[1], q2 = co[2];
        const float a[4] = {q0.x, q0.w, q1.z, q2.y}, bb[4] = {q0.y, q1.x, q1.w, q2.z};
        const float c[4] = {q0.z, q1.y, q2.x, q2.w};
        keep = true;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = a[i] > 0.0f ? cx_hi : cx_lo;
          const float y = bb[i] > 0.0f ? cy_hi : cy_lo;
          const float emax = __fadd_rn(__fmul_rn(a[i], x), __fadd_rn(__fmul_rn(bb[i], y), c[i]));
          keep = keep && emax > 0.0f;
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (keep) ring.wlist[warp][wcount + __popc(ballot & ((1u << lane) - 1u))] = static_cast<unsigned char>(e);
      wcount += __popc(ballot);
    }
    __syncwarp();

    for (int q = 0; q < wcount; ++q) {
      const float4* co = reinterpret_cast<const float4*>(tb + ring.wlist[warp][q] * kPackWidth);
      const float4 r0 = co[0], r1 = co[1], r2 = co[2];
      // r0 = (a0 b0 c0 a1), r1 = (b1 c1 a2 b2), r2 = (c2 a3 b3 c3), r3 = (az bz cz luma)
      float ax0[kCols], ax1[kCols], ax2[kCols], ax3[kCols];
      float by0[kRows], by1[kRows], by2[kRows], by3[kRows];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ax0[j] = __fmul_rn(r0.x, px[j]);
        ax1[j] = __fmul_rn(r0.w, px[j]);
        ax2[j] = __fmul_rn(r1.z, px[j]);
        ax3[j] = __fmul_rn(r2.y, px[j]);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        by0[k] = __fadd_rn(__fmul_rn(r0.y, py[k]), r0.z);
        by1[k] = __fadd_rn(__fmul_rn(r1.x, py[k]), r1.y);
        by2[k] = __fadd_rn(__fmul_rn(r1.w, py[k]), r2.x);
        by3[k] = __fadd_rn(__fmul_rn(r2.z, py[k]), r2.w);
      }
      const float4 r3 = co[3];
      const int lum = static_cast<int>(r3.w);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const float bz = __fadd_rn(__fmul_rn(r3.y, py[k]), r3.z);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const float zi = __fadd_rn(__fmul_rn(r3.x, px[j]), bz);
          const int key = (__float_as_int(zi) & kKeyMask) | lum;
          const bool take = (__fadd_rn(ax0[j], by0[k]) > 0.0f) & (__fadd_rn(ax1[j], by1[k]) > 0.0f) &
                            (__fadd_rn(ax2[j], by2[k]) > 0.0f) & (__fadd_rn(ax3[j], by3[k]) > 0.0f) &
                            (zi < p.inv_near);
          kmax[k][j] = take ? max(kmax[k][j], key) : kmax[k][j];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[s]);
    if (!m.w) continue;

    // the item's last chunk: decode the keys of this thread's pixels
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int row = y0 + ty + k;
      if (row < p.tile_rows) {
        const float t = __fmul_rn(__fsub_rn(py[k], 0.5f), p.t_scale);
        const float sky = __fadd_rn(__fmul_rn(p.sky_top, __fsub_rn(1.0f, t)),
                                    __fmul_rn(p.sky_hor, t));
        float v[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int key = kmax[k][j];
          const float ziw = __int_as_float(key & kKeyMask);
          const float luma = __fmul_rn(static_cast<float>(key & kLumaMask), p.luma_scale);
          const float shade = __fmul_rn(ziw, __frcp_rn(__fadd_rn(ziw, 0.004f)));
          float lit = __fmul_rn(luma, shade);
          if (p.fog_density > 0.0f) {
            const float depth = __frcp_rn(fmaxf(ziw, 1e-9f));
            const float f = expf(__fmul_rn(-p.fog_density, depth));
            lit = __fadd_rn(__fmul_rn(lit, f), __fmul_rn(sky, __fsub_rn(1.0f, f)));
          }
          v[j] = (key > p.far_key) ? lit : sky;
        }
        const int y = r * p.tile_rows + row;
        const int x = x0 + tx;
        store_row(p.out + (static_cast<size_t>(b) * p.H + y) * p.W + x, v, x, p.W);
      }
    }
  }
}

int grid_size(int n_items) {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prim_band_kernel, kThreads, 0);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n_items < blocks ? n_items : blocks;
}

}  // namespace

// `queue` is two ints of device memory, zero at the launch: the next item
// and the count of producers done. The last producer to finish sets both
// to zero again, so the next launch on `stream` can reuse them.
extern "C" int raster_prim_launch(
    const float* tbl, const int* idx, const int* count, float* out, int* queue,
    int B, int P, int R, int K, int H, int W, int tile_rows,
    float inv_near, int far_key, float sky_top, float sky_hor, float t_scale,
    float luma_scale, float fog_density, int list_factor, void* stream) {
  Params p{tbl, idx, count, out, queue, P, R, K, H, W, tile_rows,
           (W + kBlockX - 1) / kBlockX, (tile_rows + kBlockY - 1) / kBlockY, 0,
           inv_near, far_key, sky_top, sky_hor, t_scale, luma_scale, fog_density,
           list_factor};
  p.n_items = p.n_xs * p.n_ys * R * B;
  if (p.n_items == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  prim_band_kernel<<<grid_size(p.n_items), kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Launch facts for reports: registers and local (spill) bytes a thread,
// static shared memory a block, threads a block and resident blocks per SM.
extern "C" int raster_prim_info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, prim_band_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prim_band_kernel, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = kThreads;
  out[4] = per_sm;
  return static_cast<int>(err);
}
