// Fused-quad grayscale rollout rasterizer for Hopper (sm_90a): kernel C.
//
// Replaces: carla_imitation_learning_tpu/ops/raster_fast.py `_prim_kernel`
// (Pallas TPU kernel, reached through `rasterize_luma_fast` with quads=True).
//
// What it computes, per env and per band of `tile_rows` image rows: for every
// primitive on the band's list (16 coefficients: 4 sign-normalized border
// rows, the screen-affine 1/z row, 1 quantized luma; a fused quad or a
// triangle with its first edge row repeated), the four border values and
// zi = 1/z in rank-1 form a*px + (b*py + c); a pixel is a candidate when
// min(e0, e1, e2, e3) > 0 and zi < 1/near; visibility is a running MAX of
// the int32 key (bits(zi) & ~0xFFF) | luma12, 0 meaning no hit (larger 1/z
// is nearer). There is no divide in the pass loop. The epilogue decodes hit
// pixels (key > far_key) to luma * zi / (zi + 0.004), misses to the sky
// gradient, and with fog_density > 0 blends toward the sky at depth
// 1 / max(zi, 1e-9). Like the TPU kernel, the list is walked two entries at
// a time, so an odd count also evaluates the next list entry.
//
// What bounds it on this card: FP32/INT32 instruction throughput in the pass
// loop — about 21 operations per pixel and listed primitive (against 17 for
// kernel B's triangle pass, on roughly 0.6x the list entries), with 64 bytes
// of table per primitive and 4 bytes of output per pixel; operations over
// the CUDA-core rate set the bound.
//
// Design: kernel B's (csrc/raster_fast.cu): one block per (band, env); the
// block stages the band's listed coefficient columns (16 rows) into shared
// memory in chunks of kChunk primitives, each thread owns one column and up
// to kMaxRows rows with its keys in registers, and every thread walks the
// same list, so coefficient reads are shared-memory broadcasts. Rounding is
// pinned with __fmul_rn/__fadd_rn, and the IEEE reciprocal __frcp_rn stands
// where the TPU kernel takes pl.reciprocal(approx=True), so the kernel equals
// its plain PyTorch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kPackWidth = 16;
constexpr int kChunk = 256;
constexpr int kMaxRows = 8;
constexpr int kLumaMask = 0xFFF;
constexpr int kKeyMask = ~0xFFF;

__global__ void prim_band_kernel(
    const float* __restrict__ tbl, const int* __restrict__ idx,
    const int* __restrict__ count, float* __restrict__ out,
    int P, int R, int K, int H, int W, int tile_rows, int rows_per_thread,
    float inv_near, int far_key, float sky_top, float sky_hor, float t_scale,
    float luma_scale, float fog_density) {
  __shared__ float s_tbl[kPackWidth * kChunk];
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int x = threadIdx.x;
  const int row0 = threadIdx.y * rows_per_thread;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  const float px = __fadd_rn(static_cast<float>(x), 0.5f);
  const float y_off = __fadd_rn(static_cast<float>(r * tile_rows), 0.5f);
  float py[kMaxRows];
  int kmax[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    py[i] = __fadd_rn(static_cast<float>(row0 + i), y_off);
    kmax[i] = 0;
  }

  const float* env_tbl = tbl + static_cast<size_t>(b) * kPackWidth * P;
  const int* list = idx + (static_cast<size_t>(b) * R + r) * K;
  const int cnt = count[b * R + r];
  const int n_pass = min((cnt + 1) / 2 * 2, K);

  for (int base = 0; base < n_pass; base += kChunk) {
    const int n = min(kChunk, n_pass - base);
    __syncthreads();
    for (int j = tid; j < n * kPackWidth; j += nthreads) {
      const int c = j / n;
      const int e = j - c * n;
      s_tbl[c * kChunk + e] = env_tbl[static_cast<size_t>(c) * P + list[base + e]];
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const float* co = s_tbl + e;
      const float ax0 = __fmul_rn(co[0 * kChunk], px);
      const float ax1 = __fmul_rn(co[3 * kChunk], px);
      const float ax2 = __fmul_rn(co[6 * kChunk], px);
      const float ax3 = __fmul_rn(co[9 * kChunk], px);
      const float axz = __fmul_rn(co[12 * kChunk], px);
      const float b0 = co[1 * kChunk], c0 = co[2 * kChunk];
      const float b1 = co[4 * kChunk], c1 = co[5 * kChunk];
      const float b2 = co[7 * kChunk], c2 = co[8 * kChunk];
      const float b3 = co[10 * kChunk], c3 = co[11 * kChunk];
      const float bz = co[13 * kChunk], cz = co[14 * kChunk];
      const int lum = static_cast<int>(co[15 * kChunk]);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < rows_per_thread) {
          const float e0 = __fadd_rn(ax0, __fadd_rn(__fmul_rn(b0, py[i]), c0));
          const float e1 = __fadd_rn(ax1, __fadd_rn(__fmul_rn(b1, py[i]), c1));
          const float e2 = __fadd_rn(ax2, __fadd_rn(__fmul_rn(b2, py[i]), c2));
          const float e3 = __fadd_rn(ax3, __fadd_rn(__fmul_rn(b3, py[i]), c3));
          const float zi = __fadd_rn(axz, __fadd_rn(__fmul_rn(bz, py[i]), cz));
          const bool ok = fminf(fminf(e0, e1), fminf(e2, e3)) > 0.0f && zi < inv_near;
          const int key = (__float_as_int(zi) & kKeyMask) | lum;
          kmax[i] = max(kmax[i], ok ? key : 0);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int row = row0 + i;
    if (i < rows_per_thread && row < tile_rows) {
      const int k = kmax[i];
      const float ziw = __int_as_float(k & kKeyMask);
      const float luma = __fmul_rn(static_cast<float>(k & kLumaMask), luma_scale);
      const float shade = __fmul_rn(ziw, __frcp_rn(__fadd_rn(ziw, 0.004f)));
      const float t = __fmul_rn(__fsub_rn(py[i], 0.5f), t_scale);
      const float sky = __fadd_rn(__fmul_rn(sky_top, __fsub_rn(1.0f, t)),
                                  __fmul_rn(sky_hor, t));
      float lit = __fmul_rn(luma, shade);
      if (fog_density > 0.0f) {
        const float depth = __frcp_rn(fmaxf(ziw, 1e-9f));
        const float f = expf(__fmul_rn(-fog_density, depth));
        lit = __fadd_rn(__fmul_rn(lit, f), __fmul_rn(sky, __fsub_rn(1.0f, f)));
      }
      const int y = r * tile_rows + row;
      out[(static_cast<size_t>(b) * H + y) * W + x] = (k > far_key) ? lit : sky;
    }
  }
}

}  // namespace

extern "C" int raster_prim_launch(
    const float* tbl, const int* idx, const int* count, float* out,
    int B, int P, int R, int K, int H, int W, int tile_rows,
    float inv_near, int far_key, float sky_top, float sky_hor, float t_scale,
    float luma_scale, float fog_density, void* stream) {
  const int rows_per_thread = tile_rows < kMaxRows ? tile_rows : kMaxRows;
  const int groups = (tile_rows + rows_per_thread - 1) / rows_per_thread;
  prim_band_kernel<<<dim3(R, B), dim3(W, groups), 0, static_cast<cudaStream_t>(stream)>>>(
      tbl, idx, count, out, P, R, K, H, W, tile_rows, rows_per_thread,
      inv_near, far_key, sky_top, sky_hor, t_scale, luma_scale, fog_density);
  return static_cast<int>(cudaGetLastError());
}
