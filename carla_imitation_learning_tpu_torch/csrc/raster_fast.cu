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
// form a*px + (b*py + c); a pixel is inside when min(e0, e1, e2) > 0; depth
// z = znum * rcp(e0 + e1 + e2), accepted when z > near; visibility is a
// running MIN of the int32 key (bits(z) & ~0xFFF) | luma12. The epilogue
// decodes hit pixels (key < far_key) to luma / (1 + 0.004 z), misses to the
// sky gradient, and applies exponential fog when fog_density > 0.
// Like the TPU kernel, the list is walked two entries at a time, so an odd
// count also evaluates the next list entry (a non-hit or padding triangle).
//
// What bounds it on this card: FP32/INT32 instruction throughput in the pass
// loop — about 17 operations per pixel and listed triangle, against 52 bytes
// of table per triangle and 4 bytes of output per pixel, so it sits far above
// the ridge point; the bound is operations over the CUDA-core rate.
//
// Design: one block per (band, env). The block stages the band's listed
// coefficient columns into shared memory in chunks of kChunk triangles (a
// gather from the env's coefficient-major table) and each thread owns one
// column and up to kMaxRows rows of the band, with its keys in registers.
// Every thread of a block walks the same list, so coefficient reads are
// shared-memory broadcasts. Rounding is pinned with __fmul_rn/__fadd_rn and
// the IEEE reciprocal __frcp_rn (the TPU kernel's approximate reciprocal is
// not reproduced), so the kernel equals its plain PyTorch version bit for
// bit. Making it fast (warp-level list compaction, fewer registers,
// cp.async staging) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kPackWidth = 13;
constexpr int kChunk = 256;
constexpr int kMaxRows = 8;
constexpr int kLumaMask = 0xFFF;
constexpr int kKeyMask = ~0xFFF;
constexpr int kMissKey = 0x7FFFFFFF;

__global__ void fast_band_kernel(
    const float* __restrict__ tbl, const int* __restrict__ idx,
    const int* __restrict__ count, float* __restrict__ out,
    int T, int R, int K, int H, int W, int tile_rows, int rows_per_thread,
    float near_z, int far_key, float sky_top, float sky_hor, float t_scale,
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
  int kmin[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    py[i] = __fadd_rn(static_cast<float>(row0 + i), y_off);
    kmin[i] = kMissKey;
  }

  const float* env_tbl = tbl + static_cast<size_t>(b) * kPackWidth * T;
  const int* list = idx + (static_cast<size_t>(b) * R + r) * K;
  const int cnt = count[b * R + r];
  const int n_pass = min((cnt + 1) / 2 * 2, K);

  for (int base = 0; base < n_pass; base += kChunk) {
    const int n = min(kChunk, n_pass - base);
    __syncthreads();
    for (int j = tid; j < n * kPackWidth; j += nthreads) {
      const int c = j / n;
      const int e = j - c * n;
      s_tbl[c * kChunk + e] = env_tbl[static_cast<size_t>(c) * T + list[base + e]];
    }
    __syncthreads();
    for (int e = 0; e < n; ++e) {
      const float* co = s_tbl + e;
      const float ax0 = __fmul_rn(co[0 * kChunk], px);
      const float ax1 = __fmul_rn(co[3 * kChunk], px);
      const float ax2 = __fmul_rn(co[6 * kChunk], px);
      const float axz = __fmul_rn(co[9 * kChunk], px);
      const float b0 = co[1 * kChunk], c0 = co[2 * kChunk];
      const float b1 = co[4 * kChunk], c1 = co[5 * kChunk];
      const float b2 = co[7 * kChunk], c2 = co[8 * kChunk];
      const float bz = co[10 * kChunk], cz = co[11 * kChunk];
      const int lum = static_cast<int>(co[12 * kChunk]);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < rows_per_thread) {
          const float e0 = __fadd_rn(ax0, __fadd_rn(__fmul_rn(b0, py[i]), c0));
          const float e1 = __fadd_rn(ax1, __fadd_rn(__fmul_rn(b1, py[i]), c1));
          const float e2 = __fadd_rn(ax2, __fadd_rn(__fmul_rn(b2, py[i]), c2));
          const float zn = __fadd_rn(axz, __fadd_rn(__fmul_rn(bz, py[i]), cz));
          const bool inside = fminf(fminf(e0, e1), e2) > 0.0f;
          const float den = __fadd_rn(__fadd_rn(e0, e1), e2);
          const float z = __fmul_rn(zn, __frcp_rn(den));
          const int key = (__float_as_int(z) & kKeyMask) | lum;
          kmin[i] = min(kmin[i], (inside && z > near_z) ? key : kMissKey);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int row = row0 + i;
    if (i < rows_per_thread && row < tile_rows) {
      const int k = kmin[i];
      const float depth = __int_as_float(k & kKeyMask);
      const float luma = __fmul_rn(static_cast<float>(k & kLumaMask), luma_scale);
      const float shade = __frcp_rn(__fadd_rn(1.0f, __fmul_rn(0.004f, depth)));
      const float t = __fmul_rn(__fsub_rn(py[i], 0.5f), t_scale);
      const float sky = __fadd_rn(__fmul_rn(sky_top, __fsub_rn(1.0f, t)),
                                  __fmul_rn(sky_hor, t));
      float lit = __fmul_rn(luma, shade);
      if (fog_density > 0.0f) {
        const float f = expf(__fmul_rn(-fog_density, depth));
        lit = __fadd_rn(__fmul_rn(lit, f), __fmul_rn(sky, __fsub_rn(1.0f, f)));
      }
      const int y = r * tile_rows + row;
      out[(static_cast<size_t>(b) * H + y) * W + x] = (k < far_key) ? lit : sky;
    }
  }
}

}  // namespace

extern "C" int raster_fast_launch(
    const float* tbl, const int* idx, const int* count, float* out,
    int B, int T, int R, int K, int H, int W, int tile_rows,
    float near_z, int far_key, float sky_top, float sky_hor, float t_scale,
    float luma_scale, float fog_density, void* stream) {
  const int rows_per_thread = tile_rows < kMaxRows ? tile_rows : kMaxRows;
  const int groups = (tile_rows + rows_per_thread - 1) / rows_per_thread;
  const dim3 grid(R, B);
  const dim3 block(W, groups);
  fast_band_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      tbl, idx, count, out, T, R, K, H, W, tile_rows, rows_per_thread,
      near_z, far_key, sky_top, sky_hor, t_scale, luma_scale, fog_density);
  return static_cast<int>(cudaGetLastError());
}
