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
// e_i = (a*px + b*py) + c; a pixel is inside when all three share a sign;
// depth z = znum(p) / den with den = e0 + e1 + e2 (0 → 1e-9) is an exact
// divide; the triangle is written where near < z < zbuf (first writer wins
// on ties, in list order). Outputs: class, 1 or 3 colour planes, depth
// (`far` where nothing was hit). Sky and distance shade are applied outside.
//
// Textured variant (TEXTURED=true, 23 rows: + 3 unum + 3 vnum): on the pixels
// where a triangle is written, u = unum(p) / den and v = vnum(p) / den, and
// each written colour is multiplied by texture_factor(u, v, class) —
// ops/texture.py repeated operation for operation, with floorf and the
// accurate sinf (no fast math). The TPU kernel computes the factor on every
// pixel and selects; computing it only where the pass writes gives the same
// planes.
//
// What bounds it on this card: FP32 instruction throughput in the pass loop
// (about 30 operations per pixel and listed triangle, one of them a
// full-precision divide); its bytes are 68 per triangle (92 textured) and
// 12-20 per pixel. The texture adds two divides and the factor (a sinf on
// road and terrain) per WRITE, not per pass, so it costs in proportion to
// overdraw only.
//
// Design: one block per (band, env); the block stages the listed
// coefficient columns into shared memory in chunks of kChunk triangles and
// each thread owns one column and up to kMaxRows rows of the band, keeping
// z-buffer, class and colour in registers. Rounding is pinned
// (__fmul_rn/__fadd_rn/__fdiv_rn) so the kernel equals its plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kFlatWidth = 17;
constexpr int kTexWidth = 23;
constexpr int kChunk = 256;
constexpr int kMaxRows = 8;
constexpr int kSemRoad = 2, kSemTerrain = 1, kSemBuilding = 3;

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

template <int C, bool TEXTURED>
__global__ void exact_band_kernel(
    const float* __restrict__ tbl, const int* __restrict__ idx,
    const int* __restrict__ count, int* __restrict__ sem,
    float* __restrict__ col, float* __restrict__ depth,
    int T, int R, int K, int H, int W, int tile_rows, int rows_per_thread,
    float near_z, float far_z) {
  constexpr int kPackWidth = TEXTURED ? kTexWidth : kFlatWidth;
  __shared__ float s_tbl[kPackWidth * kChunk];
  const int r = blockIdx.x;
  const int b = blockIdx.y;
  const int x = threadIdx.x;
  const int row0 = threadIdx.y * rows_per_thread;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  const float px = __fadd_rn(static_cast<float>(x), 0.5f);
  const float y0 = static_cast<float>(r * tile_rows);
  float py[kMaxRows], zbuf[kMaxRows], colour[C][kMaxRows];
  int cls[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    py[i] = __fadd_rn(__fadd_rn(y0, static_cast<float>(row0 + i)), 0.5f);
    zbuf[i] = far_z;
    cls[i] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) colour[c][i] = 0.0f;
  }

  const float* env_tbl = tbl + static_cast<size_t>(b) * kPackWidth * T;
  const int* list = idx + (static_cast<size_t>(b) * R + r) * K;
  const int cnt = count[b * R + r];

  for (int base = 0; base < cnt; base += kChunk) {
    const int n = min(kChunk, cnt - base);
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
      const int k_cls = static_cast<int>(co[15 * kChunk]);
      float k_col[C];
#pragma unroll
      for (int c = 0; c < C; ++c) k_col[c] = co[(12 + c) * kChunk];
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < rows_per_thread) {
          const float e0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(b0, py[i])), c0);
          const float e1 = __fadd_rn(__fadd_rn(ax1, __fmul_rn(b1, py[i])), c1);
          const float e2 = __fadd_rn(__fadd_rn(ax2, __fmul_rn(b2, py[i])), c2);
          const bool inside = (e0 > 0.0f && e1 > 0.0f && e2 > 0.0f) ||
                              (e0 < 0.0f && e1 < 0.0f && e2 < 0.0f);
          float den = __fadd_rn(__fadd_rn(e0, e1), e2);
          den = (den == 0.0f) ? 1e-9f : den;
          const float z = __fdiv_rn(
              __fadd_rn(__fadd_rn(axz, __fmul_rn(bz, py[i])), cz), den);
          if (inside && z > near_z && z < zbuf[i]) {
            zbuf[i] = z;
            cls[i] = k_cls;
            if constexpr (TEXTURED) {
              const float u = __fdiv_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(co[17 * kChunk], px),
                                      __fmul_rn(co[18 * kChunk], py[i])),
                            co[19 * kChunk]), den);
              const float v = __fdiv_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(co[20 * kChunk], px),
                                      __fmul_rn(co[21 * kChunk], py[i])),
                            co[22 * kChunk]), den);
              const float fac = texture_factor(u, v, k_cls);
#pragma unroll
              for (int c = 0; c < C; ++c) colour[c][i] = __fmul_rn(k_col[c], fac);
            } else {
#pragma unroll
              for (int c = 0; c < C; ++c) colour[c][i] = k_col[c];
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int row = row0 + i;
    if (i < rows_per_thread && row < tile_rows) {
      const size_t p = (static_cast<size_t>(b) * H + r * tile_rows + row) * W + x;
      sem[p] = cls[i];
      depth[p] = zbuf[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        col[(static_cast<size_t>(b) * C + c) * H * W
            + static_cast<size_t>(r * tile_rows + row) * W + x] = colour[c][i];
      }
    }
  }
}

template <int C, bool TEXTURED>
void launch(const float* tbl, const int* idx, const int* count, int* sem,
            float* col, float* depth, int B, int T, int R, int K, int H, int W,
            int tile_rows, float near_z, float far_z, cudaStream_t s) {
  const int rows_per_thread = tile_rows < kMaxRows ? tile_rows : kMaxRows;
  const int groups = (tile_rows + rows_per_thread - 1) / rows_per_thread;
  exact_band_kernel<C, TEXTURED><<<dim3(R, B), dim3(W, groups), 0, s>>>(
      tbl, idx, count, sem, col, depth, T, R, K, H, W, tile_rows,
      rows_per_thread, near_z, far_z);
}

}  // namespace

extern "C" int raster_exact_launch(
    const float* tbl, const int* idx, const int* count, int* sem, float* col,
    float* depth, int B, int T, int R, int K, int H, int W, int tile_rows,
    int n_channels, int textured, float near_z, float far_z, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_channels == 1 && !textured) {
    launch<1, false>(tbl, idx, count, sem, col, depth, B, T, R, K, H, W, tile_rows, near_z, far_z, s);
  } else if (n_channels == 3 && !textured) {
    launch<3, false>(tbl, idx, count, sem, col, depth, B, T, R, K, H, W, tile_rows, near_z, far_z, s);
  } else if (n_channels == 1) {
    launch<1, true>(tbl, idx, count, sem, col, depth, B, T, R, K, H, W, tile_rows, near_z, far_z, s);
  } else if (n_channels == 3) {
    launch<3, true>(tbl, idx, count, sem, col, depth, B, T, R, K, H, W, tile_rows, near_z, far_z, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
