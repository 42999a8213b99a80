// Grouped band-table grayscale rollout rasterizer for Hopper (sm_90a):
// kernel D.
//
// Replaces: carla_imitation_learning_tpu/ops/raster_fast.py `_vec_kernel`
// (Pallas TPU kernel, reached through `rasterize_luma_fast` with vec=True).
//
// What it computes: kernel B's function (csrc/raster_fast.cu) — per pixel,
// the running MIN of the packed key (bits(z) & ~0xFFF) | luma12 over the
// band's list, z = znum * rcp(e0 + e1 + e2) where min(e0, e1, e2) > 0 and
// z > near, the same epilogue — but read from the band's own gathered table
// (B, R, K, 16): 13 coefficients and 3 pad floats per entry, in list order,
// built once per frame by `gather_band_tables`. The list is walked in groups
// of kVecP = 8 entries over ceil(count / 8) groups (K is a multiple of 8),
// so up to 7 entries past the count are evaluated, as on the TPU. Every
// pixel sees the same operands in the same order as in kernel B, so on the
// same lists the two agree bit for bit wherever those extra entries light
// nothing.
//
// What bounds it on this card: the same FP32/INT32 pass work as kernel B
// (17 operations per pixel and evaluated entry), over up to 7 more entries
// per band; its input is 64 bytes per listed entry, read contiguously with
// no index indirection. Operations over the CUDA-core rate set the bound.
//
// Design: one block per (band, env), threads as in kernel B (one column,
// up to kMaxRows rows each, keys in registers). The block copies its band
// table into shared memory in chunks of kChunk entries with 16-byte loads
// (a contiguous, coalesced stream instead of B's per-coefficient gather),
// then each thread takes the min over a group of 8 candidates before
// folding it into its running key. Rounding is pinned with __fmul_rn /
// __fadd_rn and the IEEE reciprocal __frcp_rn, as in kernel B.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 16;      // floats per table entry
constexpr int kVecP = 8;      // entries per group
constexpr int kChunk = 256;   // entries staged per pass (16 KB)
constexpr int kMaxRows = 8;
constexpr int kLumaMask = 0xFFF;
constexpr int kKeyMask = ~0xFFF;
constexpr int kMissKey = 0x7FFFFFFF;

__global__ void vec_band_kernel(
    const float* __restrict__ btbl, const int* __restrict__ count,
    float* __restrict__ out, int R, int K, int H, int W, int tile_rows,
    int rows_per_thread, float near_z, int far_key, float sky_top,
    float sky_hor, float t_scale, float luma_scale, float fog_density) {
  __shared__ float4 s_tbl4[kChunk * kRow / 4];
  const float* s_tbl = reinterpret_cast<const float*>(s_tbl4);
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

  const float4* band4 = reinterpret_cast<const float4*>(
      btbl + (static_cast<size_t>(b) * R + r) * K * kRow);
  const int cnt = count[b * R + r];
  const int n_pass = min((cnt + kVecP - 1) / kVecP * kVecP, K);

  for (int base = 0; base < n_pass; base += kChunk) {
    const int n = min(kChunk, n_pass - base);   // a multiple of kVecP
    __syncthreads();
    for (int j = tid; j < n * (kRow / 4); j += nthreads) {
      s_tbl4[j] = band4[static_cast<size_t>(base) * (kRow / 4) + j];
    }
    __syncthreads();
    for (int g = 0; g < n; g += kVecP) {
      int gmin[kMaxRows];
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) gmin[i] = kMissKey;
#pragma unroll
      for (int p = 0; p < kVecP; ++p) {
        const float* co = s_tbl + (g + p) * kRow;
        const float ax0 = __fmul_rn(co[0], px);
        const float ax1 = __fmul_rn(co[3], px);
        const float ax2 = __fmul_rn(co[6], px);
        const float axz = __fmul_rn(co[9], px);
        const float b0 = co[1], c0 = co[2];
        const float b1 = co[4], c1 = co[5];
        const float b2 = co[7], c2 = co[8];
        const float bz = co[10], cz = co[11];
        const int lum = static_cast<int>(co[12]);
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
            gmin[i] = min(gmin[i], (inside && z > near_z) ? key : kMissKey);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) kmin[i] = min(kmin[i], gmin[i]);
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

extern "C" int raster_vec_launch(
    const float* btbl, const int* count, float* out, int B, int R, int K,
    int H, int W, int tile_rows, float near_z, int far_key, float sky_top,
    float sky_hor, float t_scale, float luma_scale, float fog_density,
    void* stream) {
  const int rows_per_thread = tile_rows < kMaxRows ? tile_rows : kMaxRows;
  const int groups = (tile_rows + rows_per_thread - 1) / rows_per_thread;
  vec_band_kernel<<<dim3(R, B), dim3(W, groups), 0, static_cast<cudaStream_t>(stream)>>>(
      btbl, count, out, R, K, H, W, tile_rows, rows_per_thread, near_z,
      far_key, sky_top, sky_hor, t_scale, luma_scale, fog_density);
  return static_cast<int>(cudaGetLastError());
}
