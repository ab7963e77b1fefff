// Fused soft-rasterizer forward for Hopper (sm_90a), kernel B1.
//
// Replaces the TPU kernel `_fwd_kernel_compact`
// (selfcorr_tpu/ops/rasterizer/pallas_raster.py:806, launched by _fwd_call
// :1285 -> pl.pallas_call :1323), its `tex_res` arm included (:626-628).
// Computes exactly what the plain PyTorch version `raster_fused_fwd_plain`
// (../reference.py) computes from the same packed (B, F, K) face constants
// (../common.py pack_constants): the two 'prod' coverages, the gamma_d depth
// softmax (white background), the gamma_t texture softmax of the soft
// texture or, with tex_res = R > 0, of the surface texels (white
// background), the hard nearest-face match and the four softmax residual
// planes. Output: 13 planes, (13, B, S, S) float32, in the order of
// reference.PLANES.
//
// Design (simple first; tuning is later work):
//   * one thread per pixel, 16x16 pixels per block, grid (S/16, S/16, B);
//   * faces are tested 256 at a time in their packed (sorted) order, one
//     per thread: the face's bbox, padded by the coverage cutoff radius,
//     against the block's pixel box; ballots compact the live ones, order
//     preserved, and their used slots (59, or 59 + 3 R^2 with texels) are
//     staged through dynamic shared memory 64 faces at a time, so every
//     thread walks only the block's live faces;
//   * per pixel, the coverage products, running-max softmax carries and the
//     hard winner live in registers (raster_common.cuh shade); the carries
//     start at the background fragment (max bg_eps, sum 1, accumulator 1)
//     as the TPU kernel's do (pallas_raster.py:847-850);
//   * the hard winner takes a face only on a strictly smaller z, walking
//     faces in order, so the earliest face wins exact ties;
//   * an excluded face never reaches an exponential, so no inf * 0 = nan.
//
// What bounds it on an H100: arithmetic. Each live (face, pixel) pair costs
// ~180 fp32 operations (three exps, two divisions), while the bytes are the
// constants read once plus 13 output planes written once. The bbox cull keeps
// the pair count near the faces' true support.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int TILE = 16;     // block = TILE x TILE pixels
constexpr int THREADS = TILE * TILE;
constexpr int CH = 64;       // live faces staged in shared memory at a time

__global__ void __launch_bounds__(THREADS)
raster_fwd_kernel(const float* __restrict__ consts, int F, int S, int B,
                  int K, int tex_res, Params prm, float* __restrict__ out) {
  extern __shared__ float sc[];  // [CH][used]
  __shared__ int s_ids[THREADS];
  __shared__ int s_cnt[THREADS / 32];

  const int used = used_slots(tex_res);
  const int b = blockIdx.z;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int col = blockIdx.x * TILE + threadIdx.x;
  const int row = blockIdx.y * TILE + threadIdx.y;
  const bool valid = (col < S) && (row < S);
  const float x = pixel_x(col, S, prm);
  const float y = pixel_y(row, S, prm);
  const float p2 = x * x + y * y;

  // the block's pixel box, padded by the cull radius
  const int c_lo = blockIdx.x * TILE;
  const int c_hi = min(c_lo + TILE, S) - 1;
  const int r_lo = blockIdx.y * TILE;
  const int r_hi = min(r_lo + TILE, S) - 1;
  const float bx_lo = pixel_x(c_lo, S, prm) - prm.pad;
  const float bx_hi = pixel_x(c_hi, S, prm) + prm.pad;
  const float by_hi = pixel_y(r_lo, S, prm) + prm.pad;
  const float by_lo = pixel_y(r_hi, S, prm) - prm.pad;

  Carry q = carry_init(prm);
  const float* cb = consts + (size_t)b * F * K;

  for (int f0 = 0; f0 < F; f0 += THREADS) {
    // --- cull: each thread tests one face's padded bbox against the block's
    // pixel box; ballots + warp-count prefix compact the live face ids,
    // order preserved
    bool live = false;
    const int f = f0 + tid;
    if (f < F) {
      const float* bb = cb + (size_t)f * K + S_BBOX;
      live = (bb[0] <= bx_hi) && (bb[1] >= bx_lo) && (bb[2] <= by_hi) &&
             (bb[3] >= by_lo);
    }
    const unsigned ballot = __ballot_sync(FULL, live);
    const int warp = tid >> 5, lane = tid & 31;
    if (lane == 0) s_cnt[warp] = __popc(ballot);
    __syncthreads();
    int off = __popc(ballot & ((1u << lane) - 1u)), n_live = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      off += (w < warp) ? s_cnt[w] : 0;
      n_live += s_cnt[w];
    }
    if (live) s_ids[off] = f;
    __syncthreads();

    // --- stage the live faces' constants CH at a time and walk them
    for (int j0 = 0; j0 < n_live; j0 += CH) {
      const int n = min(CH, n_live - j0);
      for (int k = tid; k < n * used; k += THREADS) {
        const int j = k / used;
        const int sl = k - j * used;
        sc[j * used + sl] = cb[(size_t)s_ids[j0 + j] * K + sl];
      }
      __syncthreads();
      if (valid) {
        for (int j = 0; j < n; ++j)
          shade(sc + j * used, x, y, p2, prm, tex_res, q);
      }
      __syncthreads();
    }
  }

  if (!valid) return;
  write_planes(q, out, (size_t)B * S * S, ((size_t)b * S + row) * S + col);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tex_res the kernel does not
// take). consts: (B, F, K) float32 contiguous, device memory, K >=
// 59 + 3 tex_res^2; out: (13, B, S, S) float32 contiguous, device memory.
extern "C" int raster_fused_fwd(const float* consts, int B, int F, int S,
                                int K, int tex_res, float inv_sigma1,
                                float inv_sigma2, float inv_gamma_d,
                                float inv_gamma_t, float near_, float far_,
                                float inv_range, float bg_eps, float z_offset,
                                float cut1, float cut2, float pad, float inv_s,
                                float* out, void* stream) {
  if (tex_res < 0 || tex_res > MAX_TEX_RES || used_slots(tex_res) > K)
    return (int)cudaErrorInvalidValue;
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  const size_t smem = (size_t)CH * used_slots(tex_res) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raster_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 block(TILE, TILE);
  dim3 grid((S + TILE - 1) / TILE, (S + TILE - 1) / TILE, B);
  raster_fwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      consts, F, S, B, K, tex_res, prm, out);
  return (int)cudaGetLastError();
}
