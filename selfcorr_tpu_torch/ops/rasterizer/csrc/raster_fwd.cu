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
// Design:
//   * blocks of WX x WY = 2 x 2 warps over 16 x 8 pixels, grid (S / 16,
//     S / 8, B); each warp owns a sub-tile of SUB_COLS = 8 columns x
//     LANE_ROWS = 4 rows, a pixel a lane (raster_common.cuh SubTile); 64
//     registers a thread, so that 8 blocks (32 warps) fit an SM: the
//     per-pair chains are long (six exponentials and six IEEE divisions
//     where a sigma covers), so warps in flight, not shared-memory loads,
//     set the time (two or four pixels a lane, sharing each face's register
//     copy, ran 1.6-3x slower on the H100: more registers, fewer warps,
//     larger sub-tiles);
//   * block cull: each thread tests FPT consecutive faces' bboxes, padded
//     by the coverage cutoff radius, against the block's box, all FPT loads
//     in flight at once; a warp scan and the warps' counts compact the live
//     ids in order (two barriers per round of FPT * 128 faces);
//   * the live faces are staged CH (fewer with texels, STAGE_BYTES) at a
//     time, a half-warp per face row, float4 by float4, with no division;
//     then each warp tests 32 staged faces at once, a lane each, against its
//     sub-tile's padded box, and walks the faces that pass in order (an
//     exact cull: a face it skips covers none of its pixels), reading each
//     face's slots into registers with 15 LDS.128 (raster_common.cuh
//     walk_staged, shade);
//   * per pixel, the coverage products, running-max softmax carries and the
//     hard winner live in registers (raster_common.cuh shade); the carries
//     start at the background fragment (max bg_eps, sum 1, accumulator 1)
//     as the TPU kernel's do (pallas_raster.py:847-850);
//   * the hard winner takes a face only on a strictly smaller z, walking
//     faces in order, so the earliest face wins exact ties;
//   * an excluded face never reaches an exponential, so no inf * 0 = nan.
//
// What bounds it on an H100: arithmetic. Each shaded (face, pixel) pair
// costs ~100 fp32 operations of geometry and, where a sigma covers it, ~70
// more (six exps and six divisions at -fmad=false), while the bytes are the
// constants read once plus 13 output planes written once. The warps' cull
// keeps the pairs near the faces' padded boxes (1.6-1.8x the covered pairs
// at the laptop scenes); a warp runs a pair's covered path when any of its
// 32 pixels is covered.

#include <stdint.h>

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int CH = 64;    // live faces staged at a time, at most
constexpr int WX = 2;     // warps across a block: 16 columns
constexpr int WY = 2;     // warps down a block: 8 rows
constexpr int FPT = 8;    // faces each thread tests per cull round
constexpr int MINB = 8;   // blocks an SM, the launch bound: 64 registers
constexpr int THREADS = 32 * WX * WY;
constexpr int BLOCK_COLS = WX * SUB_COLS, BLOCK_ROWS = WY * LANE_ROWS;

__global__ void __launch_bounds__(THREADS, MINB)
raster_fwd_kernel(const float* __restrict__ consts, int F, int S, int B,
                  int K, int tex_res, int ch, Params prm,
                  float* __restrict__ out) {
  constexpr int ROUND = FPT * THREADS;
  extern __shared__ float4 sc4[];  // [ch][V]
  __shared__ int s_ids[ROUND];
  __shared__ int s_wsum[WX * WY];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * BLOCK_ROWS, c0 = blockIdx.x * BLOCK_COLS;
  SubTile w;
  sub_tile(w, r0 + (warp / WX) * LANE_ROWS, c0 + (warp % WX) * SUB_COLS, S,
           S, S, prm);

  // the block's pixel box, padded by the cull radius
  const int c_hi = min(c0 + BLOCK_COLS, S) - 1;
  const int r_hi = min(r0 + BLOCK_ROWS, S) - 1;
  const float bx_lo = pixel_x(c0, S, prm) - prm.pad;
  const float bx_hi = pixel_x(c_hi, S, prm) + prm.pad;
  const float by_hi = pixel_y(r0, S, prm) + prm.pad;
  const float by_lo = pixel_y(r_hi, S, prm) - prm.pad;

  const int V = staged_vecs(tex_res), K4 = K / 4;
  const float* cb = consts + (size_t)b * F * K;
  const float4* cb4 = reinterpret_cast<const float4*>(cb);

  for (int f0 = 0; f0 < F; f0 += ROUND) {
    // --- cull: FPT consecutive faces a thread; an inclusive warp scan of
    // the live counts and the warps' totals give each live face its place,
    // order preserved
    const int fb = f0 + tid * FPT;
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < FPT; ++j) {
      if (fb + j < F) {
        const float* bb = cb + (size_t)(fb + j) * K + S_BBOX;
        if ((bb[0] <= bx_hi) && (bb[1] >= bx_lo) && (bb[2] <= by_hi) &&
            (bb[3] >= by_lo))
          bits |= 1u << j;
      }
    }
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    int off = incl - cnt, n_live = 0;
#pragma unroll
    for (int v = 0; v < WX * WY; ++v) {
      off += (v < warp) ? s_wsum[v] : 0;
      n_live += s_wsum[v];
    }
#pragma unroll
    for (int j = 0; j < FPT; ++j)
      if ((bits >> j) & 1u) s_ids[off++] = fb + j;
    __syncthreads();

    // --- stage the live faces ch at a time, a half-warp per row; walk
    for (int j0 = 0; j0 < n_live; j0 += ch) {
      const int n = min(ch, n_live - j0);
      for (int j = tid >> 4; j < n; j += THREADS / 16)
        stage_row(sc4 + j * V, cb4 + (size_t)s_ids[j0 + j] * K4, V, tid & 15);
      __syncthreads();
      if (w.any) walk_staged(sc4, n, V, prm, tex_res, w);
      __syncthreads();
    }
  }
  write_sub_tile(w, out, B, S, b);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tex_res, K or alignment the
// kernel does not take). consts: (B, F, K) float32 contiguous, 16-byte
// aligned device memory, K a multiple of 4 and >= 59 + 3 tex_res^2; out:
// (13, B, S, S) float32 contiguous, device memory.
extern "C" int raster_fused_fwd(const float* consts, int B, int F, int S,
                                int K, int tex_res, float inv_sigma1,
                                float inv_sigma2, float inv_gamma_d,
                                float inv_gamma_t, float near_, float far_,
                                float inv_range, float bg_eps, float z_offset,
                                float cut1, float cut2, float pad, float inv_s,
                                float* out, void* stream) {
  if (tex_res < 0 || tex_res > MAX_TEX_RES || K % 4 ||
      4 * staged_vecs(tex_res) > K || ((uintptr_t)consts & 15))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_,
                   far_, inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  const int row = staged_vecs(tex_res) * (int)sizeof(float4);
  const int ch = min(CH, max(16, STAGE_BYTES / row));
  const size_t smem = (size_t)ch * row;
  // the static arrays (s_ids, s_wsum) count against the 48 KB default too
  constexpr size_t STATIC = (FPT * 32 + 1) * WX * WY * sizeof(int);
  if (smem + STATIC > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raster_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((S + BLOCK_COLS - 1) / BLOCK_COLS,
                  (S + BLOCK_ROWS - 1) / BLOCK_ROWS, B);
  raster_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      consts, F, S, B, K, tex_res, ch, prm, out);
  return (int)cudaGetLastError();
}
