// Fused soft-rasterizer backward in the dense-chunk schedule for Hopper
// (sm_90a), kernel B2'.
//
// Replaces the TPU kernel `_bwd_kernel` (selfcorr_tpu/ops/rasterizer/
// pallas_raster.py:1117, per-chunk math `_bwd_chunk_grads` :877, the same
// `pl.pallas_call` :1385 as B2's with `compact=False`), its `tex_res` arm
// and its MXU_REDUCE arm (:92, :1031-1062: the same gradient by another
// reduction) included. Computes exactly what the plain PyTorch version
// `raster_fused_bwd_chunk_plain` (../reference.py) computes: B2's gradient
// (raster_bwd.cu) over the (face, pixel) pairs of the chunks that
// chunks.compute_chunk_info marks for each pixel's tile.
//
// The TPU kernel adds each tile's chunk block into the gradient in grid
// order (:1167); blocks on Hopper run in no order, so here the reduction is
// turned around:
//   * one block of 16 warps per (chunk, batch element), grid (NC, B); warp w
//     owns face 16 ci + w of chunk ci and stages its used slots in shared
//     memory;
//   * the block walks the tiles in order; where the tile's span holds ci
//     and its bit is set (the transpose of the masks), each warp strides
//     over the tile's pixels inside its face's padded bbox (B2's pixel box,
//     raster_common.cuh face_box), recomputes B2's per-pair geometry and
//     chains (pair_grad) and keeps its face's 36 slots in registers, its
//     texel slots in a shared-memory row (warp_texel_add);
//   * a fixed-order butterfly per warp reduces the registers and the warp
//     writes its face's whole row. No atomics: a second launch is
//     bit-identical.
//
// What bounds it on an H100: arithmetic, as B2: ~260 fp32 operations per
// covering pair; the bytes are the 16 planes and the constants read once
// and the gradient written once.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int WARPS = FF;  // one warp per face of the chunk
constexpr int THREADS = 32 * WARPS;

__global__ void __launch_bounds__(THREADS)
raster_bwd_chunk_kernel(const float* __restrict__ consts,
                        const int* __restrict__ spans,
                        const int* __restrict__ masks,
                        const float* __restrict__ pix, int F, int S, int B,
                        int K, int tex_res, Tiles tl, Params prm,
                        float* __restrict__ grad) {
  __shared__ float sc[WARPS][MAX_USED];
  __shared__ float tacc[WARPS][MAX_USED - N_SLOTS];
  __shared__ float red[WARPS][NACC];

  const int ci = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int used = used_slots(tex_res);
  const int n_tex = used - N_SLOTS;
  const int f = ci * FF + warp;
  const float* cf = consts + ((size_t)b * F + f) * K;
  float* c = sc[warp];
  for (int k = lane; k < used; k += 32) c[k] = cf[k];
  for (int k = lane; k < n_tex; k += 32) tacc[warp][k] = 0.0f;
  __syncwarp();

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  const PixBox bx = face_box(c, S, prm);
  const size_t plane = (size_t)B * S * S;
  const int n_tiles = tl.n_rows * tl.n_cols;
  const int* span = spans + (size_t)b * n_tiles * 2;
  const int* words = masks + (size_t)b * n_tiles * tl.n_words;
  const unsigned bit = 1u << (ci & 31);

  for (int t = 0; t < n_tiles; ++t) {
    if (ci < span[2 * t] || ci >= span[2 * t + 1] ||
        !(((unsigned)words[t * tl.n_words + (ci >> 5)]) & bit))
      continue;
    // this tile's pixels inside the face's padded box
    const int r0 = max((t / tl.n_cols) * tl.rows, bx.r_lo);
    const int r1 = min((t / tl.n_cols + 1) * tl.rows, bx.r_hi + 1);
    const int c0 = max((t % tl.n_cols) * tl.cols, bx.c_lo);
    const int c1 = min((t % tl.n_cols + 1) * tl.cols, bx.c_hi + 1);
    const int ncol = c1 - c0;
    const int npix = (ncol > 0 && r1 > r0) ? ncol * (r1 - r0) : 0;
    for (int base = 0; base < npix; base += 32) {  // warp-uniform
      const int idx = base + lane;
      int tx = -1;
      float dcol[3];
      if (idx < npix) {
        const int row = r0 + idx / ncol;
        const int col = c0 + idx % ncol;
        pair_grad(c, pixel_x(col, S, prm), pixel_y(row, S, prm), pix, plane,
                  ((size_t)b * S + row) * S + col, prm, tex_res, acc, &tx,
                  dcol);
      }
      if (tex_res > 0) warp_texel_add(tacc[warp], tx, dcol, lane);
    }
  }

  // --- fixed-order warp reduction, then the warp writes its face's row
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0) red[warp][j] = v;
  }
  __syncwarp();
  float* g = grad + ((size_t)b * F + f) * K;
  for (int slot = lane; slot < K; slot += 32)
    g[slot] = grad_slot(slot, red[warp], tacc[warp], tex_res);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tex_res or face count the
// kernel does not take). consts: (B, F, K) float32 with F a multiple of 16
// and K >= 59 + 3 tex_res^2; spans (B, T * 2), masks (B, T * n_words) int32
// from chunks.compute_chunk_info for the T = n_rows * n_cols tiles of
// tile_rows x tile_cols pixels; pix: (16, B, S, S) float32, the planes of
// raster_bwd.cu; grad: (B, F, K) float32. All contiguous device memory.
extern "C" int raster_fused_bwd_chunk(
    const float* consts, const int* spans, const int* masks,
    const float* pix, int B, int F, int S, int K, int tex_res,
    int tile_rows, int tile_cols, int n_rows, int n_cols, int n_words,
    float inv_sigma1, float inv_sigma2, float inv_gamma_d,
    float inv_gamma_t, float near_, float far_, float inv_range,
    float bg_eps, float z_offset, float cut1, float cut2, float pad,
    float inv_s, float* grad, void* stream) {
  if (tex_res < 0 || tex_res > MAX_TEX_RES || used_slots(tex_res) > K ||
      F % FF)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0) return 0;
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  Tiles tl{tile_rows, tile_cols, n_rows, n_cols, n_words};
  dim3 grid(F / FF, B);
  raster_bwd_chunk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      consts, spans, masks, pix, F, S, B, K, tex_res, tl, prm, grad);
  return (int)cudaGetLastError();
}
