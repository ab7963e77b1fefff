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
// order (:1167); blocks on Hopper run in no order. Here B2' is B2's kernel
// (raster_common.cuh raster_bwd_kernel, CHUNKED = true): one warp per
// (face, batch element), the walk of the face's padded box, the queue of
// covered pixels and the chains 32 pairs at a time, a fixed-order reduction
// and no atomic. The chunk cull enters as one test per pixel: the warp
// stages, for the tiles its box touches, whether the tile's span holds its
// chunk ci = f / 16 and the tile's bit for ci is set, and runs the cover
// test only on pixels of such tiles.
//
// The cull is conservative with respect to the box: compute_chunk_info
// tests each chunk's bbox (the union of its faces') padded by the same
// radius as face_box against each tile. So every covered pair of B2 lies in
// a visited tile but for the cull's own rounding, B2''s queue is B2's, and
// B2' equals B2 bit for bit on the same constants, planes and cotangents.
//
// What bounds it on an H100: arithmetic, as B2: ~250 fp32 operations per
// covered pair; the bytes are the 16 planes, the constants and the cull read
// once and the gradient written once.

#include "raster_common.cuh"

using namespace raster;

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tex_res, face count, image
// size or tile geometry the kernel does not take). consts: (B, F, K)
// float32 with F a multiple of 16 and K >= 59 + 3 tex_res^2; spans
// (B, T * 2), masks (B, T * n_words) int32 from chunks.compute_chunk_info
// for the T = n_rows * n_cols tiles of tile_rows x tile_cols pixels
// (chunks.tiles_for: 8 or 16 rows; 64 or 128 columns, or one column of
// S < 128); pix: (B, 16, S, S) float32, the image-major planes of
// raster_bwd.cu; grad: (B, F, K) float32. All contiguous device memory.
extern "C" int raster_fused_bwd_chunk(
    const float* consts, const int* spans, const int* masks,
    const float* pix, int B, int F, int S, int K, int tex_res,
    int tile_rows, int tile_cols, int n_rows, int n_cols, int n_words,
    float inv_sigma1, float inv_sigma2, float inv_gamma_d,
    float inv_gamma_t, float near_, float far_, float inv_range,
    float bg_eps, float z_offset, float cut1, float cut2, float pad,
    float inv_s, float* grad, void* stream) {
  const bool cols_ok = tile_cols == 64 || tile_cols == 128 ||
                       (tile_cols == S && S < 128);
  if (tex_res < 0 || tex_res > MAX_TEX_RES || used_slots(tex_res) > K ||
      F % FF || S > MAX_S_BWD || (tile_rows != 8 && tile_rows != 16) ||
      !cols_ok || n_rows != (S + tile_rows - 1) / tile_rows ||
      n_cols != (S + tile_cols - 1) / tile_cols ||
      n_rows * n_cols > MAX_TILES || n_words * 32 < F / FF)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0) return 0;
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  Tiles tl{tile_rows, tile_cols, n_rows, n_cols, n_words};
  return launch_bwd<true>(consts, spans, masks, pix, B, F, S, K, tex_res,
                          tl, prm, grad, stream);
}
