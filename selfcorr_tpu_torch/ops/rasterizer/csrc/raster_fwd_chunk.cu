// Fused soft-rasterizer forward in the dense-chunk schedule for Hopper
// (sm_90a), kernel B1'.
//
// Replaces the TPU kernel `_fwd_kernel` (selfcorr_tpu/ops/rasterizer/
// pallas_raster.py:730, the same `pl.pallas_call` :1323 as B1's with
// `compact=False`), its `tex_res` arm included. Computes exactly what the
// plain PyTorch version `raster_fused_fwd_chunk_plain` (../reference.py)
// computes: the 13 planes of B1 (raster_fwd.cu), walking per image tile
// only the 16-face chunks that chunks.compute_chunk_info marks for it (the
// span [first, last + 1) and the bits of the tile's mask words).
//
// Design:
//   * blocks of WX = 4 warps, grid (T, parts, B): a block shades 32 columns
//     x 4 rows of one tile of chunks.tiles_for (16 x 64 pixels at
//     S = 256 / 320, else 8 x min(128, S)), a part of it; each warp owns a
//     sub-tile of SUB_COLS = 8 columns x LANE_ROWS = 4 rows, a pixel a lane
//     (raster_common.cuh SubTile): B1's sub-tiles. 64 registers a thread,
//     8 blocks an SM, so 8 blocks share a 16 x 64 tile's span and mask
//     words;
//   * the block walks the chunks of its tile's span whose bit is set, CPR
//     (fewer with texels, STAGE_BYTES) at a time: it stages their 16 face
//     rows each (a half-warp per row, float4 by float4, no division), and
//     each warp walks the staged faces in order, skipping those whose
//     padded bbox misses its sub-tile, with B1's test, register copy and
//     per-pair code (raster_common.cuh walk_staged, shade), B1's carries
//     and B1's epilogue;
//   * faces are walked in ascending packed order in both kernels and a pair
//     that no sigma covers changes nothing, so B1' equals B1 bit for bit
//     when the chunk cull keeps every covering pair (the cull radius is
//     B1's, kernel.cull_pad).
//
// What bounds it on an H100: arithmetic, as B1: the pairs that do work cost
// ~170 fp32 operations each. The chunk cull adds only the bbox test of each
// face of a visited chunk; the pairs shaded are B1's (the same sub-tiles
// and test), but for faces the chunk cull drops on its own rounding.

#include <stdint.h>

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int CPR = 4;    // chunks staged at a time, at most
constexpr int WX = 4;     // warps a block: 32 columns of a tile
constexpr int MINB = 8;   // blocks an SM, the launch bound: 64 registers
constexpr int THREADS = 32 * WX, PART_COLS = WX * SUB_COLS;

__global__ void __launch_bounds__(THREADS, MINB)
raster_fwd_chunk_kernel(const float* __restrict__ consts,
                        const int* __restrict__ spans,
                        const int* __restrict__ masks, int F, int S, int B,
                        int K, int tex_res, Tiles tl, int col_parts,
                        int cpr, Params prm, float* __restrict__ out) {
  extern __shared__ float4 sc4[];  // [cpr * FF][V]

  const int tile = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_tiles = tl.n_rows * tl.n_cols;
  const int trow0 = (tile / tl.n_cols) * tl.rows;
  const int tcol0 = (tile % tl.n_cols) * tl.cols;
  const int row_part = blockIdx.y / col_parts;
  const int col_part = blockIdx.y - row_part * col_parts;
  SubTile w;
  sub_tile(w, trow0 + row_part * LANE_ROWS,
           tcol0 + col_part * PART_COLS + warp * SUB_COLS,
           min(trow0 + tl.rows, S), min(tcol0 + tl.cols, S), S, prm);

  const int V = staged_vecs(tex_res), K4 = K / 4;
  const float4* cb4 =
      reinterpret_cast<const float4*>(consts + (size_t)b * F * K);
  const int* span = spans + ((size_t)b * n_tiles + tile) * 2;
  const int* words = masks + ((size_t)b * n_tiles + tile) * tl.n_words;
  const int c_end = span[1];
  for (int ci = span[0];;) {
    // the next cpr chunks of the span whose bit is set (the same in every
    // thread)
    int ids[CPR] = {}, m = 0;
#pragma unroll
    for (int p = 0; p < CPR; ++p) {
      if (p == cpr) break;
      while (ci < c_end && !((((unsigned)words[ci >> 5]) >> (ci & 31)) & 1u))
        ++ci;
      ids[p] = ci;
      if (ci < c_end) {
        ++m;
        ++ci;
      }
    }
    if (m == 0) break;
    // face j of the m chunks: face j % FF of chunk ids[j / FF], a
    // half-warp per face row
    for (int j = tid >> 4; j < m * FF; j += THREADS / 16) {
      int cid = ids[0];
#pragma unroll
      for (int p = 1; p < CPR; ++p)
        if (j / FF == p) cid = ids[p];
      stage_row(sc4 + j * V, cb4 + (size_t)(cid * FF + j % FF) * K4, V,
                tid & 15);
    }
    __syncthreads();
    if (w.any) walk_staged(sc4, m * FF, V, prm, tex_res, w);
    __syncthreads();
  }
  write_sub_tile(w, out, B, S, b);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tile, tex_res, K or alignment
// the kernel does not take: tiles of 8 or 16 rows). consts: (B, F, K)
// float32, 16-byte aligned, with F a multiple of 16 and K a multiple of 4,
// >= 59 + 3 tex_res^2; spans (B, T * 2), masks (B, T * n_words) int32 from
// chunks.compute_chunk_info for the T = n_rows * n_cols tiles of
// tile_rows x tile_cols pixels; out: (13, B, S, S) float32. All contiguous
// device memory.
extern "C" int raster_fused_fwd_chunk(
    const float* consts, const int* spans, const int* masks, int B, int F,
    int S, int K, int tex_res, int tile_rows, int tile_cols, int n_rows,
    int n_cols, int n_words, float inv_sigma1, float inv_sigma2,
    float inv_gamma_d, float inv_gamma_t, float near_, float far_,
    float inv_range, float bg_eps, float z_offset, float cut1, float cut2,
    float pad, float inv_s, float* out, void* stream) {
  if (tex_res < 0 || tex_res > MAX_TEX_RES || K % 4 ||
      4 * staged_vecs(tex_res) > K || ((uintptr_t)consts & 15) || F % FF ||
      (tile_rows != 2 * LANE_ROWS && tile_rows != 4 * LANE_ROWS) ||
      tile_cols < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_rows * n_cols == 0) return 0;
  const Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_,
                   far_, inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  const Tiles tl{tile_rows, tile_cols, n_rows, n_cols, n_words};
  const int chunk = FF * staged_vecs(tex_res) * (int)sizeof(float4);
  const int cpr = min(CPR, max(1, STAGE_BYTES / chunk));
  const size_t smem = (size_t)cpr * chunk;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        raster_fwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int col_parts = (tl.cols + PART_COLS - 1) / PART_COLS;
  const dim3 grid(tl.n_rows * tl.n_cols, col_parts * (tl.rows / LANE_ROWS),
                  B);
  raster_fwd_chunk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      consts, spans, masks, F, S, B, K, tex_res, tl, col_parts, cpr, prm,
      out);
  return (int)cudaGetLastError();
}
