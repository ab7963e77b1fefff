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
// Design (simple first; tuning is later work):
//   * one block of 256 threads per (tile, batch element), grid (T, B), the
//     tiles of chunks.tiles_for: 16 x 64 pixels at S = 256 / 320, else
//     8 x min(128, S); each thread shades up to 4 pixels of the tile (its
//     carries in registers);
//   * the block reads its span and mask words; for each chunk in the span
//     whose bit is set it stages the chunk's 16 face rows (their used slots)
//     in shared memory, and each thread shades its pixels against those 16
//     faces in order with B1's per-pair code (raster_common.cuh shade),
//     B1's carries and B1's epilogue;
//   * faces are walked in ascending packed order in both kernels and a pair
//     that no sigma covers changes nothing, so B1' equals B1 bit for bit
//     when the chunk cull keeps every covering pair (the cull radius is
//     B1's, kernel.cull_pad).
//
// What bounds it on an H100: arithmetic, as B1: the pairs that do work cost
// ~180 fp32 operations each. The chunk schedule adds the geometry of every
// pair of a visited chunk that covers nothing (a 16 x 64 tile against 16
// faces whose chunk bbox touches it); that is the kernel's cost, not the
// function's.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int THREADS = 256;
constexpr int PPT = 4;  // pixels per thread: tiles of up to 1024 pixels

__global__ void __launch_bounds__(THREADS)
raster_fwd_chunk_kernel(const float* __restrict__ consts,
                        const int* __restrict__ spans,
                        const int* __restrict__ masks, int F, int S, int B,
                        int K, int tex_res, Tiles tl, Params prm,
                        float* __restrict__ out) {
  __shared__ float sc[FF * MAX_USED];  // [FF][used]

  const int used = used_slots(tex_res);
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_tiles = tl.n_rows * tl.n_cols;
  const int row0 = (tile / tl.n_cols) * tl.rows;
  const int col0 = (tile % tl.n_cols) * tl.cols;

  float px[PPT], py[PPT], pp[PPT];
  bool valid[PPT];
  Carry q[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * THREADS;
    const int row = row0 + p / tl.cols;
    const int col = col0 + p % tl.cols;
    valid[k] = (p < tl.rows * tl.cols) && (row < S) && (col < S);
    px[k] = pixel_x(col, S, prm);
    py[k] = pixel_y(row, S, prm);
    pp[k] = px[k] * px[k] + py[k] * py[k];
    q[k] = carry_init(prm);
  }

  const float* cb = consts + (size_t)b * F * K;
  const int* span = spans + ((size_t)b * n_tiles + tile) * 2;
  const int* words = masks + ((size_t)b * n_tiles + tile) * tl.n_words;
  const int c_end = span[1];
  for (int ci = span[0]; ci < c_end; ++ci) {
    if (!((((unsigned)words[ci >> 5]) >> (ci & 31)) & 1u)) continue;
    for (int k = tid; k < FF * used; k += THREADS) {
      const int j = k / used;
      const int sl = k - j * used;
      sc[k] = cb[(size_t)(ci * FF + j) * K + sl];
    }
    __syncthreads();
    for (int j = 0; j < FF; ++j) {
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (valid[k]) shade(sc + j * used, px[k], py[k], pp[k], prm, tex_res,
                            q[k]);
    }
    __syncthreads();
  }

  const size_t plane = (size_t)B * S * S;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (!valid[k]) continue;
    const int p = tid + k * THREADS;
    const int row = row0 + p / tl.cols;
    const int col = col0 + p % tl.cols;
    write_planes(q[k], out, plane, ((size_t)b * S + row) * S + col);
  }
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tile or tex_res the kernel
// does not take). consts: (B, F, K) float32 with F a multiple of 16 and
// K >= 59 + 3 tex_res^2; spans (B, T * 2), masks (B, T * n_words) int32 from
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
  if (tex_res < 0 || tex_res > MAX_TEX_RES || used_slots(tex_res) > K ||
      tile_rows * tile_cols > THREADS * PPT || F % FF)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n_rows * n_cols == 0) return 0;
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  Tiles tl{tile_rows, tile_cols, n_rows, n_cols, n_words};
  dim3 grid(n_rows * n_cols, B);
  raster_fwd_chunk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      consts, spans, masks, F, S, B, K, tex_res, tl, prm, out);
  return (int)cudaGetLastError();
}
