// Fused soft-rasterizer backward for Hopper (sm_90a), kernel B2.
//
// Replaces the TPU kernel `_bwd_kernel_compact`
// (selfcorr_tpu/ops/rasterizer/pallas_raster.py:1177, per-group math
// `_bwd_chunk_grads` :877, launched by _bwd_call :1340 -> pl.pallas_call
// :1385 from the custom VJP _core_bwd :1418), its `tex_res` arm included
// (:1016-1020). Computes exactly what the plain PyTorch version
// `raster_fused_bwd_plain` (../reference.py) computes: the gradient of the
// loss with respect to the packed (B, F, K) face constants (../common.py
// pack_constants), given the forward's residual planes and the cotangents
// of alpha1, alpha2, depth and the texture rgb.
//
// Gradient semantics (the TPU kernel's, which are the SoftRas CUDA
// backward's): interpolation weights are constants, so the barycentric,
// front, bbox and hard-texture slots get zero; the coverage cotangent is
// g * p_tot / max(1 - D, 1e-6); the depth chain runs where sigma1 covers;
// texture weights are contrib2 & z_ok; dis2 takes its gradient from the
// FIRST minimizing edge; zn -> zp -> 1/z. Slots SEG (9), E2 (3), PC (9),
// IZ (3), Z (3) get gradient, and STEX (9) or, with tex_res = R > 0, the
// 3 R^2 surface texel slots, each pixel's texture cotangent going to the
// one texel it falls in.
//
// Design (simple first; tuning is later work):
//   * one block of 128 threads per (face, batch element), grid (F, B);
//   * the block's threads stride over the pixels of the face's bbox, padded
//     by the coverage cutoff radius (the forward's cull radius) and one
//     pixel of margin; a pixel outside it is farther than the cutoff from
//     the face, so no covered pair is missed;
//   * each thread recomputes the pair's geometry with the forward's own
//     operation order (raster_common.cuh pair_grad) and accumulates the 36
//     register slots;
//   * texel slots do not fit in registers (108 at R = 6): each warp keeps
//     its row in shared memory and adds each step's texels with a
//     fixed-order warp reduction (raster_common.cuh warp_texel_add);
//   * one fixed-order reduction per block (xor-shuffle butterfly within each
//     warp, then the four warps in order) writes the face's whole row. There
//     is no atomic, so the result is bit-identical from run to run, as the
//     TPU kernel's fixed-order reduction is (pallas_raster.py:29-31).
//
// What bounds it on an H100: arithmetic. Each covered (face, pixel) pair
// costs ~260 fp32 operations (geometry 97, two sigmoids, two exps, the
// chains and 36 accumulations) while the bytes are 16 planes and the
// constants read once and the gradient written once.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
raster_bwd_kernel(const float* __restrict__ consts,
                  const float* __restrict__ pix, int F, int S, int B, int K,
                  int tex_res, Params prm, float* __restrict__ grad) {
  __shared__ float c[MAX_USED];
  __shared__ float red[WARPS][NACC];
  __shared__ float tacc[WARPS][MAX_USED - N_SLOTS];

  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int used = used_slots(tex_res);
  const int n_tex = used - N_SLOTS;
  const float* cf = consts + ((size_t)b * F + f) * K;
  for (int k = tid; k < used; k += THREADS) c[k] = cf[k];
  for (int k = lane; k < n_tex; k += 32) tacc[warp][k] = 0.0f;
  __syncthreads();

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  const PixBox bx = face_box(c, S, prm);
  const int ncol = bx.c_hi - bx.c_lo + 1;
  const int npix =
      (ncol > 0 && bx.r_hi >= bx.r_lo) ? ncol * (bx.r_hi - bx.r_lo + 1) : 0;
  const size_t plane = (size_t)B * S * S;

  // warp-uniform trip count: thread tid visits pixels tid, tid + 128, ...
  for (int base = warp * 32; base < npix; base += THREADS) {
    const int idx = base + lane;
    int t = -1;
    float dcol[3];
    if (idx < npix) {
      const int row = bx.r_lo + idx / ncol;
      const int col = bx.c_lo + idx % ncol;
      pair_grad(c, pixel_x(col, S, prm), pixel_y(row, S, prm), pix, plane,
                ((size_t)b * S + row) * S + col, prm, tex_res, acc, &t,
                dcol);
    }
    if (tex_res > 0) warp_texel_add(tacc[warp], t, dcol, lane);
  }

  // --- fixed-order block reduction: butterfly in each warp, warps in order
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const float v = warp_sum(acc[j]);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (tid < NACC) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][tid];
    red[0][tid] = v;
  }
  for (int k = tid; k < n_tex; k += THREADS) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += tacc[w][k];
    tacc[0][k] = v;
  }
  __syncthreads();
  for (int slot = tid; slot < K; slot += THREADS)
    grad[((size_t)b * F + f) * K + slot] =
        grad_slot(slot, red[0], tacc[0], tex_res);
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tex_res the kernel does not
// take). consts: (B, F, K) float32; pix: (16, B, S, S) float32, the planes
// alpha1, alpha2, depth, texr, texg, texb, m_d, s_d, m_t, s_t of the
// forward, then the cotangents of alpha1, alpha2, depth, texr, texg, texb;
// grad: (B, F, K) float32. All contiguous device memory.
extern "C" int raster_fused_bwd(const float* consts, const float* pix, int B,
                                int F, int S, int K, int tex_res,
                                float inv_sigma1, float inv_sigma2,
                                float inv_gamma_d, float inv_gamma_t,
                                float near_, float far_, float inv_range,
                                float bg_eps, float z_offset, float cut1,
                                float cut2, float pad, float inv_s,
                                float* grad, void* stream) {
  if (tex_res < 0 || tex_res > MAX_TEX_RES || used_slots(tex_res) > K)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0) return 0;
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  dim3 grid(F, B);
  raster_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      consts, pix, F, S, B, K, tex_res, prm, grad);
  return (int)cudaGetLastError();
}
