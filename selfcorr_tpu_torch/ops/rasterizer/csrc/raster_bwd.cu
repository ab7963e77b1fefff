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
// Design: raster_common.cuh raster_bwd_kernel (CHUNKED = false), the kernel
// B2' shares: one warp per face walks its padded box, compacts the covered
// pixels into a queue and runs the chains 32 queued pairs at a time; a
// fixed-order reduction and no atomic, so the result is bit-identical from
// run to run, as the TPU kernel's fixed-order reduction is
// (pallas_raster.py:29-31). Only the order of each face's sums differs from
// the plain version's.
//
// What bounds it on an H100: arithmetic. Each covered (face, pixel) pair
// costs ~250 fp32 operations (geometry 97, two sigmoids, two exps, the
// chains and the accumulations of one edge), several of them IEEE divisions
// and exponentials of many instructions each, while the bytes are 16 planes
// and the constants read once and the gradient written once. The cover test
// alone (~100 instructions) runs on every pixel of the padded box, 1.68
// times the covered pairs at the training inputs (70.6 M pixels, 42.0 M
// pairs).

#include "raster_common.cuh"

using namespace raster;

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success; cudaErrorInvalidValue for a tex_res or an image size
// S > 2048 the kernel does not take). consts: (B, F, K) float32; pix:
// (B, 16, S, S) float32, each image's planes alpha1, alpha2, depth, texr,
// texg, texb, m_d, s_d, m_t, s_t of the forward, then the cotangents of
// alpha1, alpha2, depth, texr, texg, texb; grad: (B, F, K) float32. All
// contiguous device memory.
extern "C" int raster_fused_bwd(const float* consts, const float* pix, int B,
                                int F, int S, int K, int tex_res,
                                float inv_sigma1, float inv_sigma2,
                                float inv_gamma_d, float inv_gamma_t,
                                float near_, float far_, float inv_range,
                                float bg_eps, float z_offset, float cut1,
                                float cut2, float pad, float inv_s,
                                float* grad, void* stream) {
  if (tex_res < 0 || tex_res > MAX_TEX_RES || used_slots(tex_res) > K ||
      S > MAX_S_BWD)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0) return 0;
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  return launch_bwd<false>(consts, nullptr, nullptr, pix, B, F, S, K,
                           tex_res, Tiles{}, prm, grad, stream);
}
