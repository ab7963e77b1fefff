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
// Design:
//   * one warp per (face, batch element), four faces to a block of 128
//     threads, grid (ceil(F / 4), B); each warp stages its face's used slots
//     in shared memory and never waits on another warp;
//   * the warp walks the pixels of the face's bbox, padded by the coverage
//     cutoff radius (the forward's cull radius) and one pixel of margin (a
//     pixel outside it is farther than the cutoff from the face, so no
//     covered pair is missed), 32 at a time in row-major order; a lane
//     steps its (row, column) by 32 pixels with no integer divide, and its
//     integers become floats by bit arithmetic, not on the quarter-rate
//     conversion unit;
//   * compact first, then compute: each lane runs only the pair's geometry
//     up to the cover test (raster_common.cuh pair_geom, the forward's
//     operation order); the covered pixels go, in pixel order (__ballot_sync
//     and __popc), into the warp's queue in shared memory with their
//     geometry; whenever the queue holds 32, every lane takes one and runs
//     the chains (pair_chain): the 16 plane loads, two sigmoids, two
//     softmax weights and the accumulations, with no lane idle but in the
//     face's last, partial batch;
//   * the planes come image-major, (B, 16, S, S), so that one pixel's 16
//     loads lie at offsets of S^2 floats from one address: at S = 256 (a
//     kernel of its own) those offsets are immediates, with no address
//     arithmetic per load;
//   * dis2 passes its gradient to its first minimizing edge only; its terms
//     are formed once and added to that edge's 7 slots only;
//   * 36 slots per lane: the 21 edge slots in a column of shared memory
//     (each pair adds to its edge's 7; raster_common.cuh ColumnEdges), the
//     other 15 in registers, so that 80 registers hold a thread and 6
//     blocks fit an SM; texel slots do not fit in registers (108 at R = 6):
//     each warp keeps its row in shared memory and adds each batch's texels
//     with a fixed-order warp reduction (raster_common.cuh
//     warp_texel_add);
//   * a fixed-order xor-shuffle butterfly reduces each slot over the lanes
//     and the warp writes its face's whole row. There is no atomic, so the
//     result is bit-identical from run to run, as the TPU kernel's
//     fixed-order reduction is (pallas_raster.py:29-31). Only the order of
//     each face's sums differs from the plain version's.
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

namespace {

using namespace raster;

constexpr int WARPS = 4;  // faces per block, one warp each
constexpr int THREADS = 32 * WARPS;
constexpr int QCAP = 64;  // queue entries per warp (< 32 + 32)

// A warp's queue of covered pixels with their centres and geometry
// (pair_geom).
struct Queue {
  int pix[QCAP];    // the pixel's offset in its (B, S, S) plane
  int flags[QCAP];  // e_min | inside << 2
  float x[QCAP], y[QCAP], w0[QCAP], w1[QCAP], w2[QCAP], dis2[QCAP],
      sp[QCAP];
};

// (float)i for 0 <= i < 2^23, exact, without the quarter-rate conversion
// unit: i in the mantissa of 2^23, minus 2^23
__device__ __forceinline__ float small_float(int i) {
  return __int_as_float(0x4B000000 | i) - 8388608.0f;
}

// SF > 0: the kernel for image size SF, whose plane offsets (multiples of
// SF^2 floats) become immediates of the loads; SF = 0: any S. 6 blocks an
// SM: 80 registers a thread.
template <int SF>
__global__ void __launch_bounds__(THREADS, 6)
raster_bwd_kernel(const float* __restrict__ consts,
                  const float* __restrict__ pix, int F, int S_, int K,
                  int tex_res, Params prm, float* __restrict__ grad) {
  __shared__ float sc[WARPS][MAX_USED];
  __shared__ float red[WARPS][NACC];
  __shared__ float tacc[WARPS][MAX_USED - N_SLOTS];
  __shared__ Queue queues[WARPS];
  // each lane's 21 edge slots (raster_common.cuh ColumnEdges)
  __shared__ float eacc[WARPS][21 * 32];

  const int S = SF > 0 ? SF : S_;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * WARPS + warp;
  const int b = blockIdx.y;
  if (f >= F) return;  // a whole warp; nothing below syncs the block
  const int used = used_slots(tex_res);
  const int n_tex = used - N_SLOTS;
  const float* cf = consts + ((size_t)b * F + f) * K;
  float* c = sc[warp];
  for (int k = lane; k < used; k += 32) c[k] = cf[k];
  for (int k = lane; k < n_tex; k += 32) tacc[warp][k] = 0.0f;
  const ColumnEdges edges{eacc[warp] + lane};
#pragma unroll
  for (int j = 0; j < 21; ++j) edges.col[32 * j] = 0.0f;
  __syncwarp();

  float acc[NACC];  // slots 21..35 (0..20 live in eacc)
#pragma unroll
  for (int j = 21; j < NACC; ++j) acc[j] = 0.0f;

  const PixBox bx = face_box(c, S, prm);
  const int ncol = bx.c_hi - bx.c_lo + 1;
  const int npix =
      (ncol > 0 && bx.r_hi >= bx.r_lo) ? ncol * (bx.r_hi - bx.r_lo + 1) : 0;
  const float inv_ncol = npix > 0 ? 1.0f / (float)ncol : 0.0f;
  // image b's 16 planes, S^2 floats apart
  const size_t plane = (size_t)S * S;
  const float* img = pix + (size_t)b * 16 * plane;
  Queue& q = queues[warp];
  int head = 0, count = 0;  // warp-uniform

  // every lane below n takes queue entry head + lane and runs its chains;
  // all 32 lanes call it together
  auto drain = [&](int n) {
    int t = -1;
    float dcol[3];
    if (lane < n) {
      const int e = (head + lane) & (QCAP - 1);
      const PairGeom g{q.w0[e], q.w1[e], q.w2[e], q.dis2[e], q.sp[e],
                       q.flags[e] & 3, (q.flags[e] >> 2) != 0};
      pair_chain(c, q.x[e], q.y[e], g, img, plane, q.pix[e], prm, tex_res,
                 edges, acc, &t, dcol);
    }
    if (tex_res > 0) warp_texel_add(tacc[warp], t, dcol, lane);
    head += n;
    count -= n;
  };

  // lane's pixel (r, cc) of the box, row-major; it moves on by 32 pixels a
  // step
  int r = (int)((small_float(lane) + 0.5f) * inv_ncol);
  int cc = lane - r * ncol;
  if (cc >= ncol) {
    ++r;
    cc -= ncol;
  }
  const float fs = (float)S;
  for (int base = 0; base < npix; base += 32) {  // warp-uniform
    const int row = bx.r_lo + r, col = bx.c_lo + cc;
    // common.pixel_grid, as pixel_x / pixel_y compute it
    const float x = (2.0f * small_float(col) + 1.0f - fs) * prm.inv_s;
    const float y = ((fs - 1.0f) - 2.0f * small_float(row)) * prm.inv_s;
    PairGeom g;
    const bool cov = base + lane < npix && pair_geom(c, x, y, prm, g);
    const unsigned m = __ballot_sync(FULL, cov);
    if (cov) {
      const int e =
          (head + count + __popc(m & ((1u << lane) - 1u))) & (QCAP - 1);
      q.pix[e] = row * S + col;
      q.flags[e] = g.e_min | ((int)g.inside << 2);
      q.x[e] = x;
      q.y[e] = y;
      q.w0[e] = g.w0;
      q.w1[e] = g.w1;
      q.w2[e] = g.w2;
      q.dis2[e] = g.dis2;
      q.sp[e] = g.sp;
    }
    count += __popc(m);
    cc += 32;
    while (cc >= ncol) {
      ++r;
      cc -= ncol;
    }
    __syncwarp();
    if (count >= 32) {
      drain(32);
      __syncwarp();
    }
  }
  if (count > 0) drain(count);

  // --- fixed-order butterfly, then the warp writes its face's row
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const float v = warp_sum(j < 21 ? edges.col[32 * j] : acc[j]);
    if (lane == 0) red[warp][j] = v;
  }
  __syncwarp();
  float* gr = grad + ((size_t)b * F + f) * K;
  for (int slot = lane; slot < K; slot += 32)
    gr[slot] = grad_slot(slot, red[warp], tacc[warp], tex_res);
}

}  // namespace

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
      S > 2048)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || F == 0) return 0;
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  dim3 grid((F + WARPS - 1) / WARPS, B);
  if (S == 256)  // the training renders
    raster_bwd_kernel<256><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        consts, pix, F, S, K, tex_res, prm, grad);
  else
    raster_bwd_kernel<0><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        consts, pix, F, S, K, tex_res, prm, grad);
  return (int)cudaGetLastError();
}
