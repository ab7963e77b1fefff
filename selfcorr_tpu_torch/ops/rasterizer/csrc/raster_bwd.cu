// Fused soft-rasterizer backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel_compact`
// (selfcorr_tpu/ops/rasterizer/pallas_raster.py:1177, per-group math
// `_bwd_chunk_grads` :877, launched by _bwd_call :1340 -> pl.pallas_call
// :1385 from the custom VJP _core_bwd :1418). Computes exactly what the plain
// PyTorch version `raster_fused_bwd_plain` (../reference.py) computes: the
// gradient of the loss with respect to the packed (B, F, 64) face constants
// (../common.py pack_constants), given the forward's residual planes and the
// cotangents of alpha1, alpha2, depth and the texture rgb.
//
// Gradient semantics (the TPU kernel's, which are the SoftRas CUDA
// backward's): interpolation weights are constants, so the barycentric,
// front, bbox and hard-texture slots get zero; the coverage cotangent is
// g * p_tot / max(1 - D, 1e-6); the depth chain runs where sigma1 covers;
// texture weights are contrib2 & z_ok; dis2 takes its gradient from the
// FIRST minimizing edge; zn -> zp -> 1/z. 36 slots get gradient: SEG (9),
// E2 (3), PC (9), IZ (3), Z (3), STEX (9).
//
// Design (simple first; tuning is later work):
//   * one block of 128 threads per (face, batch element), grid (F, B);
//   * the block's threads stride over the pixels of the face's bbox, padded
//     by the coverage cutoff radius (the forward's cull radius) and one
//     pixel of margin; a pixel outside it is farther than the cutoff from
//     the face, so no covered pair is missed;
//   * each thread recomputes the pair's geometry with the forward kernel's
//     own operation order (csrc/raster_fwd.cu shade) and accumulates the 36
//     slots in registers;
//   * one fixed-order reduction per block (xor-shuffle butterfly within each
//     warp, then the four warps in order) writes the face's whole row. There
//     is no atomic, so the result is bit-identical from run to run, as the
//     TPU kernel's fixed-order reduction is (pallas_raster.py:29-31).
//
// What bounds it on an H100: arithmetic. Each covered (face, pixel) pair
// costs ~260 fp32 operations (geometry 97, two sigmoids, two exps, the
// chains and 36 accumulations) while the bytes are 16 planes and the
// constants read once and the gradient written once. Built with
// -fmad=false so the geometry rounds as the forward and the plain version
// do: the sigma = 1e-4 sigmoid derivative D(1-D)/sigma is ~1e4x larger than
// its inputs at edges, and the inside / cutoff / first-edge decisions must
// be the forward's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int K = 64;        // packed slots per face (common.K)
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NACC = 36;     // slots that get gradient

constexpr int S_WA = 0, S_SEG = 9, S_E2 = 18, S_PC = 21, S_IZ = 30,
              S_Z = 33, S_BBOX = 37, S_STEX = 41;
// accumulator j -> packed slot: SEG, E2, PC, IZ, Z are slots 9..35
// (j = 0..26), STEX is slots 41..49 (j = 27..35)

struct Params {
  float inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t;
  float near_, far_, inv_range, z_offset;
  float cut1, cut2;  // sigma * DIST_CUT
  float pad;         // cull radius, >= sqrt(max(sigma) * DIST_CUT)
  float inv_s;       // 1 / S
};

__global__ void __launch_bounds__(THREADS)
raster_bwd_kernel(const float* __restrict__ consts,
                  const float* __restrict__ pix, int F, int S, int B,
                  Params prm, float* __restrict__ grad) {
  __shared__ float c[K];
  __shared__ float red[WARPS][NACC];

  const int f = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* cf = consts + ((size_t)b * F + f) * K;
  if (tid < K) c[tid] = cf[tid];
  __syncthreads();

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.0f;

  // pixel range of the padded bbox: column c has x = (2c + 1 - S) / S,
  // row r has y = (S - 1 - 2r) / S
  const float fs = (float)S;
  const float xlo = c[S_BBOX + 0] - prm.pad, xhi = c[S_BBOX + 1] + prm.pad;
  const float ylo = c[S_BBOX + 2] - prm.pad, yhi = c[S_BBOX + 3] + prm.pad;
  int c_lo = 0, c_hi = -1, r_lo = 0, r_hi = -1;
  // NaN bounds fail these tests, and such a face is skipped, as the
  // forward kernel's bbox cull skips it
  if (xlo <= 2.0f && xhi >= -2.0f && ylo <= 2.0f && yhi >= -2.0f) {
    const float cl = fmaxf((xlo * fs + fs - 1.0f) * 0.5f, 0.0f);
    const float ch = fminf((xhi * fs + fs - 1.0f) * 0.5f, fs - 1.0f);
    const float rl = fmaxf((fs - 1.0f - yhi * fs) * 0.5f, 0.0f);
    const float rh = fminf((fs - 1.0f - ylo * fs) * 0.5f, fs - 1.0f);
    c_lo = max((int)floorf(cl) - 1, 0);
    c_hi = min((int)ceilf(ch) + 1, S - 1);
    r_lo = max((int)floorf(rl) - 1, 0);
    r_hi = min((int)ceilf(rh) + 1, S - 1);
  }
  const int ncol = c_hi - c_lo + 1;
  const int npix = (ncol > 0 && r_hi >= r_lo) ? ncol * (r_hi - r_lo + 1) : 0;
  const size_t plane = (size_t)B * S * S;

  for (int idx = tid; idx < npix; idx += THREADS) {
    const int row = r_lo + idx / ncol;
    const int col = c_lo + idx % ncol;
    const float x = (2.0f * (float)col + 1.0f - fs) * prm.inv_s;
    const float y = ((float)(S - 1) - 2.0f * (float)row) * prm.inv_s;
    const float p2 = x * x + y * y;

    // --- geometry, in the forward kernel's operation order
    const float w0 = c[S_WA + 0] * x + c[S_WA + 1] * y + c[S_WA + 2];
    const float w1 = c[S_WA + 3] * x + c[S_WA + 4] * y + c[S_WA + 5];
    const float w2 = c[S_WA + 6] * x + c[S_WA + 7] * y + c[S_WA + 8];
    const bool inside = (w0 > 0.0f) && (w0 < 1.0f) && (w1 > 0.0f) &&
                        (w1 < 1.0f) && (w2 > 0.0f) && (w2 < 1.0f);
    float sp[3], tt[3], d2e[3];
    float dis2 = INFINITY;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      sp[e] = c[S_SEG + 3 * e] * x + c[S_SEG + 3 * e + 1] * y +
              c[S_SEG + 3 * e + 2];
      tt[e] = fminf(fmaxf(sp[e], 0.0f), 1.0f);
      const float pv0 = p2 + c[S_PC + 3 * e] * x +
                        c[S_PC + 3 * e + 1] * y + c[S_PC + 3 * e + 2];
      d2e[e] = fmaxf(pv0 - tt[e] * (2.0f * sp[e] - tt[e]) * c[S_E2 + e],
                     0.0f);
      dis2 = fminf(dis2, d2e[e]);
    }
    const bool con1 = inside || (dis2 < prm.cut1);
    const bool con2 = inside || (dis2 < prm.cut2);
    if (!(con1 || con2)) continue;  // every term below is zero
    const float sgn = inside ? 1.0f : -1.0f;
    const float sdis = inside ? -dis2 : dis2;  // -sign * dis2
    const float d1 = con1 ? 1.0f / (1.0f + expf(sdis * prm.inv_sigma1)) : 0.0f;
    const float d2 = con2 ? 1.0f / (1.0f + expf(sdis * prm.inv_sigma2)) : 0.0f;

    float c0 = fminf(fmaxf(w0, 0.0f), 1.0f);
    float c1 = fminf(fmaxf(w1, 0.0f), 1.0f);
    float c2 = fminf(fmaxf(w2, 0.0f), 1.0f);
    const float wsum = fmaxf(c0 + c1 + c2, 1e-5f);
    c0 = c0 / wsum;
    c1 = c1 / wsum;
    c2 = c2 / wsum;
    const float zp =
        1.0f / (c0 * c[S_IZ] + c1 * c[S_IZ + 1] + c2 * c[S_IZ + 2]);
    const bool z_ok = (zp >= prm.near_) && (zp <= prm.far_);
    const float zn = (prm.far_ - zp) * prm.inv_range;

    // --- this pixel's residuals and cotangents
    const size_t o = ((size_t)b * S + row) * S + col;
    const float p1_tot = 1.0f - pix[0 * plane + o];
    const float p2_tot = 1.0f - pix[1 * plane + o];
    const float out_d = pix[2 * plane + o];
    const float out_r = pix[3 * plane + o];
    const float out_g = pix[4 * plane + o];
    const float out_b = pix[5 * plane + o];
    const float m_d = pix[6 * plane + o];
    const float s_d = pix[7 * plane + o];
    const float m_t = pix[8 * plane + o];
    const float s_t = pix[9 * plane + o];
    const float g_a1 = pix[10 * plane + o];
    const float g_a2 = pix[11 * plane + o];
    const float g_d = pix[12 * plane + o];
    const float g_r = pix[13 * plane + o];
    const float g_g = pix[14 * plane + o];
    const float g_b = pix[15 * plane + o];

    // --- coverage (alpha2) chain
    float dL_dD2 = g_a2 * p2_tot / fmaxf(1.0f - d2, 1e-6f);

    // --- alpha1 + depth softmax chain, where sigma1 covers
    float ddis2_1 = 0.0f, dzn_1 = 0.0f, dL_dval = 0.0f;
    if (con1) {
      const float u_d =
          z_ok ? expf((zn - m_d) * prm.inv_gamma_d) / s_d : 0.0f;
      const float val_d = c0 * (c[S_Z] - prm.z_offset) +
                          c1 * (c[S_Z + 1] - prm.z_offset) +
                          c2 * (c[S_Z + 2] - prm.z_offset);
      const float r_d = val_d - out_d;
      const float wgt_d = d1 * u_d;
      const float dL_dD1 = g_a1 * p1_tot / fmaxf(1.0f - d1, 1e-6f) +
                           g_d * r_d * u_d;
      ddis2_1 = dL_dD1 * sgn * d1 * (1.0f - d1) * prm.inv_sigma1;
      dzn_1 = g_d * r_d * wgt_d * prm.inv_gamma_d;
      dL_dval = g_d * wgt_d;
    }

    // --- texture softmax chain
    const float u_t =
        (con2 && z_ok) ? expf((zn - m_t) * prm.inv_gamma_t) / s_t : 0.0f;
    const float col_r = c0 * c[S_STEX + 0] + c1 * c[S_STEX + 3] +
                        c2 * c[S_STEX + 6];
    const float col_g = c0 * c[S_STEX + 1] + c1 * c[S_STEX + 4] +
                        c2 * c[S_STEX + 7];
    const float col_b = c0 * c[S_STEX + 2] + c1 * c[S_STEX + 5] +
                        c2 * c[S_STEX + 8];
    const float gr_dot = g_r * (col_r - out_r) + g_g * (col_g - out_g) +
                         g_b * (col_b - out_b);
    const float wgt_t = d2 * u_t;
    dL_dD2 = dL_dD2 + gr_dot * u_t;
    const float dL_dzn = dzn_1 + gr_dot * wgt_t * prm.inv_gamma_t;
    const float dcol_r = g_r * wgt_t;
    const float dcol_g = g_g * wgt_t;
    const float dcol_b = g_b * wgt_t;

    // --- D -> dis2, zn -> zp -> 1/z
    const float dL_ddis2 =
        ddis2_1 + dL_dD2 * sgn * d2 * (1.0f - d2) * prm.inv_sigma2;
    const float dL_dzp = -dL_dzn * prm.inv_range;
    const float zp2 = zp * zp;

    // --- dis2 -> the first minimizing edge's coefficients
    int e_min = 2;
    if (d2e[1] == dis2) e_min = 1;
    if (d2e[0] == dis2) e_min = 0;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float f_e = (e == e_min) ? dL_ddis2 : 0.0f;
      const float ds_raw = f_e * (-2.0f * tt[e] * c[S_E2 + e]);
      acc[3 * e + 0] += ds_raw * x;
      acc[3 * e + 1] += ds_raw * y;
      acc[3 * e + 2] += ds_raw;
      acc[9 + e] += f_e * (tt[e] * tt[e] - 2.0f * tt[e] * sp[e]);
      acc[12 + 3 * e + 0] += f_e * x;
      acc[12 + 3 * e + 1] += f_e * y;
      acc[12 + 3 * e + 2] += f_e;
    }
    acc[21] += -dL_dzp * zp2 * c0;
    acc[22] += -dL_dzp * zp2 * c1;
    acc[23] += -dL_dzp * zp2 * c2;
    acc[24] += dL_dval * c0;
    acc[25] += dL_dval * c1;
    acc[26] += dL_dval * c2;
    acc[27] += dcol_r * c0;
    acc[28] += dcol_g * c0;
    acc[29] += dcol_b * c0;
    acc[30] += dcol_r * c1;
    acc[31] += dcol_g * c1;
    acc[32] += dcol_b * c1;
    acc[33] += dcol_r * c2;
    acc[34] += dcol_g * c2;
    acc[35] += dcol_b * c2;
  }

  // --- fixed-order block reduction: butterfly in each warp, warps in order
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (tid < K) {
    // slot tid <- accumulator j (see the accumulator layout above)
    int j = -1;
    if (tid >= S_SEG && tid < S_SEG + 27) j = tid - S_SEG;
    if (tid >= S_STEX && tid < S_STEX + 9) j = 27 + (tid - S_STEX);
    float v = 0.0f;
    if (j >= 0) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w][j];
    }
    grad[((size_t)b * F + f) * K + tid] = v;
  }
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success). consts: (B, F, 64) float32; pix: (16, B, S, S) float32,
// the planes alpha1, alpha2, depth, texr, texg, texb, m_d, s_d, m_t, s_t of
// the forward, then the cotangents of alpha1, alpha2, depth, texr, texg,
// texb; grad: (B, F, 64) float32. All contiguous device memory.
extern "C" int raster_fused_bwd(const float* consts, const float* pix, int B,
                                int F, int S, float inv_sigma1,
                                float inv_sigma2, float inv_gamma_d,
                                float inv_gamma_t, float near_, float far_,
                                float inv_range, float z_offset, float cut1,
                                float cut2, float pad, float inv_s,
                                float* grad, void* stream) {
  if (B == 0 || F == 0) return 0;
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, z_offset, cut1, cut2, pad, inv_s};
  dim3 grid(F, B);
  raster_bwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      consts, pix, F, S, B, prm, grad);
  return (int)cudaGetLastError();
}
