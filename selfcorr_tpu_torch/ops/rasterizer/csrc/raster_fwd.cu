// Fused soft-rasterizer forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel_compact`
// (selfcorr_tpu/ops/rasterizer/pallas_raster.py:806, launched by _fwd_call
// :1285 -> pl.pallas_call :1323). Computes exactly what the plain PyTorch
// version `raster_fused_fwd_plain` (../reference.py) computes from the same
// packed (B, F, 64) face constants (../common.py pack_constants): the two
// 'prod' coverages, the gamma_d depth softmax (white background), the
// gamma_t texture softmax (white background), the hard nearest-face match
// and the four softmax residual planes. Output: 13 planes, (13, B, S, S)
// float32, in the order of reference.PLANES.
//
// Design (simple first; tuning is later work):
//   * one thread per pixel, 16x16 pixels per block, grid (S/16, S/16, B);
//   * faces are tested 256 at a time in their ORIGINAL order, one per
//     thread: the face's bbox, padded by the coverage cutoff radius, against
//     the block's pixel box; ballots compact the live ones, order preserved,
//     and they are staged through shared memory 64 at a time, so every
//     thread walks only the block's live faces;
//   * per pixel, the coverage products, running-max softmax carries and the
//     hard winner live in registers; the carries start at the background
//     fragment (max bg_eps, sum 1, accumulator 1) as the TPU kernel's do
//     (pallas_raster.py:847-850);
//   * the hard winner takes a face only on a strictly smaller z, walking
//     faces in order, so the earliest face wins exact ties;
//   * an excluded face never reaches an exponential, so no inf * 0 = nan.
//
// What bounds it on an H100: arithmetic. Each live (face, pixel) pair costs
// ~180 fp32 operations (three exps, two divisions), while the bytes are the
// constants read once plus 13 output planes written once. The bbox cull keeps
// the pair count near the faces' true support. Built with -fmad=false so
// each operation rounds as the plain version's separate PyTorch ops do:
// the sigma = 1e-4 sigmoid amplifies rounding differences ~1e4x at edges,
// and with gamma = 1e-4 one ulp of depth moves a softmax weight by ~1e-3.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int K = 64;        // packed slots per face (common.K)
constexpr int N_SLOTS = 59;  // slots carrying data (common.N_SLOTS)
constexpr int TILE = 16;     // block = TILE x TILE pixels
constexpr int THREADS = TILE * TILE;
constexpr int CH = 64;       // live faces staged in shared memory at a time

constexpr int S_WA = 0, S_SEG = 9, S_E2 = 18, S_PC = 21, S_IZ = 30,
              S_Z = 33, S_BBOX = 37, S_STEX = 41, S_HTEX = 50;

// Every division by a constant is a multiplication by its float32
// reciprocal, exactly as in the plain version (../reference.py).
struct Params {
  float inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t;
  float near_, far_, inv_range, bg_eps, z_offset;  // inv_range = 1/(far-near)
  float cut1, cut2;  // sigma * DIST_CUT, the outside-coverage cutoffs
  float pad;         // bbox cull radius, >= sqrt(max(sigma) * DIST_CUT)
  float inv_s;       // 1 / S for the pixel grid
};

struct Carry {
  float p1, p2c;                  // coverage products at sigma1, sigma2
  float m_d, s_d, a_d;            // depth softmax: max, sum, accumulator
  float m_t, s_t, a_r, a_g, a_b;  // texture softmax
  float zmin, h_r, h_g, h_b;      // hard winner: depth, texture
};

// One (face, pixel) pair: c points at the face's packed slots.
__device__ __forceinline__ void shade(const float* c, float x, float y,
                                     float p2, const Params& prm, Carry& q) {
  const float w0 = c[S_WA + 0] * x + c[S_WA + 1] * y + c[S_WA + 2];
  const float w1 = c[S_WA + 3] * x + c[S_WA + 4] * y + c[S_WA + 5];
  const float w2 = c[S_WA + 6] * x + c[S_WA + 7] * y + c[S_WA + 8];
  const bool inside = (w0 > 0.0f) && (w0 < 1.0f) && (w1 > 0.0f) &&
                      (w1 < 1.0f) && (w2 > 0.0f) && (w2 < 1.0f);
  float dis2 = INFINITY;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float sp = c[S_SEG + 3 * e] * x + c[S_SEG + 3 * e + 1] * y +
                     c[S_SEG + 3 * e + 2];
    const float t = fminf(fmaxf(sp, 0.0f), 1.0f);
    const float pv0 = p2 + c[S_PC + 3 * e] * x +
                      c[S_PC + 3 * e + 1] * y + c[S_PC + 3 * e + 2];
    const float d2e = fmaxf(pv0 - t * (2.0f * sp - t) * c[S_E2 + e],
                            0.0f);
    dis2 = fminf(dis2, d2e);
  }
  const bool con1 = inside || (dis2 < prm.cut1);
  const bool con2 = inside || (dis2 < prm.cut2);
  if (!(con1 || con2)) return;
  const float sdis = inside ? -dis2 : dis2;  // -sign * dis2
  const float d1 = con1 ? 1.0f / (1.0f + expf(sdis * prm.inv_sigma1)) : 0.0f;
  const float d2 = con2 ? 1.0f / (1.0f + expf(sdis * prm.inv_sigma2)) : 0.0f;
  q.p1 = q.p1 * (1.0f - d1);
  q.p2c = q.p2c * (1.0f - d2);

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
  if (!z_ok) return;
  const float zn = (prm.far_ - zp) * prm.inv_range;

  if (con2) {  // texture softmax at sigma2
    const float cr = c0 * c[S_STEX + 0] + c1 * c[S_STEX + 3] +
                     c2 * c[S_STEX + 6];
    const float cg = c0 * c[S_STEX + 1] + c1 * c[S_STEX + 4] +
                     c2 * c[S_STEX + 7];
    const float cbl = c0 * c[S_STEX + 2] + c1 * c[S_STEX + 5] +
                      c2 * c[S_STEX + 8];
    const float m_new = fmaxf(q.m_t, zn);
    const float scale = expf((q.m_t - m_new) * prm.inv_gamma_t);
    const float wgt = d2 * expf((zn - m_new) * prm.inv_gamma_t);
    q.s_t = q.s_t * scale + wgt;
    q.a_r = q.a_r * scale + wgt * cr;
    q.a_g = q.a_g * scale + wgt * cg;
    q.a_b = q.a_b * scale + wgt * cbl;
    q.m_t = m_new;
  }
  if (con1) {  // depth softmax at sigma1 + hard winner
    const float val = c0 * (c[S_Z] - prm.z_offset) +
                      c1 * (c[S_Z + 1] - prm.z_offset) +
                      c2 * (c[S_Z + 2] - prm.z_offset);
    const float m_new = fmaxf(q.m_d, zn);
    const float scale = expf((q.m_d - m_new) * prm.inv_gamma_d);
    const float wgt = d1 * expf((zn - m_new) * prm.inv_gamma_d);
    q.s_d = q.s_d * scale + wgt;
    q.a_d = q.a_d * scale + wgt * val;
    q.m_d = m_new;
    const bool inside_ns = (w0 >= 0.0f) && (w0 <= 1.0f) &&
                           (w1 >= 0.0f) && (w1 <= 1.0f) &&
                           (w2 >= 0.0f) && (w2 <= 1.0f);
    if (inside_ns && zp < q.zmin) {
      q.zmin = zp;
      q.h_r = c0 * c[S_HTEX + 0] + c1 * c[S_HTEX + 3] + c2 * c[S_HTEX + 6];
      q.h_g = c0 * c[S_HTEX + 1] + c1 * c[S_HTEX + 4] + c2 * c[S_HTEX + 7];
      q.h_b = c0 * c[S_HTEX + 2] + c1 * c[S_HTEX + 5] + c2 * c[S_HTEX + 8];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
raster_fwd_kernel(const float* __restrict__ consts, int F, int S, int B,
                  Params prm, float* __restrict__ out) {
  __shared__ float sc[CH][N_SLOTS + 1];
  __shared__ int s_ids[THREADS];
  __shared__ int s_cnt[THREADS / 32];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int col = blockIdx.x * TILE + threadIdx.x;
  const int row = blockIdx.y * TILE + threadIdx.y;
  const bool valid = (col < S) && (row < S);
  const float fs = (float)S;

  // pixel centre in NDC (common.pixel_grid)
  const float x = (2.0f * (float)col + 1.0f - fs) * prm.inv_s;
  const float y = ((float)(S - 1) - 2.0f * (float)row) * prm.inv_s;
  const float p2 = x * x + y * y;

  // the block's pixel box, padded by the cull radius
  const int c_lo = blockIdx.x * TILE;
  const int c_hi = min(c_lo + TILE, S) - 1;
  const int r_lo = blockIdx.y * TILE;
  const int r_hi = min(r_lo + TILE, S) - 1;
  const float bx_lo = (2.0f * (float)c_lo + 1.0f - fs) * prm.inv_s - prm.pad;
  const float bx_hi = (2.0f * (float)c_hi + 1.0f - fs) * prm.inv_s + prm.pad;
  const float by_hi = ((float)(S - 1) - 2.0f * (float)r_lo) * prm.inv_s + prm.pad;
  const float by_lo = ((float)(S - 1) - 2.0f * (float)r_hi) * prm.inv_s - prm.pad;

  Carry q{1.0f, 1.0f,
          prm.bg_eps, 1.0f, 1.0f,
          prm.bg_eps, 1.0f, 1.0f, 1.0f, 1.0f,
          INFINITY, 0.0f, 0.0f, 0.0f};

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
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
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
      for (int k = tid; k < n * N_SLOTS; k += THREADS) {
        const int j = k / N_SLOTS;
        const int sl = k - j * N_SLOTS;
        sc[j][sl] = cb[(size_t)s_ids[j0 + j] * K + sl];
      }
      __syncthreads();
      if (valid) {
        for (int j = 0; j < n; ++j) shade(sc[j], x, y, p2, prm, q);
      }
      __syncthreads();
    }
  }

  if (!valid) return;
  const size_t plane = (size_t)B * S * S;
  const size_t o = ((size_t)b * S + row) * S + col;
  out[0 * plane + o] = 1.0f - q.p1;
  out[1 * plane + o] = 1.0f - q.p2c;
  out[2 * plane + o] = q.a_d / q.s_d;
  out[3 * plane + o] = q.a_r / q.s_t;
  out[4 * plane + o] = q.a_g / q.s_t;
  out[5 * plane + o] = q.a_b / q.s_t;
  out[6 * plane + o] = q.h_r;
  out[7 * plane + o] = q.h_g;
  out[8 * plane + o] = q.h_b;
  out[9 * plane + o] = q.m_d;
  out[10 * plane + o] = q.s_d;
  out[11 * plane + o] = q.m_t;
  out[12 * plane + o] = q.s_t;
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success). consts: (B, F, 64) float32 contiguous, device memory;
// out: (13, B, S, S) float32 contiguous, device memory.
extern "C" int raster_fused_fwd(const float* consts, int B, int F, int S,
                                float inv_sigma1, float inv_sigma2,
                                float inv_gamma_d, float inv_gamma_t,
                                float near_, float far_, float inv_range,
                                float bg_eps, float z_offset, float cut1,
                                float cut2, float pad, float inv_s,
                                float* out, void* stream) {
  Params prm{inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t, near_, far_,
             inv_range, bg_eps, z_offset, cut1, cut2, pad, inv_s};
  dim3 block(TILE, TILE);
  dim3 grid((S + TILE - 1) / TILE, (S + TILE - 1) / TILE, B);
  raster_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(consts, F, S,
                                                               B, prm, out);
  return (int)cudaGetLastError();
}
