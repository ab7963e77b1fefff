// Device code shared by the four fused-rasterizer kernels (raster_fwd.cu,
// raster_bwd.cu, raster_fwd_chunk.cu, raster_bwd_chunk.cu): the packed slot
// layout (../common.py), the parameters, the dense-chunk tile geometry, the
// forward's per-pair update
// `shade` and its walk over staged faces `walk_staged` (the warp's sub-tile
// cull), the backward's per-pair gradient `pair_grad`, the surface
// texel pick, and a deterministic warp reduction of texel gradients.
// `pair_grad` is `pair_geom` (the cover test) followed by `pair_chain`, so
// that B2 can compact the covered pixels between the two.
//
// The per-pair arithmetic is the plain PyTorch versions' (../reference.py),
// operation for operation; the sources are built with -fmad=false so that
// each multiply and add rounds on its own as PyTorch's separate operations
// do. The sigma = 1e-4 sigmoid amplifies rounding ~1e4x at triangle edges,
// with gamma = 1e-4 one ulp of depth moves a softmax weight by ~1e-3, and
// the surface texel pick is discontinuous, so the kernels must round as the
// plain versions do, not merely close to them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace raster {

// packed slots per face (common.py): K = 64 without surface texels, else
// the next multiple of 64 above S_SURF + 3 R^2
constexpr int S_WA = 0, S_SEG = 9, S_E2 = 18, S_PC = 21, S_IZ = 30,
              S_Z = 33, S_BBOX = 37, S_STEX = 41, S_HTEX = 50;
constexpr int N_SLOTS = 59;     // slots of every face
constexpr int S_SURF = N_SLOTS; // R^2 x rgb surface texels, when packed
constexpr int MAX_TEX_RES = 8;  // R <= 8: at most 251 slots, K <= 256
constexpr int MAX_USED = N_SLOTS + 3 * MAX_TEX_RES * MAX_TEX_RES;
constexpr int FF = 16;          // faces per chunk (dense-chunk schedule)
constexpr int NACC = 36;        // backward slots held in registers
constexpr unsigned FULL = 0xffffffffu;

// slots that carry data at texel resolution tex_res
__host__ __device__ inline int used_slots(int tex_res) {
  return N_SLOTS + 3 * tex_res * tex_res;
}

// Every division by a constant is a multiplication by its float32
// reciprocal, exactly as in the plain versions.
struct Params {
  float inv_sigma1, inv_sigma2, inv_gamma_d, inv_gamma_t;
  float near_, far_, inv_range, bg_eps, z_offset;  // inv_range = 1/(far-near)
  float cut1, cut2;  // sigma * DIST_CUT, the outside-coverage cutoffs
  float pad;         // bbox cull radius, >= sqrt(max(sigma) * DIST_CUT)
  float inv_s;       // 1 / S for the pixel grid
};

// The tile geometry of the dense-chunk schedule (../chunks.py tiles_for):
// tiles of rows x cols pixels, n_rows x n_cols of them, and n_words mask
// words per tile.
struct Tiles {
  int rows, cols, n_rows, n_cols, n_words;
};

// The forward's per-pixel carries.
struct Carry {
  float p1, p2c;                  // coverage products at sigma1, sigma2
  float m_d, s_d, a_d;            // depth softmax: max, sum, accumulator
  float m_t, s_t, a_r, a_g, a_b;  // texture softmax
  float zmin, h_r, h_g, h_b;      // hard winner: depth, texture
};

__device__ __forceinline__ Carry carry_init(const Params& prm) {
  return Carry{1.0f, 1.0f,
               prm.bg_eps, 1.0f, 1.0f,
               prm.bg_eps, 1.0f, 1.0f, 1.0f, 1.0f,
               INFINITY, 0.0f, 0.0f, 0.0f};
}

// pixel centre in NDC (common.pixel_grid)
__device__ __forceinline__ float pixel_x(int col, int S, const Params& prm) {
  return (2.0f * (float)col + 1.0f - (float)S) * prm.inv_s;
}
__device__ __forceinline__ float pixel_y(int row, int S, const Params& prm) {
  return ((float)(S - 1) - 2.0f * (float)row) * prm.inv_s;
}

// The surface texel at clipped, renormalized barycentrics c0, c1: cell
// (floor(c0 R), floor(c1 R)), folded when the cell crosses the diagonal
// (reference.texel_index; pallas_raster.py:519-531).
__device__ __forceinline__ int texel_index(float c0, float c1, int res) {
  const float r = (float)res;
  const float wx = fminf(fmaxf(floorf(c0 * r), 0.0f), r - 1.0f);
  const float wy = fminf(fmaxf(floorf(c1 * r), 0.0f), r - 1.0f);
  const bool upper = ((c0 + c1) * r - wx - wy) <= 1.0f;
  const float idx =
      upper ? wy * r + wx : (r - 1.0f - wy) * r + (r - 1.0f - wx);
  return min(max((int)idx, 0), res * res - 1);  // NaN converts to 0
}

constexpr int N_FIX = 60;  // slots 0 .. S_HTEX + 8, as 15 float4
static_assert(N_FIX >= S_HTEX + 9 && N_FIX % 4 == 0, "fixed slots");

// One (face, pixel) pair of the forward: c holds the face's packed slots
// 0 .. S_HTEX + 8 (in registers: walk_staged copies them there), tex points
// at its surface texels (slot S_SURF, shared memory), q is the pixel's
// carry. Pairs that neither sigma covers change nothing.
__device__ __forceinline__ void shade(const float* c, const float* tex,
                                     float x, float y, float p2,
                                     const Params& prm, int tex_res,
                                     Carry& q) {
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
    float cr, cg, cbl;
    if (tex_res > 0) {
      const float* tx = tex + 3 * texel_index(c0, c1, tex_res);
      cr = tx[0];
      cg = tx[1];
      cbl = tx[2];
    } else {
      cr = c0 * c[S_STEX + 0] + c1 * c[S_STEX + 3] + c2 * c[S_STEX + 6];
      cg = c0 * c[S_STEX + 1] + c1 * c[S_STEX + 4] + c2 * c[S_STEX + 7];
      cbl = c0 * c[S_STEX + 2] + c1 * c[S_STEX + 5] + c2 * c[S_STEX + 8];
    }
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

// The forward's 13 planes of one pixel (reference.PLANES order) into out,
// (13, B, S, S); o is the pixel's offset in one plane.
__device__ __forceinline__ void write_planes(const Carry& q, float* out,
                                             size_t plane, size_t o) {
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

// ---------------------------------------------------------------------------
// The forwards' schedule (B1 raster_fwd.cu, B1' raster_fwd_chunk.cu). A
// block stages faces in shared memory, in ascending packed order, as rows
// of V float4 (the used slots rounded up to a multiple of 4). Each warp
// owns a sub-tile of SUB_COLS columns x LANE_ROWS rows, a pixel a lane
// (lane l: column l % SUB_COLS, row l / SUB_COLS), with its carry in
// registers. The warp tests the staged faces' bboxes against its sub-tile's
// box padded by the cull radius (the block cull's arithmetic, so it is
// exact: a face it skips covers no pixel of the sub-tile), and copies the
// slots of each face that passes into registers, one LDS.128 per 4 slots.
constexpr int SUB_COLS = 8;
constexpr int LANE_ROWS = 32 / SUB_COLS;
static_assert(S_BBOX % 4 == 1, "the bbox is slots 1-3 of a float4 + 1");

__host__ __device__ inline int staged_vecs(int tex_res) {
  return (used_slots(tex_res) + 3) / 4;
}

// Shared memory a block stages faces in: 8 blocks of 4 warps, each with
// its few KB of static arrays, still fit an SM's 228 KB, so the texels'
// longer rows (168 floats at R = 6) stage fewer faces at a time rather than
// take warps off the SM.
constexpr int STAGE_BYTES = 22 * 1024;

// Copies one face row of V float4 from device to shared memory, 16 lanes
// (h = lane % 16) together.
__device__ __forceinline__ void stage_row(float4* dst,
                                          const float4* __restrict__ src,
                                          int V, int h) {
  for (int v = h; v < V; v += 16) dst[v] = __ldg(src + v);
}

struct SubTile {
  float x, y, p2;  // the lane's pixel
  bool valid;      // it lies in the image (or the tile)
  Carry q;
  int row, col;
  bool any;        // the sub-tile holds a pixel to shade
  float bx_lo, bx_hi, by_lo, by_hi;  // its box, padded by the cull radius
};

// The warp's sub-tile at (r0, c0): pixels at rows < r_end, columns < c_end
// (the image's, or the tile's, end) are shaded.
__device__ __forceinline__ void sub_tile(SubTile& w, int r0, int c0,
                                         int r_end, int c_end, int S,
                                         const Params& prm) {
  const int lane = threadIdx.x & 31;
  w.col = c0 + lane % SUB_COLS;
  w.row = r0 + lane / SUB_COLS;
  w.valid = (w.row < r_end) && (w.col < c_end);
  w.x = pixel_x(w.col, S, prm);
  w.y = pixel_y(w.row, S, prm);
  w.p2 = w.x * w.x + w.y * w.y;
  w.q = carry_init(prm);
  w.any = (r0 < r_end) && (c0 < c_end);
  const int c_hi = min(c0 + SUB_COLS, c_end) - 1;
  const int r_hi = min(r0 + LANE_ROWS, r_end) - 1;
  w.bx_lo = pixel_x(c0, S, prm) - prm.pad;
  w.bx_hi = pixel_x(c_hi, S, prm) + prm.pad;
  w.by_hi = pixel_y(r0, S, prm) + prm.pad;
  w.by_lo = pixel_y(r_hi, S, prm) - prm.pad;
}

// Shades the lane's pixel against the n faces staged at sc4 (rows of V
// float4), in order, skipping each face whose padded bbox misses the
// sub-tile: the lanes test 32 faces at once, one each, and the warp walks
// the set bits of their ballot in ascending order (warp-uniform).
__device__ __forceinline__ void walk_staged(const float4* sc4, int n, int V,
                                            const Params& prm, int tex_res,
                                            SubTile& w) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n; j0 += 32) {
    bool hit = false;
    if (j0 + lane < n) {
      const float4* r = sc4 + (j0 + lane) * V;
      const float4 bb = r[S_BBOX / 4];  // front, xmin, xmax, ymin
      const float ymax = r[S_BBOX / 4 + 1].x;
      hit = (bb.y <= w.bx_hi) && (bb.z >= w.bx_lo) && (bb.w <= w.by_hi) &&
            (ymax >= w.by_lo);
    }
    for (unsigned m = __ballot_sync(FULL, hit); m; m &= m - 1) {
      const float4* r = sc4 + (j0 + __ffs(m) - 1) * V;
      float c[N_FIX];  // registers: 15 LDS.128
#pragma unroll
      for (int v = 0; v < N_FIX / 4; ++v) {
        const float4 t = r[v];
        c[4 * v + 0] = t.x;
        c[4 * v + 1] = t.y;
        c[4 * v + 2] = t.z;
        c[4 * v + 3] = t.w;
      }
      if (w.valid)
        shade(c, reinterpret_cast<const float*>(r) + S_SURF, w.x, w.y, w.p2,
              prm, tex_res, w.q);
    }
  }
}

// The lane's 13 planes into out, (13, B, S, S).
__device__ __forceinline__ void write_sub_tile(const SubTile& w, float* out,
                                               int B, int S, int b) {
  if (w.valid)
    write_planes(w.q, out, (size_t)B * S * S,
                 ((size_t)b * S + w.row) * S + w.col);
}

// The padded pixel box of a face for the backward: the pixels of its bbox,
// padded by the cull radius and one pixel of margin, clipped to the image.
// A pixel outside it is farther than the cutoff from the face. Empty
// (c_hi < c_lo) for a face off screen, with NaN bounds, or a padding face.
struct PixBox {
  int c_lo, c_hi, r_lo, r_hi;
};

__device__ __forceinline__ PixBox face_box(const float* c, int S,
                                           const Params& prm) {
  const float fs = (float)S;
  const float xlo = c[S_BBOX + 0] - prm.pad, xhi = c[S_BBOX + 1] + prm.pad;
  const float ylo = c[S_BBOX + 2] - prm.pad, yhi = c[S_BBOX + 3] + prm.pad;
  PixBox bx{0, -1, 0, -1};
  if (xlo <= 2.0f && xhi >= -2.0f && ylo <= 2.0f && yhi >= -2.0f) {
    const float cl = fmaxf((xlo * fs + fs - 1.0f) * 0.5f, 0.0f);
    const float ch = fminf((xhi * fs + fs - 1.0f) * 0.5f, fs - 1.0f);
    const float rl = fmaxf((fs - 1.0f - yhi * fs) * 0.5f, 0.0f);
    const float rh = fminf((fs - 1.0f - ylo * fs) * 0.5f, fs - 1.0f);
    bx.c_lo = max((int)floorf(cl) - 1, 0);
    bx.c_hi = min((int)ceilf(ch) + 1, S - 1);
    bx.r_lo = max((int)floorf(rl) - 1, 0);
    bx.r_hi = min((int)ceilf(rh) + 1, S - 1);
  }
  return bx;
}

// The geometry of one (face, pixel) pair of the backward, in the forward's
// operation order: the barycentric planes, the squared distance to the
// face's edges and the FIRST edge that attains it (the only edge dis2
// passes its gradient to), with that edge's raw segment parameter.
struct PairGeom {
  float w0, w1, w2, dis2, sp;
  int e_min;
  bool inside;
};

// Fills g for the pair at (x, y); returns whether either sigma covers it
// (con1 || con2). Every gradient term of an uncovered pair is zero.
__device__ __forceinline__ bool pair_geom(const float* c, float x, float y,
                                          const Params& prm, PairGeom& g) {
  const float p2 = x * x + y * y;
  g.w0 = c[S_WA + 0] * x + c[S_WA + 1] * y + c[S_WA + 2];
  g.w1 = c[S_WA + 3] * x + c[S_WA + 4] * y + c[S_WA + 5];
  g.w2 = c[S_WA + 6] * x + c[S_WA + 7] * y + c[S_WA + 8];
  g.inside = (g.w0 > 0.0f) && (g.w0 < 1.0f) && (g.w1 > 0.0f) &&
             (g.w1 < 1.0f) && (g.w2 > 0.0f) && (g.w2 < 1.0f);
  float sp[3], d2e[3];
  float dis2 = INFINITY;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    sp[e] = c[S_SEG + 3 * e] * x + c[S_SEG + 3 * e + 1] * y +
            c[S_SEG + 3 * e + 2];
    const float tt = fminf(fmaxf(sp[e], 0.0f), 1.0f);
    const float pv0 = p2 + c[S_PC + 3 * e] * x +
                      c[S_PC + 3 * e + 1] * y + c[S_PC + 3 * e + 2];
    d2e[e] = fmaxf(pv0 - tt * (2.0f * sp[e] - tt) * c[S_E2 + e], 0.0f);
    dis2 = fminf(dis2, d2e[e]);
  }
  g.dis2 = dis2;
  g.e_min = d2e[0] == dis2 ? 0 : (d2e[1] == dis2 ? 1 : 2);
  g.sp = g.e_min == 0 ? sp[0] : (g.e_min == 1 ? sp[1] : sp[2]);
  return g.inside || (dis2 < prm.cut1) || (dis2 < prm.cut2);
}

// Where pair_chain adds the first minimizing edge's 7 terms (SEG x, y, 1;
// E2; PC x, y, 1): the slot registers acc[0..20] (RegEdges), or a lane's
// column of 21 slots in shared memory, 32 floats apart (ColumnEdges), which
// frees 21 registers. Either adds the same terms in the same order.
struct RegEdges {
  float* acc;
  __device__ __forceinline__ void add(int e_min, const float (&t)[7]) const {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      if (e_min == e) {
        acc[3 * e + 0] += t[0];
        acc[3 * e + 1] += t[1];
        acc[3 * e + 2] += t[2];
        acc[9 + e] += t[3];
        acc[12 + 3 * e + 0] += t[4];
        acc[12 + 3 * e + 1] += t[5];
        acc[12 + 3 * e + 2] += t[6];
      }
    }
  }
};
struct ColumnEdges {
  float* col;  // slot j of this lane at col[32 j]
  __device__ __forceinline__ void add(int e_min, const float (&t)[7]) const {
    float* seg = col + 32 * (3 * e_min);
    float* pc = col + 32 * (12 + 3 * e_min);
    seg[0] += t[0];
    seg[32] += t[1];
    seg[64] += t[2];
    col[32 * (9 + e_min)] += t[3];
    pc[0] += t[4];
    pc[32] += t[5];
    pc[64] += t[6];
  }
};

// The chains of one covered (face, pixel) pair of the backward (the TPU
// kernel's `_bwd_chunk_grads`, pallas_raster.py:877-1075) from its geometry
// g (pair_geom): accumulates the pair's gradient of slots SEG, E2, PC (of
// the first minimizing edge only, through `edges`; the other edges' terms
// are zero), IZ, Z into acc[21..26] and, without surface texels, of STEX
// into acc[27..35].
// With texels, the pair's texture cotangent dcol goes to one texel,
// returned in *texel for the caller to add. pix: the 16 planes
// (raster_bwd.cu), plane: their stride, o: the pixel's offset.
template <class Edges>
__device__ __forceinline__ void pair_chain(const float* c, float x, float y,
                                          const PairGeom& g,
                                          const float* __restrict__ pix,
                                          size_t plane, size_t o,
                                          const Params& prm, int tex_res,
                                          const Edges& edges, float* acc,
                                          int* texel, float* dcol) {
  // --- this pixel's residuals and cotangents, loaded first so that their
  // latency hides behind the arithmetic below
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

  const bool con1 = g.inside || (g.dis2 < prm.cut1);
  const bool con2 = g.inside || (g.dis2 < prm.cut2);
  const float sgn = g.inside ? 1.0f : -1.0f;
  const float sdis = g.inside ? -g.dis2 : g.dis2;  // -sign * dis2
  const float d1 = con1 ? 1.0f / (1.0f + expf(sdis * prm.inv_sigma1)) : 0.0f;
  const float d2 = con2 ? 1.0f / (1.0f + expf(sdis * prm.inv_sigma2)) : 0.0f;

  float c0 = fminf(fmaxf(g.w0, 0.0f), 1.0f);
  float c1 = fminf(fmaxf(g.w1, 0.0f), 1.0f);
  float c2 = fminf(fmaxf(g.w2, 0.0f), 1.0f);
  const float wsum = fmaxf(c0 + c1 + c2, 1e-5f);
  c0 = c0 / wsum;
  c1 = c1 / wsum;
  c2 = c2 / wsum;
  const float zp =
      1.0f / (c0 * c[S_IZ] + c1 * c[S_IZ + 1] + c2 * c[S_IZ + 2]);
  const bool z_ok = (zp >= prm.near_) && (zp <= prm.far_);
  const float zn = (prm.far_ - zp) * prm.inv_range;

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
  float col_r, col_g, col_b;
  int t_sel = -1;
  if (tex_res > 0) {
    t_sel = texel_index(c0, c1, tex_res);
    const float* tx = c + S_SURF + 3 * t_sel;
    col_r = tx[0];
    col_g = tx[1];
    col_b = tx[2];
  } else {
    col_r = c0 * c[S_STEX + 0] + c1 * c[S_STEX + 3] + c2 * c[S_STEX + 6];
    col_g = c0 * c[S_STEX + 1] + c1 * c[S_STEX + 4] + c2 * c[S_STEX + 7];
    col_b = c0 * c[S_STEX + 2] + c1 * c[S_STEX + 5] + c2 * c[S_STEX + 8];
  }
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

  // --- dis2 -> the first minimizing edge's slots SEG (3), E2 (1), PC (3);
  // the terms are formed once and added to that edge's slots only
  const float f = dL_ddis2;
  const float tt = fminf(fmaxf(g.sp, 0.0f), 1.0f);
  const float ds_raw = f * (-2.0f * tt * c[S_E2 + g.e_min]);
  const float terms[7] = {ds_raw * x, ds_raw * y, ds_raw,
                          f * (tt * tt - 2.0f * tt * g.sp), f * x, f * y, f};
  edges.add(g.e_min, terms);
  acc[21] += -dL_dzp * zp2 * c0;
  acc[22] += -dL_dzp * zp2 * c1;
  acc[23] += -dL_dzp * zp2 * c2;
  acc[24] += dL_dval * c0;
  acc[25] += dL_dval * c1;
  acc[26] += dL_dval * c2;
  if (tex_res > 0) {
    *texel = t_sel;
    dcol[0] = dcol_r;
    dcol[1] = dcol_g;
    dcol[2] = dcol_b;
  } else {
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
}

// One (face, pixel) pair of the backward: pair_geom, then pair_chain where
// either sigma covers the pair.
__device__ __forceinline__ void pair_grad(const float* c, float x, float y,
                                         const float* __restrict__ pix,
                                         size_t plane, size_t o,
                                         const Params& prm, int tex_res,
                                         float* acc, int* texel,
                                         float* dcol) {
  PairGeom g;
  if (pair_geom(c, x, y, prm, g))
    pair_chain(c, x, y, g, pix, plane, o, prm, tex_res, RegEdges{acc}, acc,
               texel, dcol);
}

// The sum of v over the 32 lanes of a warp, in a fixed order (xor
// butterfly); every lane gets the same value.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Adds one step's texel cotangents of a warp into its row tacc (3 R^2
// floats, shared memory): each lane holds texel t (-1: none) and its rgb
// cotangent dcol. Called by all 32 lanes together. The texels present are
// taken in the order of their first lane, and each texel's lanes are summed
// with warp_sum, so the result depends on the data only, never on timing.
// Only lane 0 writes tacc.
__device__ __forceinline__ void warp_texel_add(float* tacc, int t,
                                               const float* dcol, int lane) {
  unsigned pend = __ballot_sync(FULL, t >= 0);
  while (pend) {
    const int tl = __shfl_sync(FULL, t, __ffs(pend) - 1);
    const bool mine = (t == tl);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float v = warp_sum(mine ? dcol[ch] : 0.0f);
      if (lane == 0) tacc[3 * tl + ch] += v;
    }
    pend &= ~__ballot_sync(FULL, mine);
  }
}

// Slot `slot` of a face's gradient row from its reduced register slots red
// (NACC) and texel row tex (3 R^2; nullptr without texels). B2 and B2'
// write every slot of the row: zero where no gradient flows.
__device__ __forceinline__ float grad_slot(int slot, const float* red,
                                           const float* tex, int tex_res) {
  if (slot >= S_SEG && slot < S_SEG + 27) return red[slot - S_SEG];
  if (tex_res == 0 && slot >= S_STEX && slot < S_STEX + 9)
    return red[27 + (slot - S_STEX)];
  if (tex_res > 0 && slot >= S_SURF && slot < used_slots(tex_res))
    return tex[slot - S_SURF];
  return 0.0f;
}

}  // namespace raster
