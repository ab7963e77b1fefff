// B4: the nearest-point search of the one-way chamfers
// (selfcorr_tpu_torch/ops/knn.py nearest_index_cuda): for each query point
// of x (B, N, 3), the index of its nearest point of y (B, M, 3), with an
// optional mask y_valid (B, M) that takes masked targets out of the search.
//
// It replaces no TPU kernel: the JAX package leaves this search to XLA
// (selfcorr_tpu/ops/knn.py min_sq_dist), whose large-size branch keeps no
// distance matrix either. The port's plain version writes the whole
// (B, N, M) fp32 matrix |x|^2 + |y|^2 - 2 x.y and reads it again for the
// argmin: 13.4 GB a step at the bottle's 17-fold symmetry chamfer.
//
// Bound on the H100: B N M pairs at 8 fp32 operations each (three
// differences, three squares, two sums) over 67 TFLOP/s; inputs and output
// are a few MB, so the work is compute-bound (the bottle's symmetry chamfer,
// 32 x 10,438 x 10,000 = 3.34e9 pairs, 0.40 ms).
//
// Design. Each block takes up to 512 queries of one batch element (4 a
// thread, in registers) against one chunk of that element's targets, which
// it stages through shared memory in tiles of 1024 as three planes (x, y, z),
// two buffers deep: the next tile is staged while this one is searched, one
// barrier a tile. Every lane reads the same target at once (a broadcast,
// 16 bytes a load), so one load feeds 4 queries. A pair costs 3 differences,
// a product and 2 FMAs, computed directly as (x - y)^2 on the CUDA cores, no
// tensor core, so the distance is within a few fp32 roundings of the exact
// one; per group of 8 targets a query keeps the minimum (7 min operations)
// and compares it with its running best once, remembering the group. After
// the last tile the winner is found again inside its group by recomputing
// the same distances bit for bit: the first index that gives the minimum.
// The running best takes a group only if strictly smaller, groups are walked
// in index order, so a tie goes to the lower index, as argmin's does.
// Warps whose queries run out skip the search but keep staging.
//
// Where the queries are too few to fill the card (the laptop's 2-fold
// symmetry: 32 x 1,184), the targets are split into chunks across blocks
// (the host's plan, knn.py plan); each block writes its chunk's (distance,
// index) and a second kernel merges the chunks in index order, keeping the
// lower chunk on a tie. No atomics: two runs give the same indices.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;   // 4 warps a block
constexpr int QPT = 4;         // queries a thread holds
constexpr int GROUP = 8;       // targets under one running-best compare
constexpr int TILE = 1024;     // targets a shared-memory buffer holds
static_assert(TILE % GROUP == 0 && GROUP == 8, "a group is two float4s");

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float tx, float ty, float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// targets [j0, j0 + len) of one batch element into the three planes;
// masked targets and the tail up to the next whole group become +inf
__device__ __forceinline__ void stage(float (&planes)[3][TILE],
                                      const float* __restrict__ yb,
                                      const float* __restrict__ vb, int j0,
                                      int len) {
  const float* src = yb + 3LL * j0;
  for (int i = threadIdx.x; i < 3 * len; i += THREADS) {
    const int j = i / 3;
    float v = src[i];
    if (vb != nullptr && !(vb[j0 + j] > 0.f)) v = INFINITY;
    planes[i - 3 * j][j] = v;
  }
  const int padded = (len + GROUP - 1) / GROUP * GROUP;
  for (int j = len + threadIdx.x; j < padded; j += THREADS)
    planes[0][j] = planes[1][j] = planes[2][j] = INFINITY;
}

// the running best of the first NK queries over `groups` staged groups
template <int NK>
__device__ __forceinline__ void search(const float (&planes)[3][TILE],
                                       int groups, int gbase,
                                       const float (&qx)[QPT],
                                       const float (&qy)[QPT],
                                       const float (&qz)[QPT],
                                       float (&best)[QPT], int (&bg)[QPT]) {
  const float4* px = reinterpret_cast<const float4*>(planes[0]);
  const float4* py = reinterpret_cast<const float4*>(planes[1]);
  const float4* pz = reinterpret_cast<const float4*>(planes[2]);
#pragma unroll 2
  for (int g = 0; g < groups; ++g) {
    const float4 xa = px[2 * g], xb = px[2 * g + 1];
    const float4 ya = py[2 * g], yb = py[2 * g + 1];
    const float4 za = pz[2 * g], zb = pz[2 * g + 1];
    const float tx[GROUP] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    const float ty[GROUP] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
    const float tz[GROUP] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      float d[GROUP];
#pragma unroll
      for (int u = 0; u < GROUP; ++u)
        d[u] = sq_dist(qx[k], qy[k], qz[k], tx[u], ty[u], tz[u]);
      const float m = fminf(fminf(fminf(d[0], d[1]), fminf(d[2], d[3])),
                            fminf(fminf(d[4], d[5]), fminf(d[6], d[7])));
      if (m < best[k]) {
        best[k] = m;
        bg[k] = gbase + g;
      }
    }
  }
}

// grid (query blocks, chunks, B): queries [q0, q0 + per_block) of batch
// element blockIdx.z against targets [c0, c0 + chunk) with c0 = chunk *
// blockIdx.y. With part_d null (one chunk) it writes the index to out;
// otherwise (distance, index) to part_d / part_i at [chunk][b][query].
__global__ void __launch_bounds__(THREADS)
nearest_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ valid, long long* __restrict__ out,
               float* __restrict__ part_d, int* __restrict__ part_i, int n,
               int m, int per_block, int chunk) {
  __shared__ __align__(16) float planes[2][3][TILE];
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * per_block;
  const int q1 = min(q0 + per_block, n);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(c0 + chunk, m);
  const float* xb = x + 3LL * b * n;
  const float* yb = y + 3LL * b * m;
  const float* vb = valid == nullptr ? nullptr : valid + (long long)b * m;

  // query slot k of this thread is q0 + k * THREADS + threadIdx.x; a warp's
  // live slots are a prefix of k, nk long
  const int warp = threadIdx.x / 32;
  const int nk = max(0, min(QPT, (q1 - q0 - warp * 32 + THREADS - 1) /
                                     THREADS));
  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int bg[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = min(q0 + k * THREADS + (int)threadIdx.x, q1 - 1);
    qx[k] = xb[3LL * q];
    qy[k] = xb[3LL * q + 1];
    qz[k] = xb[3LL * q + 2];
    best[k] = INFINITY;
    bg[k] = c0 / GROUP;
  }

  const int tiles = (c1 - c0 + TILE - 1) / TILE;
  stage(planes[0], yb, vb, c0, min(TILE, c1 - c0));
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const int j0 = c0 + t * TILE;
    if (t + 1 < tiles)
      stage(planes[(t + 1) & 1], yb, vb, j0 + TILE,
            min(TILE, c1 - j0 - TILE));
    const int groups = (min(TILE, c1 - j0) + GROUP - 1) / GROUP;
    const float(&cur)[3][TILE] = planes[t & 1];
    switch (nk) {
      case 4: search<4>(cur, groups, j0 / GROUP, qx, qy, qz, best, bg); break;
      case 3: search<3>(cur, groups, j0 / GROUP, qx, qy, qz, best, bg); break;
      case 2: search<2>(cur, groups, j0 / GROUP, qx, qy, qz, best, bg); break;
      case 1: search<1>(cur, groups, j0 / GROUP, qx, qy, qz, best, bg); break;
      default: break;
    }
    __syncthreads();
  }

  // the first index of the winning group whose distance is the minimum
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int q = q0 + k * THREADS + threadIdx.x;
    if (q >= q1) continue;
    const int g0 = bg[k] * GROUP;
    const int g1 = min(g0 + GROUP, c1);
    int idx = g0;
    for (int j = g0; j < g1; ++j) {
      float tx = yb[3LL * j], ty = yb[3LL * j + 1], tz = yb[3LL * j + 2];
      if (vb != nullptr && !(vb[j] > 0.f)) tx = ty = tz = INFINITY;
      if (sq_dist(qx[k], qy[k], qz[k], tx, ty, tz) == best[k]) {
        idx = j;
        break;
      }
    }
    if (part_d == nullptr) {
      out[(long long)b * n + q] = idx;
    } else {
      const long long o = ((long long)blockIdx.y * gridDim.z + b) * n + q;
      part_d[o] = best[k];
      part_i[o] = idx;
    }
  }
}

// one thread a query: the chunks' winners in chunk order, strict <
__global__ void merge_kernel(const float* __restrict__ part_d,
                             const int* __restrict__ part_i,
                             long long* __restrict__ out, long long total,
                             int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float best = part_d[i];
  int idx = part_i[i];
  for (int s = 1; s < chunks; ++s) {
    const float d = part_d[s * total + i];
    if (d < best) {
      best = d;
      idx = part_i[s * total + i];
    }
  }
  out[i] = idx;
}

}  // namespace

// x (b, n, 3), y (b, m, 3) fp32 contiguous; valid (b, m) fp32 or null;
// out (b, n) int64. With chunks > 1, part_d / part_i hold (chunks, b, n).
// Returns 0 or the CUDA error of a refused launch.
extern "C" int nearest_point(const float* x, const float* y,
                             const float* valid, long long* out,
                             float* part_d, int* part_i, int b, int n, int m,
                             int per_block, int chunk, int chunks,
                             void* stream) {
  if (b < 1 || n < 1 || m < 1 || per_block < 1 ||
      per_block > THREADS * QPT || chunk < 1 || chunk % GROUP != 0 ||
      chunks < 1 || (long long)chunk * (chunks - 1) >= m ||
      (long long)chunk * chunks < m || (chunks > 1 && part_d == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + per_block - 1) / per_block, chunks, b);
  nearest_kernel<<<grid, THREADS, 0, st>>>(
      x, y, valid, out, chunks > 1 ? part_d : nullptr, part_i, n, m,
      per_block, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return (int)err;
  const long long total = (long long)b * n;
  merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part_d, part_i, out, total, chunks);
  return (int)cudaGetLastError();
}
