// Forward-only flash attention for the frozen DINO trunk, Hopper (sm_90a).
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu.
// flash_attention (`_flash_attention_kernel_single_batch`), which
// selfcorr_tpu/models/vit.py `_flash_attention` (:40, call :72) runs on the
// trunk's bf16 q, k, v. Computes what that kernel computes, and what the
// plain PyTorch version `flash_attention_plain` (../attention.py) computes:
//   s = q k^T in f32 from bf16 inputs, times 1 / sqrt(64);
//   an online softmax in f32 over tiles of 64 keys: running max m, running
//   sum l of the f32 p = exp(s - m), the accumulator rescaled by
//   exp(m_old - m_new);
//   p rounded to bf16 before the p v product, which accumulates in f32;
//   out = acc * (1 / l), rounded to bf16;
//   keys >= T masked to -inf before the exponential; query rows >= T are
//   computed on zeros and never written.
//
// Design (simple first; wgmma, TMA and tuning are later work):
//   * one block of 4 warps per (batch * head, 64 queries); each warp owns 16
//     query rows and keeps their q fragments in registers;
//   * K and V tiles of 64 keys are staged through shared memory (V
//     transposed, so both products read 32-bit fragments);
//   * the products are mma.sync m16n8k16 bf16 -> f32; the S accumulator's
//     fragment layout is the P operand's, so p never leaves registers.
//
// What bounds it on an H100: at (32, 6, 1025, 64) the 4 B H T^2 d
// operations (51.6 GFLOP) over the dense bf16 tensor-core peak give ~0.05 ms,
// above the ~0.05 GB of q, k, v and o over HBM bandwidth; mma.sync reaches a
// fraction of the wgmma peak, and the exponentials run on the SFU.
//
// Layouts: q, k, v are (B, H, T, 64) views with strides in elements (the
// last dimension contiguous), so they can be read straight out of the qkv
// projection; o is written through its own strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dimension
constexpr int BQ = 64;       // queries per block, 16 per warp
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int LDS = 72;      // shared row stride in bf16 (144 B, 16-aligned)

struct Strides {
  long long b, h, t;  // elements
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int H, int T, Strides sq,
                  Strides sk, Strides sv, Strides so, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[BK][LDS];  // K tile [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt[D][LDS];   // V tile [d][key]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;

  // this thread's query rows: r0 (fragment row g) and r1 (row g + 8)
  const int r0 = blockIdx.x * BQ + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int dc = kk * 16 + tig * 2;
    qf[kk][0] = r0 < T ? ld32(qb + r0 * sq.t + dc) : 0u;
    qf[kk][1] = r1 < T ? ld32(qb + r1 * sq.t + dc) : 0u;
    qf[kk][2] = r0 < T ? ld32(qb + r0 * sq.t + dc + 8) : 0u;
    qf[kk][3] = r1 < T ? ld32(qb + r1 * sq.t + dc + 8) : 0u;
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < BK * D / 8; c += THREADS) {
      const int j = c / (D / 8);
      const int d0 = (c % (D / 8)) * 8;
      const int key = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (key < T) {
        kv = *reinterpret_cast<const uint4*>(kb + key * sk.t + d0);
        vv = *reinterpret_cast<const uint4*>(vb + key * sv.t + d0);
      }
      *reinterpret_cast<uint4*>(&ks[j][d0]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[d0 + i][j] = ve[i];
    }
    __syncthreads();

    // s = q k^T: 16 rows x 64 keys, 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + tig * 2];
        mma_bf16(s[n], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask the keys past T, row maxima (4 threads share a row)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool valid = k0 + n * 8 + tig * 2 + i < T;
        s[n][i] = valid ? s[n][i] * scale : -INFINITY;
        s[n][2 + i] = valid ? s[n][2 + i] * scale : -INFINITY;
        mx0 = fmaxf(mx0, s[n][i]);
        mx1 = fmaxf(mx1, s[n][2 + i]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds key k0 < T, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);

    // p = exp(s - m) in f32 for the row sums, bf16 for the product; the S
    // fragments of key tiles 2kk and 2kk+1 are the P operand of chunk kk
    float rs0 = 0.0f, rs1 = 0.0f;
    uint32_t pf[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float pa = expf(s[n][0] - mn0), pb = expf(s[n][1] - mn0);
      const float pc = expf(s[n][2] - mn1), pd = expf(s[n][3] - mn1);
      rs0 += pa + pb;
      rs1 += pc + pd;
      pf[n / 2][(n % 2) * 2 + 0] = pack_bf16(pa, pb);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(pc, pd);
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = al0 * l0 + rs0;
    l1 = al1 * l1 + rs1;
    m0 = mn0;
    m1 = mn1;

    // acc = acc * alpha + p v: 16 rows x 64 d, 8 tiles of 8 d
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* vr = &vt[n * 8 + g][kk * 16 + tig * 2];
        mma_bf16(acc[n], pf[kk], ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int dc = n * 8 + tig * 2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(ob + r0 * so.t + dc) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(ob + r1 * so.t + dc) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success). q, k, v, o: device pointers to bf16 (B, H, T, 64) views;
// s*: their batch, head and token strides in elements (16-byte aligned rows).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int T, long long sqb,
                              long long sqh, long long sqt, long long skb,
                              long long skh, long long skt, long long svb,
                              long long svh, long long svt, long long sob,
                              long long soh, long long sot, float scale,
                              void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_attn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, T, Strides{sqb, sqh, sqt}, Strides{skb, skh, skt},
      Strides{svb, svh, svt}, Strides{sob, soh, sot}, scale);
  return (int)cudaGetLastError();
}
