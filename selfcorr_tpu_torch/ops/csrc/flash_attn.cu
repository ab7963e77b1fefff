// Forward-only flash attention for the frozen DINO trunk, Hopper (sm_90a),
// kernel B3.
//
// Replaces the TPU library kernel jax.experimental.pallas.ops.tpu.
// flash_attention (`_flash_attention_kernel_single_batch`), which
// selfcorr_tpu/models/vit.py `_flash_attention` (:40, call :72) runs on the
// trunk's bf16 q, k, v. Computes what that kernel computes, and what the
// plain PyTorch version `flash_attention_plain` (../attention.py) computes:
//   s = q k^T in f32 from bf16 inputs, scaled by 1 / sqrt(64);
//   an online softmax in f32 over tiles of BK = 128 keys (attention.BLOCK_K):
//   running max m, running sum l of the f32 p = exp(s - m), the accumulator
//   rescaled by exp(m_old - m_new);
//   p rounded to bf16 before the p v product, which accumulates in f32;
//   out = acc * (1 / l), rounded to bf16;
//   keys >= T masked to -inf before the exponential; query rows >= T are
//   computed on zeros and never written.
// Each exponential is one fused multiply-add and one ex2.approx:
// exp(s / 8 - m / 8) = 2^(s c - m c) with c = log2(e) / 8, on the raw
// scores and their raw running max; it differs from expf in the last bits
// of the f32 p, far below the bf16 rounding of p that follows.
//
// Design (the hopper-kernels guide's producer / consumer shape):
//   * one block of four warpgroups per (192 queries, batch * head), grid
//     (ceil(T / 192), B * H); warpgroups 0-2 consume, 64 query rows each;
//     in warpgroup 3 one thread produces. At T = 1025 that is 6 x 192
//     blocks, 8.7 waves of one block per SM; three consumers keep the
//     tensor cores and the SFU busier than two (128 queries a block
//     measured slower on the card);
//   * the producer loads the block's q tile once, then the k and v tiles of
//     128 keys into a ring of STAGES stages, all by TMA
//     (cp.async.bulk.tensor) from tensor maps over the strided (B, H, T, 64)
//     views, with 128B swizzle (a 64-wide bf16 row is 128 bytes). Rows
//     t >= T come back as zeros. Each stage has a full barrier for k, one
//     for v (the consumers start q k^T while v is in flight) and an empty
//     barrier that each consumer warp arrives on when done with the stage;
//   * s = q k^T is wgmma m64n128k16 x 4 with both operands in shared memory
//     (k is K-major as stored, so it needs no transpose);
//   * the softmax runs on the accumulator in registers; p, packed to bf16,
//     is already in wgmma's A-fragment layout, so o += p v is wgmma
//     m64n64k16 x 8 with A from registers and v read through an MN-major
//     (transposed) descriptor: no transpose in software, no conflicted
//     stores;
//   * the last key tile, when it holds at most 16 keys (one at T = 1025),
//     runs the n16 product and a single p v step instead of 128 keys' worth;
//     a consumer whose 64 rows all lie at t >= T (the third of the last
//     block at T = 1025) does nothing;
//   * setmaxnreg gives the consumers 160 registers, the producer 24;
//   * each consumer runs its tile's two products back to back with its
//     softmax between them: issuing the next tile's q k^T ahead of the
//     softmax (a second score tile in registers) made ptxas serialize the
//     wgmmas and measured slower, so the overlap comes from the other
//     consumers.
// Tensor maps are encoded on the host for each call (they hold the
// pointers); cuTensorMapEncodeTiled is reached through
// cudaGetDriverEntryPoint, so the library links only the CUDA runtime.
//
// What bounds it on an H100: at (32, 6, 1025, 64) the 4 B H T^2 d
// operations (51.6 GFLOP) over the dense bf16 tensor-core peak give ~0.05 ms,
// above the ~0.05 GB of q, k, v and o over HBM bandwidth. At d = 64 the
// exponentials weigh as much as the products: one per score on the SFU's
// 16 per clock per SM take about as long as the two products on the tensor
// cores, so the consumer warpgroups overlap one's softmax with the others'
// products.
//
// Layouts: q, k, v are (B, H, T, 64) views with strides in elements (the
// last dimension contiguous, rows 16-byte aligned), so they can be read
// straight out of the qkv projection; o is written through its own strides.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;               // head dimension
constexpr int CONSUMERS = 3;        // warpgroups of 64 query rows
constexpr int BQ = 64 * CONSUMERS;  // queries per block
constexpr int BK = 128;             // keys per tile (attention.BLOCK_K)
constexpr int STAGES = 3;           // k / v ring depth
constexpr int THREADS = 128 * (CONSUMERS + 1);
// registers per thread after setmaxnreg: the producer gives up what the
// consumers take (65,536 a block)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
constexpr int ROW_BYTES = D * 2;              // 128: one swizzle row
constexpr int Q_BYTES = BQ * ROW_BYTES;       // 24 KB
constexpr int TILE_BYTES = BK * ROW_BYTES;    // 16 KB per k or v tile
constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * TILE_BYTES;
// 1 + 3 STAGES barriers of 8 bytes; 1 KB to align the tiles to the
// 1024-byte swizzle atom
constexpr int SMEM_BYTES = BAR_OFFSET + 8 * (1 + 3 * STAGES) + 1024;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, t;  // elements
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// returns once the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// --- TMA: the box at (0, t, h, b) of a 4-D (64, T, H, B) map into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int t, int h, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(t), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

// --- wgmma
// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128B swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x N, f32) = [scale_d] d + A (64 x 16) . B (N x 16)^T, A and B in
// shared memory, both K-major (N = 128, or 16 for the last key tile)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
      "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers, the accumulator's
// fragment layout) . B (16 x 64), B in shared memory MN-major (its rows are
// keys, 64 d values each: imm-trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> two bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A consumer's running state: rows g and g + 8 of its warp's 16.
struct Rows {
  float m0, m1, l0, l1;
};

// One key tile of NJ x 8 keys (NJ = 16: a full tile; 2: the short last
// tile) for one consumer warpgroup: s = q k^T, the online softmax, o += p v.
template <int NJ>
__device__ __forceinline__ void attend_tile(float (&o)[32], Rows& st,
                                            uint64_t dq, uint32_t ks,
                                            uint32_t vs, uint32_t v_full,
                                            uint32_t par, int k0, int T,
                                            float c, int tig) {
  float s[NJ * 4];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)  // 32 bytes of d per step
    wgmma_ss(s, dq + 2 * kk, make_desc(ks, 16, 1024) + 2 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);

  // mask the keys past T (only the last tile has any), row maxima (the 4
  // threads of a quad share a row)
  if (k0 + NJ * 8 > T) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (k0 + 8 * j + 2 * tig + i >= T)
          s[4 * j + i] = s[4 * j + 2 + i] = -INFINITY;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // every tile holds key k0 < T, so the new maxima are finite
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  // alpha from the same rounded products m c that the p of earlier tiles
  // were taken against, so that an unchanged maximum gives exactly 1
  const float mc0 = mn0 * c, mc1 = mn1 * c;
  const float al0 = ex2(st.m0 * c - mc0);
  const float al1 = ex2(st.m1 * c - mc1);

  // p in f32 for the row sums, in bf16 for the product: the fragments of
  // key blocks 2kk and 2kk + 1 are the A operand of step kk
  float rs0 = 0.0f, rs1 = 0.0f;
  uint32_t pf[NJ / 2][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float pa = ex2(__fmaf_rn(s[4 * j], c, -mc0));
    const float pb = ex2(__fmaf_rn(s[4 * j + 1], c, -mc0));
    const float pc = ex2(__fmaf_rn(s[4 * j + 2], c, -mc1));
    const float pd = ex2(__fmaf_rn(s[4 * j + 3], c, -mc1));
    rs0 += pa + pb;
    rs1 += pc + pd;
    pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(pa, pb);
    pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(pc, pd);
  }
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
  st.l0 = al0 * st.l0 + rs0;
  st.l1 = al1 * st.l1 + rs1;
  st.m0 = mn0;
  st.m1 = mn1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j + 0] *= al0;
    o[4 * j + 1] *= al0;
    o[4 * j + 2] *= al1;
    o[4 * j + 3] *= al1;
  }

  // o += p v over the tile's keys, 16 per step (2048 bytes of v rows)
  mbar_wait(v_full, par);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk)
    wgmma_rs(o, pf[kk], make_desc(vs + kk * 16 * ROW_BYTES, 1024, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attn_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int H, int T, Strides so,
                  float c) {
  extern __shared__ uint8_t smem_raw[];
  // tiles aligned to the 1024-byte swizzle atom, so the descriptors'
  // base offset is 0
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t qs = base;
  const uint32_t ks0 = base + Q_BYTES;
  const uint32_t vs0 = ks0 + STAGES * TILE_BYTES;
  const uint32_t q_full = base + BAR_OFFSET;
  const uint32_t k_full0 = q_full + 8;
  const uint32_t v_full0 = k_full0 + 8 * STAGES;
  const uint32_t empty0 = v_full0 + 8 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (T + BK - 1) / BK;
  // consumers with a row < T
  const int active = min(CONSUMERS, (T - q0 + 63) / 64);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full0 + 8 * s, 1);
      mbar_init(v_full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * active);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // --- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load(qs, &tq, q0, h, b, q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, r = j / STAGES;
        if (r > 0) mbar_wait(empty0 + 8 * s, (r - 1) & 1);
        mbar_expect_tx(k_full0 + 8 * s, TILE_BYTES);
        tma_load(ks0 + s * TILE_BYTES, &tk, j * BK, h, b, k_full0 + 8 * s);
        mbar_expect_tx(v_full0 + 8 * s, TILE_BYTES);
        tma_load(vs0 + s * TILE_BYTES, &tv, j * BK, h, b, v_full0 + 8 * s);
      }
    }
  } else {
    // --- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (wg < active) {
      const int tid = threadIdx.x % 128;
      const int warp = tid >> 5, lane = tid & 31;
      const int g = lane >> 2, tig = lane & 3;
      // this warpgroup's 64 rows of the q tile
      const uint64_t dq = make_desc(qs + wg * 64 * ROW_BYTES, 16, 1024);
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      Rows st{-INFINITY, -INFINITY, 0.0f, 0.0f};
      mbar_wait(q_full, 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t par = (j / STAGES) & 1;
        const int k0 = j * BK;
        mbar_wait(k_full0 + 8 * s, par);
        // v is waited on inside, just before o += p v
        const uint32_t ks = ks0 + s * TILE_BYTES, vs = vs0 + s * TILE_BYTES;
        if (T - k0 <= 16)
          attend_tile<2>(acc, st, dq, ks, vs, v_full0 + 8 * s, par, k0, T, c,
                         tig);
        else
          attend_tile<16>(acc, st, dq, ks, vs, v_full0 + 8 * s, par, k0, T, c,
                          tig);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }

      // out = acc * (1 / l), rounded to bf16; rows >= T are not written
      const float inv0 = 1.0f / st.l0, inv1 = 1.0f / st.l1;
      const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
      __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int dc = j * 8 + tig * 2;
        if (r0 < T)
          *reinterpret_cast<uint32_t*>(ob + r0 * so.t + dc) =
              pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (r1 < T)
          *reinterpret_cast<uint32_t*>(ob + r1 * so.t + dc) =
              pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D (64, T, H, B) bf16 tensor map over a (B, H, T, 64) view with
// strides in elements, boxes of `rows` x 64 with 128B swizzle; rows past T
// read as zeros.
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int B, int H, int T, long long sb, long long sh,
                  long long st, int rows) {
  const cuuint64_t dims[4] = {D, (cuuint64_t)T, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {D, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ENCODE_FAILED = 1000;  // + the CUresult of the encoder

}  // namespace

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success), or 1000 + the CUresult when a tensor map cannot be
// encoded (cudaErrorNotSupported when the driver has no encoder). q, k, v,
// o: device pointers to bf16 (B, H, T, 64) views; s*: their batch, head and
// token strides in elements (16-byte aligned rows and pointers).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int T, long long sqb,
                              long long sqh, long long sqt, long long skb,
                              long long skh, long long skt, long long svb,
                              long long svh, long long svt, long long sob,
                              long long soh, long long sot, float scale,
                              void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(encode, &tq, q, B, H, T, sqb, sqh, sqt, BQ);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tk, k, B, H, T, skb, skh, skt, BK);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &tv, v, B, H, T, svb, svh, svt, BK);
  if (r != CUDA_SUCCESS) return ENCODE_FAILED + (int)r;
  // the shared-memory limit, once per device
  static int attr_device = -1;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && device != attr_device) {
    e = cudaFuncSetAttribute(flash_attn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e == cudaSuccess) attr_device = device;
  }
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_attn_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, T,
      Strides{sob, soh, sot}, scale * LOG2E);
  return (int)cudaGetLastError();
}
