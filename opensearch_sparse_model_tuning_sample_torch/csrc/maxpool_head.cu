// Fused MLM-head masked max-pool for Hopper (sm_90a):
//
//     out[b, v] = max_l  mask[b, l] * (h[b, l, :] . w[v, :] + bias[v])
//
// h [B, L, D] bf16 (the post-LayerNorm head hidden states), mask [B, L] int32,
// w [V, D] bf16 (tied word embeddings or an untied decoder), bias [V] fp32,
// out [B, V] fp32. The [B, L, V] logits never reach device memory.
//
// Replaces the TPU kernel opensearch_sparse_model_tuning_sample_tpu/ops/
// pallas_maxpool.py (`_kernel` at :36, launched by `maxpool_head` through the
// `pallas_call` at :99), with the semantics of the production head
// bert.mlm_maxpool: the bias is added in fp32 after an fp32-accumulated
// product, then the sum is multiplied by the mask, so a masked position
// contributes exactly 0 (not -inf) and an all-masked row pools to 0.
// Positions at or past L are absent, not zeros.
//
// What bounds it: 2 * (unmasked positions) * D * V operations at 989 TFLOP/s
// (bf16 tensor cores) against V*D*2 + B*L*D*2 + B*L*4 + V*4 + B*V*4 bytes at
// 3.35 TB/s. At the mini width (B=50, L=64, D=256, V=30592) that is ~0.04 ms
// of operations against ~0.01 ms of bytes: the tensor cores bound it. Behind
// that sits the L2: every vocab tile re-reads all of h, ceil(V/TV) * B*L*D*2
// bytes per launch (~197 MB at [50, 64, 256] with TV = 256; ~1.5 GB at
// [8, 512, 768] with TV = 128), so the vocab tile is as tall as shared memory
// allows.
//
// Design. A GEMM with a max epilogue: M = vocab rows, N = the positions of
// one doc, K = D. The max over L is a max over each accumulator row.
//   * Resident vocab tile. A block owns TV = 64*MT vocab rows (MT = 4, 2 or 1,
//     the largest whose tile and two-stage h rings fit in 227 KB: TV = 256 at
//     D = 256, 128 at D = 768, 64 at D = 1024). Thread 0 loads its [TV, D]
//     slice of w once by TMA, in boxes of 64 K-columns with the 128-byte
//     swizzle, each box on its own mbarrier so the first product starts after
//     the first box. w is read from memory once per launch.
//   * h streamed through rings. Two consumer warpgroups take alternate docs
//     (ping-pong), each against all TV rows, each with its own ring of 2..8
//     stages fed by its own producer warp, so the two pipelines never wait on
//     each other. A stage is one TMA box of [64 positions, 64 K] of h[b]
//     (8 KB) with a full/empty mbarrier pair. The ring unit is a K box, not a
//     whole chunk, so a deep D still pipelines where only two stages fit
//     (D = 768).
//   * wgmma.mma_async m64n64k16, bf16 -> fp32, both operands K-major in
//     shared memory (A = the w tile, B = the h box). One commit group per
//     box; wait_group 1 releases the previous box while the next one runs.
//   * Epilogue per 64-position chunk, in registers: + bias (held per row),
//     * mask (shuffled from the lanes that read it), positions >= L dropped,
//     running max per row that carries across the chunks of one doc; at the
//     doc's end the max over the quad (shfl_xor 1, 2) and one fp32 store
//     per (v, b), v < V.
//   * Masked-chunk skip. Producer and consumers read each chunk's mask; a
//     chunk with every position masked is not loaded and its positions
//     contribute exactly 0, so the consumers take max(run, 0). 64 positions
//     is also the skip unit: no doc of the 64-token bucket the main path
//     ingests is shorter than 32 tokens, so a 32-position unit would skip
//     nothing there, while an N of 64 feeds the tensor cores better.
//   * Grid: one block per vocab tile, every doc in the block, no carry
//     between blocks and no atomics: the result is deterministic bit for bit.
// Against the four limits of the mma.sync kernel it replaces: loads and
// compute overlap (TMA rings, async wgmma); no fragment loads from shared
// memory (wgmma reads its operands through descriptors); 10 warps per SM in
// two independent pipelines instead of 4-8 synchronous warps; and the
// vocab tile at D = 768 is 128 rows, with each h box feeding two m64 tiles.
//
// A lost copy would hang the card, so every mbarrier wait traps after ~4 s.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(). The TMA descriptors are encoded on the host for every
// launch through the driver entry point (no -lcuda at link time).
//
// The training forward (`maxpool_head_argmax_bf16`, which also writes the
// position of each maximum) is a kernel of its own below,
// `maxpool_head_argmax_kernel`: the same rings, products and tiles, in a
// warp-specialised block of three warpgroups with `setmaxnreg`.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNc = 64;                       // positions per chunk (wgmma N)
constexpr int kBoxK = 64;                     // K columns per box: one 128-byte swizzle row
constexpr int kBoxBytes = kNc * kBoxK * 2;    // one h box, bf16
constexpr int kConsumerWGs = 2;               // warpgroups, one ring each
constexpr int kThreads = kConsumerWGs * 128 + kConsumerWGs * 32;  // + a producer warp per ring
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;              // dynamic shared memory a block may use
constexpr int kIngestMaxMT = 4;               // the ingest kernel's tile: at most 256 rows
constexpr int kStreamMT = 2;                  // the streamed kernel's tile: 128 rows

// the bytes of one ring stage: an h box, and in the streamed kernel the
// w tile's box of the same K columns beside it
template <int MT, bool kStream>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return kBoxBytes + (kStream ? 64 * MT * kBoxK * 2 : 0);
}

struct Plan {
  int mt;       // m64 tiles per warpgroup (TV = 64 * mt); 0 if D does not fit
  int kblocks;  // K boxes per row: ceil(D / 64)
  int stages;   // stages per ring
  size_t smem;  // dynamic shared memory bytes
};

Plan make_plan(int D, int max_mt = 4) {
  Plan p{0, (D + kBoxK - 1) / kBoxK, 0, 0};
  const size_t per_stage = (size_t)kConsumerWGs * (kBoxBytes + 16);  // boxes + full/empty
  for (int mt = 4; mt >= 1; mt /= 2) {
    if (mt > max_mt) continue;
    const size_t fixed = 1024 /* alignment slack */ + (size_t)p.kblocks * mt * 64 * kBoxK * 2 +
                         (size_t)p.kblocks * 8 /* w barriers */ + 16 /* turn barriers */;
    if (fixed + 2 * per_stage > (size_t)kMaxSmem) continue;
    const size_t stages = ((size_t)kMaxSmem - fixed) / per_stage;
    p.mt = mt;
    p.stages = stages < (size_t)kMaxStages ? (int)stages : kMaxStages;
    p.smem = fixed + p.stages * per_stage;
    return p;
  }
  return p;
}

// Past the widest resident tile (D above about 1 536) the w tile streams
// through the rings beside h: each stage holds an h box and the [TV, 64]
// box of w for the same K columns, so shared memory no longer bounds D.
Plan make_stream_plan(int D) {
  Plan p{kStreamMT, (D + kBoxK - 1) / kBoxK, 0, 0};
  const size_t per_stage =
      (size_t)kConsumerWGs * (stage_bytes<kStreamMT, true>() + 16);  // boxes + full/empty
  const size_t fixed = 1024 /* alignment slack */ + 16 /* turn barriers */;
  const size_t stages = ((size_t)kMaxSmem - fixed) / per_stage;
  p.stages = stages < (size_t)kMaxStages ? (int)stages : kMaxStages;
  p.smem = fixed + p.stages * per_stage;
  return p;
}

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of `parity` to complete; trap instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  for (uint32_t i = 1;; ++i) {
    if (mbar_try_wait(bar, parity)) return;
    if ((i & 255) == 0 && global_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// K-major operand in shared memory with the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO); LBO is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators across a wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major bf16 in shared
// memory, fp32 accumulate; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// ---- the kernel -----------------------------------------------------------

struct Smem {
  uint32_t w;      // w tile: kblocks boxes of [TV rows, 64 K], swizzled
  uint32_t ring;   // ring p, stage s at ring + (p * stages + s) * stage_bytes
  uint32_t w_bar;  // kblocks barriers
  uint32_t full;   // 2 * stages barriers
  uint32_t empty;  // 2 * stages barriers
  uint32_t turn;   // 2 barriers: the training forward's turns (below)
};

// One producer warp: the h boxes of every live chunk of docs p, p + 2, ...
// into ring p (kStream: each beside its box of the block's w tile).
template <int MT = 1, bool kStream = false>
__device__ __forceinline__ void produce(int p, const Smem& sm, int stages, int kblocks,
                                        const CUtensorMap* hmap, const int32_t* __restrict__ mask,
                                        int B, int L, const CUtensorMap* wmap = nullptr) {
  constexpr uint32_t kStage = stage_bytes<MT, kStream>();
  const int lane = threadIdx.x & 31;
  const uint32_t ring = sm.ring + p * stages * kStage;
  const uint32_t full = sm.full + p * stages * 8, empty = sm.empty + p * stages * 8;
  int s = 0, ph = 0;
  for (int b = p; b < B; b += kConsumerWGs) {
    const int32_t* mrow = mask + (size_t)b * L;
    for (int l0 = 0; l0 < L; l0 += kNc) {
      const int la = l0 + lane, lb = l0 + 32 + lane;
      const bool live = (la < L && mrow[la] != 0) || (lb < L && mrow[lb] != 0);
      if (!__any_sync(0xffffffffu, live)) continue;
      if (lane == 0)
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(empty + s * 8, ph ^ 1);
          mbar_expect_tx(full + s * 8, kStage);
          tma_load_3d(ring + s * kStage, hmap, kb * kBoxK, l0, b, full + s * 8);
          if (kStream)
            tma_load_2d(ring + s * kStage + kBoxBytes, wmap, kb * kBoxK, blockIdx.x * 64 * MT,
                        full + s * 8);
          if (++s == stages) { s = 0; ph ^= 1; }
        }
      __syncwarp();
    }
  }
  // no copy into this block's shared memory may outlive the block
  if (!kStream && p == 0 && lane == 0)
    for (int kb = 0; kb < kblocks; ++kb) mbar_wait(sm.w_bar + kb * 8, 0);
}

// The products of one live chunk of a doc: acc[mt] = the w tile's rows mt
// against the chunk's 64 positions, over every K box of the consumer's
// ring, each box handed back to the producer as soon as its products are
// done (wait_group 1 while the next box's run). `issued()` runs once the
// last box's products are issued; returns with all of them done. kStream:
// the w box is the stage's, beside the h box.
template <int MT, bool kStream = false, class Issued>
__device__ __forceinline__ void chunk_products(float (&acc)[MT][32], const Smem& sm, uint32_t ring,
                                               uint32_t full, uint32_t empty, int stages,
                                               int kblocks, int& s, int& ph, Issued issued) {
  constexpr uint32_t kTileBytes = 64 * MT * kBoxK * 2;  // one K box of the w tile
  constexpr uint32_t kStage = stage_bytes<MT, kStream>();
  const int lane = threadIdx.x & 31;
  int prev = 0;
  for (int kb = 0; kb < kblocks; ++kb) {
    if (!kStream) mbar_wait(sm.w_bar + kb * 8, 0);
    mbar_wait(full + s * 8, ph);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
    const uint32_t b_box = ring + s * kStage;
    const uint32_t a_box = kStream ? b_box + kBoxBytes : sm.w + kb * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBoxK / 16; ++kk) {
      const uint64_t bd = smem_desc(b_box + kk * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_m64n64k16(acc[mt], smem_desc(a_box + mt * 64 * 128 + kk * 32), bd,
                        (kb | kk) != 0);
    }
    wgmma_commit();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (kb > 0) {
      wgmma_wait<1>();  // the previous box's products are done
      if (lane == 0) mbar_arrive(empty + prev * 8);
    }
    prev = s;
    if (++s == stages) { s = 0; ph ^= 1; }
  }
  issued();
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
  if (lane == 0) mbar_arrive(empty + prev * 8);
}

// One consumer warpgroup of the ingest kernel: docs wg, wg + 2, ... against
// all TV rows.
template <int MT, bool kStream = false>
__device__ void consume(int wg, const Smem& sm, int stages, int kblocks,
                        const int32_t* __restrict__ mask, const float* __restrict__ bias,
                        float* __restrict__ out, int B, int L, int V) {
  constexpr int TV = 64 * MT;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // accumulator row g (and g+8), columns 2t, 2t+1
  const int v0 = blockIdx.x * TV;

  float bias_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int v = v0 + mt * 64 + warp * 16 + g + hh * 8;
      bias_r[mt][hh] = v < V ? bias[v] : 0.f;
    }

  const uint32_t ring = sm.ring + wg * stages * stage_bytes<MT, kStream>();
  const uint32_t full = sm.full + wg * stages * 8, empty = sm.empty + wg * stages * 8;
  int s = 0, ph = 0;
  float acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  for (int b = wg; b < B; b += kConsumerWGs) {
    float run[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) run[mt][0] = run[mt][1] = -INFINITY;
    const int32_t* mrow = mask + (size_t)b * L;

    for (int l0 = 0; l0 < L; l0 += kNc) {
      const int la = l0 + lane, lb = l0 + 32 + lane;
      const float m0 = la < L ? (float)mrow[la] : 0.f;
      const float m1 = lb < L ? (float)mrow[lb] : 0.f;
      if (!__any_sync(0xffffffffu, m0 != 0.f || m1 != 0.f)) {
        // every position here is masked and contributes exactly 0
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) run[mt][hh] = fmaxf(run[mt][hh], 0.f);
        continue;
      }
      chunk_products<MT, kStream>(acc, sm, ring, full, empty, stages, kblocks, s, ph, [] {});

      // accumulator register 4j + 2hh + e: vocab row warp*16 + g + 8hh of
      // each m64 tile, position l0 + 8j + 2t + e
      const int nvalid = L - l0;
#pragma unroll
      for (int j = 0; j < kNc / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          const float m = __shfl_sync(0xffffffffu, j < 4 ? m0 : m1, c & 31);
          const bool present = c < nvalid;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float x = (acc[mt][4 * j + 2 * hh + e] + bias_r[mt][hh]) * m;
              if (present) run[mt][hh] = fmaxf(run[mt][hh], x);
            }
        }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float r = run[mt][hh];
        const int v = v0 + mt * 64 + warp * 16 + g + hh * 8;
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        if (t == 0 && v < V) out[(size_t)b * V + v] = r;
      }
  }
}

// Shared memory carve-up and the block's w tile, loaded once by thread 0
// (kStream: no resident tile; its boxes come through the rings).
template <int MT, bool kStream = false>
__device__ __forceinline__ Smem block_setup(unsigned char* smem_raw, const CUtensorMap* wmap,
                                            int kblocks, int stages) {
  constexpr int TV = 64 * MT;
  const uint32_t raw = smem_u32(smem_raw);
  Smem sm;
  sm.w = (raw + 1023) & ~1023u;  // the 128-byte swizzle repeats every 1024 bytes
  if (kStream) kblocks = 0;       // no w tile and no w barriers
  sm.ring = sm.w + kblocks * TV * kBoxK * 2;
  sm.w_bar = sm.ring + kConsumerWGs * stages * stage_bytes<MT, kStream>();
  sm.full = sm.w_bar + kblocks * 8;
  sm.empty = sm.full + kConsumerWGs * stages * 8;
  sm.turn = sm.empty + kConsumerWGs * stages * 8;
  if (threadIdx.x == 0) {
    for (int kb = 0; kb < kblocks; ++kb) mbar_init(sm.w_bar + kb * 8, 1);
    for (int i = 0; i < kConsumerWGs * stages; ++i) {
      mbar_init(sm.full + i * 8, 1);
      mbar_init(sm.empty + i * 8, 4);  // one arrival per consumer warp
    }
    for (int i = 0; i < kConsumerWGs; ++i) mbar_init(sm.turn + i * 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the block's w tile, once
    const uint32_t w_bytes = TV * kBoxK * 2;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_expect_tx(sm.w_bar + kb * 8, w_bytes);
      tma_load_2d(sm.w + kb * w_bytes, wmap, kb * kBoxK, blockIdx.x * TV, sm.w_bar + kb * 8);
    }
  }
  __syncthreads();
  return sm;
}

// The ingest kernel past the widest resident tile (D 2 048: Moonlight's
// head at V 163 840): the same block, the w tile streamed beside h.
template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
maxpool_head_stream_kernel(const __grid_constant__ CUtensorMap hmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const int32_t* __restrict__ mask, const float* __restrict__ bias,
                           float* __restrict__ out, int B, int L, int V, int kblocks, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = block_setup<MT, true>(smem_raw, &wmap, kblocks, stages);
  const int warp = threadIdx.x >> 5;
  if (warp >= kConsumerWGs * 4)
    produce<MT, true>(warp - kConsumerWGs * 4, sm, stages, kblocks, &hmap, mask, B, L, &wmap);
  else
    consume<MT, true>(warp >> 2, sm, stages, kblocks, mask, bias, out, B, L, V);
}

template <int MT>
__global__ void __launch_bounds__(kThreads, 1)
maxpool_head_kernel(const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const int32_t* __restrict__ mask, const float* __restrict__ bias,
                    float* __restrict__ out, int B, int L, int V, int kblocks, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = block_setup<MT>(smem_raw, &wmap, kblocks, stages);
  const int warp = threadIdx.x >> 5;
  if (warp >= kConsumerWGs * 4)
    produce(warp - kConsumerWGs * 4, sm, stages, kblocks, &hmap, mask, B, L);
  else
    consume<MT>(warp >> 2, sm, stages, kblocks, mask, bias, out, B, L, V);
}

// ---- the training forward -------------------------------------------------
//
// out as above and idx[b, v] int32, the position l that gave out[b, v], for
// the backward (csrc/maxpool_head_bwd.cu). Among equal maxima the smallest
// position wins; a masked chunk that is skipped reports its first position
// (masked, so it carries no gradient); an all-masked row pools to 0 at
// position 0. The products and the values are the ingest kernel's, in the
// same order, so out equals maxpool_head's bit for bit.
//
// Design. The running index costs registers beside the running max: in the
// ingest kernel's 320-thread block, under ptxas's cap of 168 registers a
// thread, the 256-row tile spilled 160 bytes, which held the argmax to a
// 128-row tile while it was a flag on that kernel: twice the blocks, each
// re-reading all of h from L2, half the products per h box, and 1.81 waves
// on 132 SMs at V = 30592. This kernel is warp-specialised into three full
// warpgroups: two consumer warpgroups (docs in ping-pong, as in the ingest
// kernel) and one producer warpgroup whose first two warps feed one ring
// each. `setmaxnreg` moves registers from the producers (40 a thread) to
// the consumers (232), so a consumer holds the 256-row tile's 128
// accumulators, the running max and index and the bias with room to spare.
// Every warp of every warpgroup executes its warpgroup's `setmaxnreg` (a
// partial warpgroup hangs it). The consumers take turns at issuing their
// products (see consume_argmax), so that they do not issue, and then run
// their epilogues, in step.
//
// Epilogue per chunk, two passes over the thread's 16 positions of each of
// its 2*MT rows: (1) x = (acc + bias) * mask in place and the chunk
// maximum by fmaxf; (2) the first of the thread's positions that holds
// that maximum (a compare and a select each, from the last to the first),
// then one compare with the running max, whose strict > keeps an earlier
// chunk's tie. At the doc's end the quad (shfl_xor 1, 2) takes
// the larger value, on equal values the smaller position.

constexpr int kArgmaxThreads = (kConsumerWGs + 1) * 128;  // + a producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// the registers the block starts with (ptxas's cap for 384 threads, 168)
// are what the warpgroups hold after the transfer
static_assert(128 * kProducerRegs + kConsumerWGs * 128 * kConsumerRegs == kArgmaxThreads * 168,
              "setmaxnreg must move registers within the block's allocation");

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// One chunk's epilogue of the training forward (see above). A position at
// or past L (mask 0, h read as zeros) gets a finite x but no say in the
// chunk maximum; it comes after every present one in the thread's order,
// so the search, which takes the first match, never names it.
template <int MT>
__device__ __forceinline__ void argmax_chunk(float (&acc)[MT][32], float (&run)[MT][2],
                                             int (&arg)[MT][2], const float (&bias_r)[MT][2],
                                             float m0, float m1, int l0, int t, int nvalid) {
  float cmax[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) cmax[mt][0] = cmax[mt][1] = -INFINITY;
  // training epilogue: register 4j + 2hh + e is row warp*16 + g + 8hh of
  // each m64 tile at position l0 + 8j + 2t + e
#pragma unroll
  for (int j = 0; j < kNc / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t + e;
      const float m = __shfl_sync(0xffffffffu, j < 4 ? m0 : m1, c & 31);
      const bool present = c < nvalid;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float& x = acc[mt][4 * j + 2 * hh + e];
          x = (x + bias_r[mt][hh]) * m;
          if (present) cmax[mt][hh] = fmaxf(cmax[mt][hh], x);
        }
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float cm = cmax[mt][hh];
      int p = 0;  // 8j + e of the thread's first position that holds cm
#pragma unroll
      for (int i = kNc / 4 - 1; i >= 0; --i)
        if (acc[mt][4 * (i >> 1) + 2 * hh + (i & 1)] == cm) p = 8 * (i >> 1) + (i & 1);
      if (cm > run[mt][hh]) {
        run[mt][hh] = cm;
        arg[mt][hh] = l0 + 2 * t + p;
      }
    }
}

// One consumer warpgroup of the training forward: docs wg, wg + 2, ...
// Turns: warpgroup wg issues a chunk's products only when it holds the
// turn (barrier turn[wg], one arrival from each warp of the other), and
// hands it over as soon as they are issued, before its own epilogue. So
// the two alternate on the tensor cores and each epilogue runs under the
// other's products; without the turn they fall into step and both
// epilogues are exposed. Each takes one turn per chunk, a skipped one too,
// and warpgroup 1 makes up an odd B with a doc of empty turns, so both take
// ceil(B/2) * ceil(L/64) turns; warpgroup 0 takes the first, and warpgroup
// 1 hands on none after its last. Turns only where a ring holds a whole
// chunk's boxes (stages >= kblocks: D <= 256 at the 256-row tile): with
// fewer stages the holder's issue waits on its own loads while the other
// warpgroup may not issue, so the two no longer overlap their loads. At
// D = 768 (2 stages, 12 boxes a chunk) turns cost more than they save;
// chip_smoke's ablations `argmax_no_turns` and `argmax_turns_always` time
// both sides.
template <int MT>
__device__ __forceinline__ void consume_argmax(int wg, const Smem& sm, int stages, int kblocks,
                                               const int32_t* __restrict__ mask,
                                               const float* __restrict__ bias,
                                               float* __restrict__ out,
                                               int32_t* __restrict__ idx_out, int B, int L,
                                               int V) {
  constexpr int TV = 64 * MT;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int v0 = blockIdx.x * TV;

  float bias_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int v = v0 + mt * 64 + warp * 16 + g + hh * 8;
      bias_r[mt][hh] = v < V ? bias[v] : 0.f;
    }

  const uint32_t ring = sm.ring + wg * stages * kBoxBytes;
  const uint32_t full = sm.full + wg * stages * 8, empty = sm.empty + wg * stages * 8;
  int s = 0, ph = 0;
  float acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  const uint32_t my_turn = sm.turn + wg * 8, your_turn = sm.turn + (wg ^ 1) * 8;
  const int B2 = B + (B & 1);  // B rounded up to even: doc B (if odd) is empty turns
  const bool take_turns = stages >= kblocks;
  int turns = 0;
  if (take_turns && wg == 1 && lane == 0) mbar_arrive(your_turn);  // 0 takes the first turn

  for (int b = wg; b < B2; b += kConsumerWGs) {
    const bool real = b < B;
    float run[MT][2];
    int arg[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      run[mt][0] = run[mt][1] = -INFINITY;
      arg[mt][0] = arg[mt][1] = 0;
    }
    const int32_t* mrow = mask + (size_t)b * L;

    for (int l0 = 0; l0 < L; l0 += kNc) {
      const int la = l0 + lane, lb = l0 + 32 + lane;
      const float m0 = real && la < L ? (float)mrow[la] : 0.f;
      const float m1 = real && lb < L ? (float)mrow[lb] : 0.f;
      const bool hand_on = take_turns && (wg == 0 || b + kConsumerWGs < B2 || l0 + kNc < L);
      auto pass_turn = [&] {
        if (hand_on && lane == 0) mbar_arrive(your_turn);
      };
      if (take_turns) mbar_wait(my_turn, turns++ & 1);
      if (!__any_sync(0xffffffffu, m0 != 0.f || m1 != 0.f)) {
        pass_turn();
        // every position here is masked and contributes exactly 0, at l0
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (0.f > run[mt][hh]) {
              run[mt][hh] = 0.f;
              arg[mt][hh] = l0;
            }
        continue;
      }
      chunk_products<MT>(acc, sm, ring, full, empty, stages, kblocks, s, ph, pass_turn);
      argmax_chunk<MT>(acc, run, arg, bias_r, m0, m1, l0, t, L - l0);
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float r = run[mt][hh];
        int a = arg[mt][hh];
#pragma unroll
        for (int off = 1; off <= 2; off *= 2) {
          const float ro = __shfl_xor_sync(0xffffffffu, r, off);
          const int ao = __shfl_xor_sync(0xffffffffu, a, off);
          if (ro > r || (ro == r && ao < a)) {
            r = ro;
            a = ao;
          }
        }
        const int v = v0 + mt * 64 + warp * 16 + g + hh * 8;
        if (real && t == 0 && v < V) {
          out[(size_t)b * V + v] = r;
          idx_out[(size_t)b * V + v] = a;
        }
      }
  }
}

template <int MT>
__global__ void __launch_bounds__(kArgmaxThreads, 1)
maxpool_head_argmax_kernel(const __grid_constant__ CUtensorMap hmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const int32_t* __restrict__ mask, const float* __restrict__ bias,
                           float* __restrict__ out, int32_t* __restrict__ idx_out, int B, int L,
                           int V, int kblocks, int stages) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sm = block_setup<MT>(smem_raw, &wmap, kblocks, stages);
  // one branch per role that never joins the other: ptxas then knows each
  // path's register count from its setmaxnreg
  const int wg = threadIdx.x >> 7;
  if (wg == kConsumerWGs) {
    setmaxnreg_dec<kProducerRegs>();
    const int p = (threadIdx.x >> 5) & 3;  // warps 2 and 3 of the producers have no ring
    if (p < kConsumerWGs) produce(p, sm, stages, kblocks, &hmap, mask, B, L);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume_argmax<MT>(wg, sm, stages, kblocks, mask, bias, out, idx_out, B, L, V);
  }
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// bf16 tensor of `rank` dims (innermost first) read in [64 x rows] boxes
// with the 128-byte swizzle; out-of-range rows and columns read as zeros.
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
            box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT, bool kArgmax, bool kStream = false>
int launch(const CUtensorMap& hmap, const CUtensorMap& wmap, const void* mask, const void* bias,
           void* out, void* idx, int B, int L, int V, const Plan& plan, cudaStream_t stream) {
  constexpr int TV = 64 * MT;
  const int grid = (V + TV - 1) / TV;
  const int32_t* m = static_cast<const int32_t*>(mask);
  const float* bi = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if constexpr (kStream) {
    err = cudaFuncSetAttribute(maxpool_head_stream_kernel<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    maxpool_head_stream_kernel<MT><<<grid, kThreads, plan.smem, stream>>>(
        hmap, wmap, m, bi, o, B, L, V, plan.kblocks, plan.stages);
  } else if constexpr (kArgmax) {
    err = cudaFuncSetAttribute(maxpool_head_argmax_kernel<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    maxpool_head_argmax_kernel<MT><<<grid, kArgmaxThreads, plan.smem, stream>>>(
        hmap, wmap, m, bi, o, static_cast<int32_t*>(idx), B, L, V, plan.kblocks, plan.stages);
  } else {
    err = cudaFuncSetAttribute(maxpool_head_kernel<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    maxpool_head_kernel<MT><<<grid, kThreads, plan.smem, stream>>>(
        hmap, wmap, m, bi, o, B, L, V, plan.kblocks, plan.stages);
  }
  return (int)cudaGetLastError();
}

template <bool kArgmax>
int dispatch(const void* h, const void* mask, const void* w, const void* bias, void* out, void* idx,
        int B, int L, int D, int V, void* stream) {
  if (B <= 0 || L <= 0 || V <= 0 || D <= 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  // TMA reads from 16-byte aligned addresses with 16-byte aligned row strides
  if (reinterpret_cast<uintptr_t>(h) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorMisalignedAddress;
  Plan plan = make_plan(D, kArgmax ? 4 : kIngestMaxMT);
  // the ingest path streams its w tile where no resident one fits
  const bool stream_w = !plan.mt && !kArgmax;
  if (stream_w) plan = make_stream_plan(D);
  if (!plan.mt) return (int)cudaErrorInvalidValue;

  CUtensorMap hmap, wmap;
  const cuuint64_t h_dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t h_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  const cuuint32_t h_box[3] = {kBoxK, kNc, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)D, (cuuint64_t)V};
  const cuuint64_t w_strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t w_box[2] = {kBoxK, (cuuint32_t)(64 * plan.mt)};
  if (!encode(&hmap, h, 3, h_dims, h_strides, h_box) ||
      !encode(&wmap, w, 2, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!kArgmax)
    if (stream_w)
      return launch<kStreamMT, false, true>(hmap, wmap, mask, bias, out, idx, B, L, V, plan, s);
  switch (plan.mt) {
    case 4: return launch<4, kArgmax>(hmap, wmap, mask, bias, out, idx, B, L, V, plan, s);
    case 2: return launch<2, kArgmax>(hmap, wmap, mask, bias, out, idx, B, L, V, plan, s);
    default: return launch<1, kArgmax>(hmap, wmap, mask, bias, out, idx, B, L, V, plan, s);
  }
}

}  // namespace

extern "C" {

// Largest hidden width the kernel takes (a 64-row vocab tile and two stages
// per ring must fit in shared memory); the wrapper raises above it.
int maxpool_head_max_dim() {
  int D = 8;
  while (make_plan(D + 8).mt) D += 8;
  return D;
}

// Largest hidden width the ingest kernel takes: past maxpool_head_max_dim()
// it streams its w tile (maxpool_head_stream_kernel), whose shared memory
// does not grow with D.
int maxpool_head_ingest_max_dim() { return 16384; }

int maxpool_head_bf16(const void* h, const void* mask, const void* w, const void* bias,
                      void* out, int B, int L, int D, int V, void* stream) {
  return dispatch<false>(h, mask, w, bias, out, nullptr, B, L, D, V, stream);
}

// The training forward: out as above, and idx [B, V] int32, the position of
// each maximum.
int maxpool_head_argmax_bf16(const void* h, const void* mask, const void* w, const void* bias,
                             void* out, void* idx, int B, int L, int D, int V, void* stream) {
  return dispatch<true>(h, mask, w, bias, out, idx, B, L, D, V, stream);
}

}  // extern "C"
