// Grouped expert GEMMs and the combine of a DeepSeekMoE layer, for Hopper
// (sm_90a): the routed experts of `ops/moe.py` (`models/moonlight.py`,
// `models/kimi_linear.py`).
//
//   gate-up:  h[r, :] = silu(u[token[r]] . gate[e]^T) * (u[token[r]] . up[e]^T)  [R, I]
//   down:     y[r, :] = h[r] . down[e]^T                                [R, D]
//   combine:  x[t, :] += sum_s w[t, s] * y[pos[t, s], :] + shared[t, :]  (fp32)
//
// for every row r of expert e's group, offsets[e] <= r < offsets[e + 1]:
// the token-expert rows sorted by expert, the offsets on the card, and the
// gate-up reading each row's token from u in place (no gathered copy).
// Rows past offsets[E] (experts a card does not hold) are neither read nor
// written, and the combine skips their slots (pos -1). u, gate, up, down,
// h, y and shared are bf16; products accumulate in fp32; SiLU·mul
// runs in fp32 on the accumulators and is rounded to bf16 once. The combine
// adds each token's k rows in slot order, then the shared expert, into the
// fp32 residual stream: no atomics, so the result is the same bit for bit on
// every run.
//
// It replaces no TPU kernel: the JAX package runs no expert layer.
//
// What bounds it: a layer's products take 2 * R * 3 * D * I operations at
// 989 TFLOP/s against the held experts' weights (E * 3 * D * I * 2 bytes)
// and the rows in and out at 3.35 TB/s.
//   * Moonlight (D 2 048, I 1 408, 64 experts, 6 a token), one full batch of
//     14 968 tokens (R 89 808): gate-up 1.047 ms of operations against
//     0.74 GB of weights (0.22 ms), down 0.524 ms against 0.37 GB; about
//     1 400 rows an expert.
//   * Kimi Linear's share (D 2 304, I 1 024, 128 of 256 experts, 8 a token),
//     its largest batch (about 206 000 held rows): gate-up 1.96 ms of
//     operations against 1.21 GB (0.36 ms), down 0.98 ms against 0.60 GB;
//     340-1 900 rows an expert.
// The tensor cores bound both until an expert's rows fall near
// 2 * 989 / 3.35 / 2 ~ 300, and on Hopper their full rate comes only
// through wgmma. Behind the tensor cores sits what reaches each SM: a
// [128, 256] tile of K 64 needs 48 KB for 4.2 MFLOP, about 11 TB/s over
// 132 SMs at the full rate.
//
// Design: one persistent, warp-specialised kernel body for both products,
// in clusters of two blocks.
//   * The tile list. A cluster's tile is (expert, 256 rows of its group, 256
//     weight rows); its block of rank r takes rows 128 r .. 128 r + 127.
//     Expert e's tiles follow those of the experts before it, ceil(rows /
//     256) row pairs times the column tiles, column tile outer. Every role
//     of every block walks the same list from the offsets (a cursor over the
//     experts, read from the card), cluster c taking tiles c, c + clusters,
//     ... up to the last real one; the grid is as many clusters as the card
//     holds at once (read once), at most as many as tiles could exist. The
//     host never learns how the rows fell and nothing syncs. Neighbouring
//     clusters take one expert's tiles at one time: its weights (Moonlight's
//     gate and up about 11.5 MB) and rows stay in L2.
//   * The ring. 4 stages of K 64, each the A tile [128 rows, 64] (16 KB)
//     and the B tile [256 weight rows, 64] (32 KB), both K-major with the
//     128-byte swizzle, each stage with a full and an empty mbarrier.
//   * The producer warpgroup (40 registers after `setmaxnreg`). B is two TMA
//     boxes of 128 weight rows from the [E, N, K] stacks (gate-up: 128 rows
//     of gate and the same 128 of up; down: 256 rows of down): each block
//     of the cluster loads one box and multicasts it to both, so L2 sends
//     each weight tile once for 256 rows. Weight rows past N and K past its
//     end read as zeros. Down's A, the sorted rows h [R, I], is a TMA box at
//     the block's first row: rows past the group are loaded and computed,
//     never stored, and rows past R read as zeros. Gate-up's A is each row's
//     token read in place: a TMA box cannot gather rows, so the 128
//     producer threads copy the block's rows with cp.async, 16 bytes each, 8
//     threads a row (one 128-byte line), into the same swizzled layout, and
//     each signals the stage's full barrier with
//     `cp.async.mbarrier.arrive.noinc` (the barrier counts 128 such
//     arrivals and the TMA's bytes). Rows past the group and K past its end
//     are zero-filled. A stage is free again once every consumer warp of
//     both blocks has handed it back, as the other block's box lands in it.
//   * Two consumer warpgroups (232 registers) take rows 0-63 and 64-127 of
//     the block's tile: wgmma.mma_async m64n256k16, bf16 -> fp32, both
//     operands from shared memory through descriptors, 128 accumulators a
//     thread. A stage is handed back as soon as the next stage's products
//     are issued and its own are done (wait_group 1). In gate-up the 256
//     columns are gate's 128 and up's 128, so the thread that holds gate
//     column c holds up column c 64 registers on, and SiLU·mul is a register
//     epilogue in fp32, rounded to bf16 once.
//   * The epilogue. A warpgroup whose 64 rows all lie in the group writes
//     its output a box of [64 rows, 64 columns] at a time into shared memory
//     (swizzled, two boxes of 8 KB a warpgroup in turn) and stores each by
//     TMA, columns past N left out; it goes on to the next tile's products
//     while the store runs. A warpgroup with rows past the group's end (the
//     last rows of an expert) stores only the rows below it, from registers,
//     so no row at or past offsets[E] is ever written. Meanwhile the
//     producer fills the ring with the next tile's stages.
//   * The same bits on every run: a tile is one block's, its K loop runs in
//     one order whatever SM takes it, and nothing is atomic.
// A lost copy would hang the card, so every mbarrier wait traps after ~4 s
// (as in csrc/maxpool_head.cu, whose TMA and mbarrier helpers these are).
// The combine: one block per token, 16-byte loads of its k rows.
// Each launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(). The TMA descriptors are encoded on the host for every
// launch, through the runtime's entry-point query (no -lcuda at link time).
// The trace names them `moe_gate_up_kernel`, `moe_down_kernel` and
// `moe_combine_kernel`.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                      // rows a block's tile: 64 a consumer warpgroup
constexpr int kCluster = 2;                  // blocks a cluster: rows 0-127 and 128-255
constexpr int BN = 256;                      // weight rows a tile: the wgmma's N
constexpr int kBox = 128;                    // weight rows a TMA box
constexpr int BK = 64;                       // K a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr uint32_t kABytes = BM * BK * 2;    // 16 KB
constexpr uint32_t kBBytes = BN * BK * 2;    // 32 KB
constexpr uint32_t kStageBytes = kABytes + kBBytes;
constexpr int kOutCols = 64;                 // columns an epilogue box: one 128-byte row
constexpr uint32_t kOutBytes = 64 * kOutCols * 2;  // a warpgroup's 64 rows, 8 KB
constexpr int kConsumerWGs = 2;
constexpr int kThreads = (kConsumerWGs + 1) * 128;  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// the registers the block starts with (ptxas's cap for 384 threads, 168)
// are what the warpgroups hold after the transfer
static_assert(128 * kProducerRegs + kConsumerWGs * 128 * kConsumerRegs == kThreads * 168,
              "setmaxnreg must move registers within the block's allocation");
// alignment slack, the ring, two epilogue boxes a consumer warpgroup, the
// ring's full and empty barriers
constexpr int kSmem = 1024 + STAGES * kStageBytes + kConsumerWGs * 2 * kOutBytes + 2 * STAGES * 8;
static_assert(kSmem <= 232448, "a block has 227 KB of shared memory");

struct Params {
  const __nv_bfloat16* x;  // gate-up: the tokens [T, K], row r at token[r]
  const long long* token;  // gate-up: [R]
  const int* offsets;      // [E + 1]
  int K, N, E;
};

// ---- PTX wrappers (those of csrc/maxpool_head.cu, and cp.async's) ----------

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

// The box into the same place in the shared memory of every block of
// `mask` in the cluster, each block's barrier at `bar` told of its bytes.
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const CUtensorMap* map, int c0,
                                                      int c1, int c2, uint32_t bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster: what each wrote before is
// seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Arrive on the barrier at `bar` in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

// 16 bytes from global to shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// The barrier's phase counts one arrival of this thread once all its
// earlier cp.async copies have landed (noinc: within the barrier's count).
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The box at `src` in shared memory to the tensor at (c0, c1); the parts
// outside the tensor are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most N of this thread's committed stores still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The 128 threads of one warpgroup, on named barrier `id` (0 is the block's).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Orders this thread's view of shared memory written through the generic
// proxy (cp.async) before the async proxy's reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, both K-major bf16 in shared
// memory, fp32 accumulate; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a, uint64_t b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// ---- the tile list ----------------------------------------------------------

// Columns of the output a tile covers: gate-up's 256 weight rows are 128
// of gate and 128 of up.
template <bool GATE_UP>
__host__ __device__ constexpr int tile_cols() {
  return GATE_UP ? BN / 2 : BN;
}

struct Tile {
  int e, row0, row_end, n0;  // block's first row, its group's end, first column
};

// The cluster's tiles in increasing order: expert e's are [start, start +
// ceil(rows / 256) * columns), column tile outer, row pair inner. A cursor
// over the experts that only moves forward, reading the offsets.
template <bool GATE_UP>
struct TileWalk {
  const int* __restrict__ offsets;
  int E, ncol, e = 0, start = 0, r0 = 0, r1 = 0, pairs = 0;

  __device__ TileWalk(const Params& p)
      : offsets(p.offsets), E(p.E), ncol((p.N + tile_cols<GATE_UP>() - 1) / tile_cols<GATE_UP>()) {}

  // Finds tile t's expert; false past the last tile.
  __device__ bool seek(int t) {
    for (; e < E; ++e) {
      r0 = __ldg(offsets + e);
      r1 = __ldg(offsets + e + 1);
      pairs = (r1 - r0 + kCluster * BM - 1) / (kCluster * BM);
      if (t < start + pairs * ncol) return true;
      start += pairs * ncol;
    }
    return false;
  }

  // Block `rank`'s part of tile t (after seek(t)).
  __device__ Tile at(int t, int rank) const {
    const int local = t - start, col = local / pairs;
    return {e, r0 + ((local - col * pairs) * kCluster + rank) * BM, r1,
            col * tile_cols<GATE_UP>()};
  }
};

// ---- the roles --------------------------------------------------------------

// The producer warpgroup: each tile's K stages into the ring. Thread 0
// issues the TMA boxes; in gate-up all 128 threads copy the A rows, thread
// p the 16-byte piece p % 8 of rows p / 8 + 16 i (i < 8), whose place in
// the swizzled tile is the same for all 8 of its rows.
template <bool GATE_UP>
__device__ __forceinline__ void produce(uint32_t ring, uint32_t full, uint32_t empty,
                                        const CUtensorMap* w0, const CUtensorMap* w1,
                                        const CUtensorMap* amap, const Params& p) {
  const int pt = threadIdx.x & 127;
  if (!GATE_UP && pt != 0) return;
  const int kblocks = (p.K + BK - 1) / BK, rank = cluster_rank();
  const int c = pt & 7, rg = pt >> 3;
  const uint32_t a_off = rg * 128 + ((c ^ (rg & 7)) << 4);
  // this block's box of the weight tile: gate-up gate (rank 0) or up (1),
  // down the first or the second 128 of its 256 rows
  const CUtensorMap* wmap = rank == 0 ? w0 : w1;
  const int n_off = GATE_UP ? 0 : rank * kBox;
  TileWalk<GATE_UP> walk(p);
  int s = 0, ph = 0;
  for (int t = blockIdx.x / kCluster; walk.seek(t); t += gridDim.x / kCluster) {
    const Tile tl = walk.at(t, rank);
    int tok[8];
    if (GATE_UP) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = tl.row0 + rg + 16 * i;
        tok[i] = row < tl.row_end ? (int)p.token[row] : -1;
      }
    }
    for (int kb = 0; kb < kblocks; ++kb) {
      const int k0 = kb * BK;
      const uint32_t st = ring + s * kStageBytes, bar = full + s * 8;
      mbar_wait(empty + s * 8, ph ^ 1);
      if (pt == 0) {
        mbar_expect_tx(bar, GATE_UP ? kBBytes : kStageBytes);
        if (!GATE_UP) tma_load_2d(st, amap, k0, tl.row0, bar);
        tma_load_3d_multicast(st + kABytes + rank * (kBBytes / 2), wmap, k0, tl.n0 + n_off, tl.e,
                              bar, (1 << kCluster) - 1);
      }
      if (GATE_UP) {
        const bool kok = k0 + c * 8 < p.K;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool ok = kok && tok[i] >= 0;
          cp_async16(st + a_off + i * 16 * 128,
                     p.x + (ok ? (long long)tok[i] * p.K + k0 + c * 8 : 0), ok);
        }
        cp_async_arrive_noinc(bar);
      }
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
  }
  // no block may leave while the other may still arrive on its barriers:
  // wait until both blocks' consumers have handed back every stage
  if (pt == 0)
    for (int i = 0; i < STAGES; ++i) {
      mbar_wait(empty + s * 8, ph ^ 1);
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
}

// One stage's products: 4 steps of k16 over the stage's 64 K columns, for
// this warpgroup's 64 rows against the 256 weight rows.
__device__ __forceinline__ void stage_products(float (&acc)[128], uint32_t st, int wg,
                                               bool first) {
  const uint32_t a = st + wg * 64 * 128, b = st + kABytes;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_m64n256k16(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32), !(first && kk == 0));
}

// The two output values of accumulator column pair j, row half h, in bf16.
template <bool GATE_UP>
__device__ __forceinline__ uint32_t out_pair(const float (&acc)[128], int j, int h) {
  if (GATE_UP)
    return pack_bf16(silu(acc[4 * j + 2 * h]) * acc[4 * (j + 16) + 2 * h],
                     silu(acc[4 * j + 2 * h + 1]) * acc[4 * (j + 16) + 2 * h + 1]);
  return pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// A consumer warpgroup: rows 64 wg .. 64 wg + 63 of each of the block's
// tiles. Register 4j + 2h + v of the accumulators is row 16 warp + g + 8h
// of those 64 (g = lane / 4), column 8j + 2t + v (t = lane % 4).
template <bool GATE_UP>
__device__ __forceinline__ void consume(int wg, uint32_t ring, uint32_t obuf, uint32_t full,
                                        uint32_t empty, const CUtensorMap* omap,
                                        __nv_bfloat16* __restrict__ out, const Params& p) {
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kblocks = (p.K + BK - 1) / BK, rank = cluster_rank();
  // a stage is free for the next copy once both blocks' warps hand it back
  auto release = [&](int st) {
    if (lane == 0)
#pragma unroll
      for (int b = 0; b < kCluster; ++b) mbar_arrive_cluster(empty + st * 8, b);
  };
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  TileWalk<GATE_UP> walk(p);
  int s = 0, ph = 0;
  for (int t = blockIdx.x / kCluster; walk.seek(t); t += gridDim.x / kCluster) {
    const Tile tl = walk.at(t, rank);
    // the first stage overwrites the accumulators
    mbar_wait(full + s * 8, ph);
    if (GATE_UP) fence_proxy_async();
    fence_acc(acc);
    wgmma_fence();
    stage_products(acc, ring + s * kStageBytes, wg, true);
    wgmma_commit();
    fence_acc(acc);
    int prev = s;
    if (++s == STAGES) { s = 0; ph ^= 1; }
    for (int kb = 1; kb < kblocks; ++kb) {
      mbar_wait(full + s * 8, ph);
      if (GATE_UP) fence_proxy_async();
      wgmma_fence();
      stage_products(acc, ring + s * kStageBytes, wg, false);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();  // the previous stage's products are done
      fence_acc(acc);
      release(prev);
      prev = s;
      if (++s == STAGES) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release(prev);

    const int wrow0 = tl.row0 + wg * 64;
    if (wrow0 + 64 <= tl.row_end) {
      // every row in the group: boxes of 64 columns through shared memory,
      // stored by TMA (an even count a tile, so box q takes buffer q % 2)
#pragma unroll
      for (int q = 0; q < tile_cols<GATE_UP>() / kOutCols; ++q) {
        const uint32_t buf = obuf + (q & 1) * kOutBytes;
        if (wt == 0) bulk_wait_read<1>();  // the store two boxes back has read it
        warpgroup_sync(1 + wg);
#pragma unroll
        for (int jj = 0; jj < kOutCols / 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // row r = 16 warp + g + 8h of the box; its 16-byte piece jj sits at jj ^ (r % 8)
            const int r = warp * 16 + g + 8 * h;
            st_shared(buf + r * 128 + ((jj ^ g) << 4) + 4 * t4,
                      out_pair<GATE_UP>(acc, q * (kOutCols / 8) + jj, h));
          }
        fence_proxy_async();
        warpgroup_sync(1 + wg);
        if (wt == 0) {
          tma_store_2d(omap, buf, tl.n0 + q * kOutCols, wrow0);
          bulk_commit();
        }
      }
    } else {
      // the group ends in these rows: only those below its end, from registers
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wrow0 + warp * 16 + g + 8 * h;
        __nv_bfloat16* o = out + (long long)row * p.N;
        const bool live = row < tl.row_end;
#pragma unroll
        for (int j = 0; j < tile_cols<GATE_UP>() / 8; ++j) {
          const int col = tl.n0 + 8 * j + 2 * t4;
          const uint32_t v = out_pair<GATE_UP>(acc, j, h);
          if (live && col < p.N) *reinterpret_cast<uint32_t*>(o + col) = v;
        }
      }
    }
  }
  if (wt == 0) bulk_wait<0>();  // every store done before the block leaves
}

template <bool GATE_UP>
__device__ __forceinline__ void grouped_gemm(const CUtensorMap* w0, const CUtensorMap* w1,
                                             const CUtensorMap* amap, const CUtensorMap* omap,
                                             __nv_bfloat16* out, const Params& p) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t obuf = ring + STAGES * kStageBytes;
  const uint32_t full = obuf + kConsumerWGs * 2 * kOutBytes, empty = full + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i * 8, GATE_UP ? 1 + 128 : 1);  // the TMA's arrival (+ 128 cp.async)
      mbar_init(empty + i * 8, kCluster * kConsumerWGs * 4);  // each consumer warp of both
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both blocks' barriers are set before either copies or arrives
  // one branch per role that never joins the other: ptxas then knows each
  // path's register count from its setmaxnreg
  const int wg = threadIdx.x >> 7;
  if (wg == kConsumerWGs) {
    setmaxnreg_dec<kProducerRegs>();
    produce<GATE_UP>(ring, full, empty, w0, w1, amap, p);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<GATE_UP>(wg, ring, obuf + wg * 2 * kOutBytes, full, empty, omap, out, p);
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    moe_gate_up_kernel(const __grid_constant__ CUtensorMap gate,
                       const __grid_constant__ CUtensorMap up,
                       const __grid_constant__ CUtensorMap hmap, __nv_bfloat16* h,
                       const Params p) {
  grouped_gemm<true>(&gate, &up, nullptr, &hmap, h, p);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    moe_down_kernel(const __grid_constant__ CUtensorMap down,
                    const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap ymap, __nv_bfloat16* y,
                    const Params p) {
  grouped_gemm<false>(&down, &down, &hmap, &ymap, y, p);
}

// x[t, :] += sum_s w[t, s] * y[pos[t, s], :] + shared[t, :], 8 columns a
// thread at a time.
__global__ void __launch_bounds__(256) moe_combine_kernel(float* __restrict__ x,
                                                          const __nv_bfloat16* __restrict__ y,
                                                          const __nv_bfloat16* __restrict__ shared,
                                                          const long long* __restrict__ pos,
                                                          const float* __restrict__ w, int D,
                                                          int k) {
  const long long t = blockIdx.x;
  for (int c = threadIdx.x * 8; c < D; c += blockDim.x * 8) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < k; ++s) {
      const long long r = pos[t * k + s];
      if (r < 0) continue;  // an expert this card does not hold
      const float ws = w[t * k + s];
      const uint4 v = *reinterpret_cast<const uint4*>(y + r * D + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        acc[2 * i] += ws * f.x;
        acc[2 * i + 1] += ws * f.y;
      }
    }
    const uint4 v = *reinterpret_cast<const uint4*>(shared + t * D + c);
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
    float4* xo = reinterpret_cast<float4*>(x + t * D + c);
    float4 a0 = xo[0], a1 = xo[1];
    float2 f0 = __bfloat1622float2(p[0]), f1 = __bfloat1622float2(p[1]);
    float2 f2 = __bfloat1622float2(p[2]), f3 = __bfloat1622float2(p[3]);
    a0.x += acc[0] + f0.x; a0.y += acc[1] + f0.y; a0.z += acc[2] + f1.x; a0.w += acc[3] + f1.y;
    a1.x += acc[4] + f2.x; a1.y += acc[5] + f2.y; a1.z += acc[6] + f3.x; a1.w += acc[7] + f3.y;
    xo[0] = a0;
    xo[1] = a1;
  }
}

// ---- host side --------------------------------------------------------------

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

// A bf16 tensor of `rank` dims (innermost first) in boxes of 64 columns
// with the 128-byte swizzle; out-of-range rows and columns read as zeros
// and are not written.
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

// An expert stack [E, N, K] in boxes of [128 weight rows, 64 K] of one expert.
bool encode_stack(CUtensorMap* map, const void* w, int E, int N, int K) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
  const cuuint32_t box[3] = {BK, kBox, 1};
  return encode(map, w, 3, dims, strides, box);
}

// How many clusters of `kern` the current device holds at once (one block
// an SM), read once a device.
template <bool GATE_UP>
int cluster_slots(const void* kern) {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (!counts[dev]) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess || n <= 0) {
      cudaGetLastError();  // fall back to one block an SM, in pairs
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      n /= kCluster;
    }
    counts[dev] = n;
  }
  return counts[dev];
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A [rows, cols] bf16 matrix in boxes of [box_rows, 64 columns].
bool encode_rows(CUtensorMap* map, const void* m, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {BK, (cuuint32_t)box_rows};
  return encode(map, m, 2, dims, strides, box);
}

// x the A rows (gate-up: the tokens, read through token; down: h [R, K]),
// w0 and w1 the [E, N, K] stacks (gate and up; down twice), out [R, N].
template <bool GATE_UP>
int launch_gemm(const void* x, const void* token, const void* w0, const void* w1,
                const void* offsets, void* out, int R, int K, int N, int E, cudaStream_t s) {
  if (R < 0 || K <= 0 || N <= 0 || E <= 0 || K % 8 || N % 8 || (GATE_UP && token == nullptr))
    return (int)cudaErrorInvalidValue;
  // TMA and cp.async take 16-byte aligned addresses with 16-byte aligned row strides
  if (!aligned16(x) || !aligned16(w0) || !aligned16(w1) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  if (R == 0) return 0;
  CUtensorMap m0, m1, om;
  if (!encode_stack(&m0, w0, E, N, K) || !encode_rows(&om, out, R, N, 64) ||
      !(GATE_UP ? encode_stack(&m1, w1, E, N, K) : encode_rows(&m1, x, R, K, BM)))
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const long long*>(token),
                 static_cast<const int*>(offsets), K, N, E};
  auto kern = GATE_UP ? moe_gate_up_kernel : moe_down_kernel;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  // the most cluster tiles any split of the rows can make; at most as many
  // clusters as the card holds at once
  const long long ncol = (N + tile_cols<GATE_UP>() - 1) / tile_cols<GATE_UP>();
  const long long tiles =
      ((long long)R + (long long)E * (kCluster * BM - 1)) / (kCluster * BM) * ncol;
  const int slots = cluster_slots<GATE_UP>(reinterpret_cast<const void*>(kern));
  if (slots <= 0) return (int)cudaErrorNoDevice;
  const int grid = kCluster * (int)(tiles < slots ? tiles : slots);
  kern<<<grid, kThreads, kSmem, s>>>(m0, m1, om, static_cast<__nv_bfloat16*>(out), p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [T, D] the tokens, token [R] int64 the token of each row sorted by
// expert, gate and up [E, I, D], offsets [E + 1] int32 (on the card;
// offsets[E] <= R), h [R, I]: only the rows of the E groups (up to
// offsets[E]) are read and written; D and I multiples of 8.
int moe_gate_up_bf16(const void* x, const void* token, const void* gate, const void* up,
                     const void* offsets, void* h, int R, int D, int I, int E, void* stream) {
  return launch_gemm<true>(x, token, gate, up, offsets, h, R, D, I, E,
                           static_cast<cudaStream_t>(stream));
}

// h [R, I], down [E, D, I], offsets as above, y [R, D]; I and D multiples of 8.
int moe_down_bf16(const void* h, const void* down, const void* offsets, void* y, int R, int I,
                  int D, int E, void* stream) {
  return launch_gemm<false>(h, nullptr, down, down, offsets, y, R, I, D, E,
                            static_cast<cudaStream_t>(stream));
}

// x [T, D] fp32 (added to in place), y [R, D] bf16, shared [T, D] bf16,
// pos [T, k] int64 (rows of y; -1 for an expert not held, left out), w
// [T, k] fp32; D a multiple of 8.
int moe_combine(void* x, const void* y, const void* shared, const void* pos, const void* w,
                int T, int D, int k, void* stream) {
  if (T < 0 || D <= 0 || D % 8 || k <= 0) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(y) || !aligned16(shared)) return (int)cudaErrorMisalignedAddress;
  if (T == 0) return 0;
  moe_combine_kernel<<<T, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(shared), static_cast<const long long*>(pos),
      static_cast<const float*>(w), D, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
