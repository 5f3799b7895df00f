// Backward of the fused MLM-head masked max-pool (csrc/maxpool_head.cu), for
// Hopper (sm_90a). The forward's training variant wrote idx[b, v], the
// position l that gave pooled[b, v]; given the upstream gradient g[b, v]
// (fp32), the gradient reaches only that position. With
// coef[b, v] = g[b, v] * mask[b, idx[b, v]]:
//
//   bwd_w:  dW[v, :]    = sum_b  coef[b, v] * h[b, idx[b, v], :]
//           dbias[v]    = sum_b  coef[b, v]
//   bwd_h:  dh[b, l, :] = sum_{v : idx[b, v] = l}  coef[b, v] * W[v, :]
//
// h [B, L, D] bf16, W [V, D] bf16, mask [B, L] int32, g [B, V] fp32,
// idx [B, V] int32; dW [V, D] bf16, dbias [V] fp32, dh [B, L, D] bf16. All
// sums in fp32, rounded once to bf16 at the store. An idx outside [0, L)
// carries no gradient.
//
// In the JAX package this gradient is XLA's autodiff of the `lax.scan` head
// (opensearch_sparse_model_tuning_sample_tpu/models/bert.py:360-402,
// `mlm_maxpool`); the Pallas kernel it shadows (ops/pallas_maxpool.py, the
// `pallas_call` at :99) is forward only. The two agree where the maximum is
// unique. On a tie JAX splits the gradient evenly; the argmax gives it to
// one position. Ties at 0 where a masked position wins carry no gradient in
// either (mask = 0 there, and relu'(0) = 0 downstream).
//
// What bounds them: bytes. Both read g and idx (8 B per (b, v)) and mask;
// bwd_w reads h and writes dW in bf16 and dbias, bwd_h reads W and writes dh
// in bf16: at [45, 64, 256, 30592] about 28 MB each, ~8.4 us at 3.35 TB/s,
// against 2 * nnz * D fp32 FMA operations (nnz the (b, v) with coef != 0:
// 4 % of them on the train step's batch). Behind that sits the L2: each
// nonzero (b, v) reads one 512-byte row of h (bwd_w) or W (bwd_h); h
// (1.5 MB) and W (15.6 MB at D = 256) stay in the 50 MB L2. At D = 768, W is
// 47 MB and its rows come partly from HBM.
//
// Design: gather-reduces with no float atomics, so two launches are
// bit-equal.
//   * bwd_w, one launch: a block owns 8 consecutive vocab rows, a warp one,
//     and walks the docs 32 at a time. The block reads the [32 docs, 8 rows]
//     slab of g and idx (one 32-byte sector per doc and array) with the
//     mask[b, idx] gather into shared memory, one group ahead of the walk;
//     a warp's ballot over the slab's column compacts its row's nonzero
//     coefficients in doc order, and the warp sums coef * h[b, l, :] over
//     them with up to 8 rows' 16-byte loads in flight, into fp32 registers.
//     The sum runs in doc order. A row with no nonzero coefficient is
//     written as zeros without a load.
//   * bwd_h, four launches: a counting sort of the nonzero coefficients by
//     (doc, argmax position) into a CSR (offsets [B*L + 1], entries (v, coef)
//     in increasing v within each list), then a reduce over the lists.
//       count:   a block owns 4096 consecutive v of one doc, a warp 512 of
//                them; it counts the nonzero coefficients per position in
//                shared memory (integer atomics: a count has no order);
//       scan:    a block per doc turns the counts into each block's first
//                slot per list and the list offsets, and writes one
//                descriptor per chunk of 32 entries (list, first entry,
//                count, the list's chunks) for the reduce;
//       scatter: each warp's count again, its first slot per position, and
//                the entries written to slot = first + rank among the lanes
//                of that position below it (__match_any_sync): the order is
//                v's, whatever the scheduling;
//       reduce:  a warp per chunk descriptor (a grid-stride loop up to the
//                largest doc's chunk count, read on the card: no count
//                comes back to the host) sums
//                coef * W[v, :] over up to 32 entries with up to 8 rows in
//                flight. A one-chunk list writes its bf16 row; a longer
//                list's chunks write fp32 partials: the last to finish
//                (integer counters) of each group of 16 chunks adds the
//                group's partials in chunk order, the last group adds the
//                groups' sums in group order. An empty list (a masked
//                position among them) writes zeros without a load.
//     Positions are counted in windows of 1024, so any L fits.
// All launch on the caller's stream and return cudaGetLastError(); the
// caller allocates the outputs and the workspace
// (maxpool_head_bwd_workspace_bytes). D must be a multiple of 8 and at most
// 1536, h and W 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 256;            // columns one warp covers per pass: 32 lanes x 8
constexpr int kMaxChunks = 6;         // D <= 6 * 256 = 1536
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnit = 512;            // v's of one doc that one bucketing warp owns
constexpr int kBlockUnit = kWarps * kUnit;
constexpr int kLWin = 1024;           // positions one bucketing block counts
constexpr int kChunk = 32;            // list entries one reduce warp sums
constexpr int kGroup = 16;            // chunks whose partials one reduce warp adds

// row loads in flight per warp: 16-byte loads per lane, U * NCH of them
template <int NCH>
__host__ __device__ constexpr int rows_in_flight() {
  return NCH == 1 ? 8 : NCH == 2 ? 4 : NCH <= 4 ? 2 : 1;
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// acc[8] += c * the 8 bf16 values of raw
__device__ __forceinline__ void fma8(float (&acc)[8], float c, const uint4& raw) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    acc[2 * i] = fmaf(c, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(c, f.y, acc[2 * i + 1]);
  }
}

__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst, const float (&a)[8]) {
  uint4 out;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = out;
}

template <int NCH>
__device__ __forceinline__ void zero(float (&acc)[NCH][8]) {
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[k][i] = 0.f;
}

template <int NCH>
__device__ __forceinline__ void store_row_bf16(__nv_bfloat16* row, const float (&acc)[NCH][8], int D,
                                               int lane) {
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int col = k * kCols + lane * 8;
    if (col < D) store8_bf16(row + col, acc[k]);
  }
}

// For every lane j whose bit is set in `live`, lowest first: acc += c_j *
// base[off_j + lane's columns], where c_j = coef and off_j = off on lane j.
// U rows' loads are in flight before their FMAs; the sums still run in
// order, so the result is the same as one row at a time. Returns the sum of
// the coefficients, in the same order.
template <int NCH>
__device__ __forceinline__ float accumulate_rows(float (&acc)[NCH][8], unsigned live, float coef,
                                                 long long off,
                                                 const __nv_bfloat16* __restrict__ base, int D,
                                                 int lane) {
  constexpr int U = rows_in_flight<NCH>();
  float csum = 0.f;
  while (live) {  // `live` is the same on every lane
    float c[U];
    uint4 raw[U][NCH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c[u] = 0.f;
      if (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        c[u] = __shfl_sync(kFull, coef, j);
        const long long o = __shfl_sync(kFull, off, j);
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const int col = k * kCols + lane * 8;
          if (col < D) raw[u][k] = __ldg(reinterpret_cast<const uint4*>(base + o + col));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c[u] == 0.f) continue;  // an unused slot of the last group
      csum += c[u];
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        if (k * kCols + lane * 8 < D) fma8(acc[k], c[u], raw[u][k]);
    }
  }
  return csum;
}

// ---- bwd_w -----------------------------------------------------------------

// A block owns kWarps consecutive vocab rows, a warp one. Thread t loads
// slab entry (doc t / kWarps of the group, row t % kWarps): a doc's 8 rows
// are one 32-byte sector of g and of idx. The next group's g and idx are
// loaded while the warps walk this one.
template <int NCH>
__global__ void __launch_bounds__(kThreads)
bwd_w_kernel(const float* __restrict__ g, const int32_t* __restrict__ idx,
             const int32_t* __restrict__ mask, const __nv_bfloat16* __restrict__ h,
             __nv_bfloat16* __restrict__ dw, float* __restrict__ dbias, int B, int L, int D,
             int V) {
  __shared__ float s_coef[32][kWarps + 1];  // [doc of the group][row of the block]
  __shared__ int s_row[32][kWarps + 1];     // b * L + l: the row of h
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sr = tid / kWarps, sc = tid % kWarps, sv = blockIdx.x * kWarps + sc;
  float acc[NCH][8];
  zero<NCH>(acc);
  float db = 0.f;

  float gn = 0.f;  // g and idx of this thread's slab entry in the next group
  int ln = 0;
  auto load = [&](int b0) {
    const int b = b0 + sr;
    gn = 0.f;
    ln = 0;
    if (b < B && sv < V) {
      const size_t o = (size_t)b * V + sv;
      gn = __ldg(g + o);
      ln = __ldg(idx + o);
    }
  };
  load(0);
  for (int b0 = 0; b0 < B; b0 += 32) {
    const bool ok = gn != 0.f && (unsigned)ln < (unsigned)L;
    s_coef[sr][sc] = ok ? gn * (float)__ldg(mask + (size_t)(b0 + sr) * L + ln) : 0.f;
    s_row[sr][sc] = (b0 + sr) * L + ln;
    __syncthreads();
    if (b0 + 32 < B) load(b0 + 32);
    // this row's nonzero coefficients of the group, in doc order: row h[b, l]
    const float cf = s_coef[lane][warp];
    db += accumulate_rows<NCH>(acc, __ballot_sync(kFull, cf != 0.f), cf,
                               (long long)s_row[lane][warp] * D, h, D, lane);
    __syncthreads();  // the next group overwrites the slab
  }
  const int v = blockIdx.x * kWarps + warp;
  if (v < V) {
    store_row_bf16<NCH>(dw + (size_t)v * D, acc, D, lane);
    if (lane == 0) dbias[v] = db;
  }
}

// ---- bwd_h: the counting sort ----------------------------------------------

struct BucketArgs {
  const float* g;
  const int32_t* idx;
  const int32_t* mask;
  int B, L, V;
};

// One warp's pass over v in [vb, ve) of doc b. Counts the nonzero
// coefficients with a position in [l0, l1) into hist[l - l0] (shared-memory
// integer atomics); with kScatter, hist holds each position's next slot
// instead, and each entry goes to entries[slot + its rank among the lanes
// of its position] (__match_any_sync), the lowest lane advancing the slot.
// Returns the number of nonzero coefficients (any position).
template <bool kScatter>
__device__ __forceinline__ int walk_unit(const BucketArgs& a, int b, int vb, int ve, int l0,
                                         int l1, int* hist, int2* __restrict__ entries,
                                         int lane) {
  const float* grow = a.g + (size_t)b * a.V;
  const int32_t* irow = a.idx + (size_t)b * a.V;
  const int32_t* mrow = a.mask + (size_t)b * a.L;
  constexpr int S = kUnit / 32;  // every load of the unit in flight at once
  int total = 0;
  for (int v0 = vb; v0 < ve; v0 += S * 32) {
    float gv[S];
    int lv[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int v = v0 + k * 32 + lane;
      gv[k] = 0.f;
      lv[k] = 0;
      if (v < ve) {
        gv[k] = __ldg(grow + v);
        lv[k] = __ldg(irow + v);
      }
    }
    float cf[S];
#pragma unroll
    for (int k = 0; k < S; ++k)
      cf[k] = gv[k] != 0.f && (unsigned)lv[k] < (unsigned)a.L ? gv[k] * (float)__ldg(mrow + lv[k])
                                                               : 0.f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      total += __popc(__ballot_sync(kFull, cf[k] != 0.f));
      const bool live = cf[k] != 0.f && lv[k] >= l0 && lv[k] < l1;
      if (!kScatter) {  // a count does not depend on order
        if (live) atomicAdd(hist + lv[k] - l0, 1);
        continue;
      }
      const unsigned act = __ballot_sync(kFull, live);
      if (act == 0) continue;
      unsigned peers = 0;
      int rank = 0;
      if (live) {
        peers = __match_any_sync(act, lv[k]);
        rank = __popc(peers & lanes_below(lane));
        entries[hist[lv[k] - l0] + rank] = make_int2(v0 + k * 32 + lane, __float_as_int(cf[k]));
      }
      __syncwarp();
      if (live && rank == 0) hist[lv[k] - l0] += __popc(peers);
      __syncwarp();
    }
  }
  return total;
}

// grid (blocks of kBlockUnit v, B, position windows); dynamic shared memory
// one int per position of the window
__global__ void __launch_bounds__(kThreads)
bucket_count_kernel(BucketArgs a, int* __restrict__ cnt, int* __restrict__ blk_nnz,
                    int* __restrict__ max_chunks, int nblk) {
  extern __shared__ int s_hist[];  // the block's count per position
  __shared__ int s_nnz[kWarps];
  if (blockIdx.x + blockIdx.y + blockIdx.z + threadIdx.x == 0) *max_chunks = 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  const int l0 = blockIdx.z * kLWin, l1 = min(a.L, l0 + kLWin), lw = l1 - l0;
  for (int i = threadIdx.x; i < lw; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  const int vb = blockIdx.x * kBlockUnit + warp * kUnit, ve = min(a.V, vb + kUnit);
  const int nnz = walk_unit<false>(a, b, vb, ve, l0, l1, s_hist, nullptr, lane);
  if (lane == 0) s_nnz[warp] = nnz;
  __syncthreads();
  int* out = cnt + ((size_t)b * nblk + blockIdx.x) * a.L + l0;
  for (int i = threadIdx.x; i < lw; i += kThreads) out[i] = s_hist[i];
  if (blockIdx.z == 0 && threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_nnz[w];
    blk_nnz[(size_t)b * nblk + blockIdx.x] = sum;
  }
}

__device__ __forceinline__ int2 add2(int2 a, int2 b) { return make_int2(a.x + b.x, a.y + b.y); }

// exclusive scan of x over the block's threads in order; *total = the sum
__device__ __forceinline__ int2 block_exclusive_scan(int2 x, int2* total, int2* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int yx = __shfl_up_sync(kFull, inc.x, o), yy = __shfl_up_sync(kFull, inc.y, o);
    if (lane >= o) inc = add2(inc, make_int2(yx, yy));
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int2 pre = make_int2(0, 0), tot = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int2 s = s_warp[w];
    if (w < warp) pre = add2(pre, s);
    tot = add2(tot, s);
  }
  __syncthreads();  // s_warp is rewritten by the next call
  *total = tot;
  return make_int2(pre.x + inc.x - x.x, pre.y + inc.y - x.y);
}

// A chunk of the reduce's work: up to kChunk entries of one list.
//   x: l, y: its first entry, z: the list's first chunk within the doc,
//   w: entries in the chunk | the list's chunks << 6
// a block per doc: cnt[b][blk][l] becomes the count of the blocks before
// blk; offsets[b*L + l] the list's first entry (the docs before b counted
// from blk_nnz). For the reduce (chunks not null): chunks[b][0, doc's
// chunks) the chunk descriptors, doc_chunks[b] their number, *max_chunks
// the most of any doc, and the doc's counters counter[b*L + l] and
// gcounter[b][0, cpd) = 0.
__global__ void __launch_bounds__(kThreads)
bucket_scan_kernel(const int* __restrict__ blk_nnz, int* __restrict__ cnt,
                   int* __restrict__ offsets, int4* __restrict__ chunks,
                   int* __restrict__ doc_chunks, int* __restrict__ counter,
                   int* __restrict__ gcounter, int* __restrict__ max_chunks, int B, int L,
                   int nblk, int cpd) {
  __shared__ int2 s_warp[kWarps];
  const int b = blockIdx.x, tid = threadIdx.x;
  if (chunks)
    for (int i = tid; i < cpd; i += kThreads) gcounter[(size_t)b * cpd + i] = 0;
  int base = 0;
  for (int i = tid; i < b * nblk; i += kThreads) base += blk_nnz[i];
  int2 all;
  block_exclusive_scan(make_int2(base, 0), &all, s_warp);
  base = all.x;

  int2 carry = make_int2(0, 0);  // entries and chunks of the positions before the tile
  for (int t0 = 0; t0 < L; t0 += kThreads) {
    const int l = t0 + tid;
    int tot = 0;
    if (l < L) {
      int* c = cnt + (size_t)b * nblk * L + l;
      for (int k0 = 0; k0 < nblk; k0 += 8) {
        int x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = k0 + j < nblk ? c[(size_t)(k0 + j) * L] : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k0 + j < nblk) {
            c[(size_t)(k0 + j) * L] = tot;
            tot += x[j];
          }
      }
    }
    const int nch = l < L ? max(1, (tot + kChunk - 1) / kChunk) : 0;
    int2 tile;
    const int2 ex = block_exclusive_scan(make_int2(tot, nch), &tile, s_warp);
    if (l < L) {
      const int e0 = base + carry.x + ex.x, c0 = carry.y + ex.y;
      offsets[(size_t)b * L + l] = e0;
      if (chunks) {
        counter[(size_t)b * L + l] = 0;
        for (int p = 0; p < nch; ++p)
          chunks[(size_t)b * cpd + c0 + p] =
              make_int4(l, e0 + p * kChunk, c0, min(kChunk, tot - p * kChunk) | nch << 6);
      }
    }
    carry = add2(carry, tile);
  }
  if (tid == 0) {
    if (chunks) {
      doc_chunks[b] = carry.y;
      atomicMax(max_chunks, carry.y);
    }
    if (b == B - 1) offsets[(size_t)B * L] = base + carry.x;
  }
}

__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(BucketArgs a, const int* __restrict__ cnt, const int* __restrict__ offsets,
                      int2* __restrict__ entries, int nblk) {
  extern __shared__ int s_hist[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
  const int l0 = blockIdx.z * kLWin, l1 = min(a.L, l0 + kLWin), lw = l1 - l0;
  int* hist = s_hist + warp * lw;
  for (int i = lane; i < lw; i += 32) hist[i] = 0;
  __syncwarp();
  const int vb = blockIdx.x * kBlockUnit + warp * kUnit, ve = min(a.V, vb + kUnit);
  walk_unit<false>(a, b, vb, ve, l0, l1, hist, nullptr, lane);
  __syncthreads();
  // each warp's first slot per position: the list's first entry, the
  // blocks before this one, the warps before this one
  const int* c = cnt + ((size_t)b * nblk + blockIdx.x) * a.L + l0;
  const int* off = offsets + (size_t)b * a.L + l0;
  for (int i = threadIdx.x; i < lw; i += kThreads) {
    int run = off[i] + c[i];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = s_hist[w * lw + i];
      s_hist[w * lw + i] = run;
      run += t;
    }
  }
  __syncthreads();
  walk_unit<true>(a, b, vb, ve, l0, l1, hist, entries, lane);
}

// ---- bwd_h: the reduce -----------------------------------------------------

// acc = the sum of n partial rows p[i * stride * D + lane's columns], i in order
template <int NCH>
__device__ __forceinline__ void add_partials(float (&acc)[NCH][8], const float* p, int n,
                                             int stride, int D, int lane) {
  zero<NCH>(acc);
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int col = k * kCols + lane * 8;
      if (col >= D) continue;
      const float4* s = reinterpret_cast<const float4*>(p + (size_t)i * stride * D + col);
      const float4 x = __ldcg(s), y = __ldcg(s + 1);
      acc[k][0] += x.x; acc[k][1] += x.y; acc[k][2] += x.z; acc[k][3] += x.w;
      acc[k][4] += y.x; acc[k][5] += y.y; acc[k][6] += y.z; acc[k][7] += y.w;
    }
  }
}

template <int NCH>
__device__ __forceinline__ void store_row_f32(float* row, const float (&acc)[NCH][8], int D,
                                              int lane) {
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int col = k * kCols + lane * 8;
    if (col < D) {
      float4* d = reinterpret_cast<float4*>(row + col);
      d[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      d[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    }
  }
}

// after this warp wrote its row: true on the warp that arrives last of
// `n` at *counter, which then sees every row the others wrote
__device__ __forceinline__ bool arrive_last(int* counter, int n, int lane) {
  __threadfence();
  __syncwarp();
  int done = 0;
  if (lane == 0) done = atomicAdd(counter, 1);
  if (__shfl_sync(kFull, done, 0) != n - 1) return false;
  __threadfence();
  return true;
}

template <int NCH>
__global__ void __launch_bounds__(kThreads)
bwd_h_reduce_kernel(const int4* __restrict__ chunks, const int* __restrict__ doc_chunks,
                    const int* __restrict__ max_chunks, const int2* __restrict__ entries, const __nv_bfloat16* __restrict__ w,
                    float* __restrict__ partials, int* __restrict__ counter,
                    int* __restrict__ gcounter, __nv_bfloat16* __restrict__ dh, int B, int L,
                    int D, int cpd) {
  const int lane = threadIdx.x & 31;
  const long long items = (long long)B * __ldg(max_chunks);  // chunk j of doc b: it = j*B + b
  const long long step = (long long)gridDim.x * kWarps;
  for (long long it = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); it < items;
       it += step) {
    const int b = (int)(it % B), j = (int)(it / B);  // chunk j of doc b
    if (j >= __ldg(doc_chunks + b)) continue;
    const int4 c = __ldg(chunks + (size_t)b * cpd + j);
    const size_t list = (size_t)b * L + c.x;
    const int e0 = c.y, first = c.z, cnt = c.w & 63, parts = c.w >> 6;

    float acc[NCH][8];
    zero<NCH>(acc);
    int v = 0;
    float cf = 0.f;
    if (lane < cnt) {
      const int2 e = __ldg(entries + e0 + lane);
      v = e.x;
      cf = __int_as_float(e.y);
    }
    accumulate_rows<NCH>(acc, __ballot_sync(kFull, lane < cnt), cf, (long long)v * D, w, D, lane);
    __nv_bfloat16* out = dh + list * D;
    if (parts == 1) {
      store_row_bf16<NCH>(out, acc, D, lane);
      continue;
    }
    // a list of several chunks: fp32 partials, added in a fixed order. The
    // last chunk to finish of each group of kGroup adds the group's
    // partials in chunk order into the group's first slot; the last group
    // to finish adds the groups' sums in group order.
    const size_t slot0 = (size_t)b * cpd + first;
    store_row_f32<NCH>(partials + (slot0 + (j - first)) * D, acc, D, lane);
    const int gfirst = (j - first) / kGroup * kGroup, gsize = min(kGroup, parts - gfirst);
    if (!arrive_last(gcounter + slot0 + gfirst, gsize, lane)) continue;
    add_partials<NCH>(acc, partials + (slot0 + gfirst) * D, gsize, 1, D, lane);
    const int groups = (parts + kGroup - 1) / kGroup;
    if (groups > 1) {
      store_row_f32<NCH>(partials + (slot0 + gfirst) * D, acc, D, lane);
      if (!arrive_last(counter + list, groups, lane)) continue;
      add_partials<NCH>(acc, partials + slot0 * D, groups, kGroup, D, lane);
    }
    store_row_bf16<NCH>(out, acc, D, lane);
  }
}

// ---- host side ---------------------------------------------------------------

struct Work {
  int* cnt = nullptr;         // [B, nblk, L]
  int* blk_nnz = nullptr;     // [B, nblk]
  int* max_chunks = nullptr;  // [1]
  int* offsets = nullptr;     // [B * L + 1]
  int2* entries = nullptr;    // [B * V]
  int4* chunks = nullptr;     // [B, cpd]: the reduce's alone from here
  int* doc_chunks = nullptr;  // [B]
  int* counter = nullptr;     // [B * L]
  int* gcounter = nullptr;    // [B * cpd]
  float* partials = nullptr;  // [B * cpd, D]
};

int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }
int chunks_per_doc(int L, int V) { return L + ceil_div(V, kChunk); }

bool bad_sizes(int B, int L, int V) {
  return B <= 0 || L <= 0 || V <= 0 || B > 65535 || ceil_div(L, kLWin) > 65535 ||
         (long long)B * V >= (1ll << 31) || (long long)B * L >= (1ll << 31) - 1 ||
         (long long)B * chunks_per_doc(L, V) >= (1ll << 31);
}

bool bad_args(const void* a, const void* b, int B, int L, int D, int V) {
  return bad_sizes(B, L, V) || D <= 0 || D % 8 != 0 || D > kMaxChunks * kCols ||
         reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16;
}

// The workspace's bytes, and its pieces when base is not null. D == 0: the
// bucketing alone, whose caller holds offsets and entries.
size_t carve(char* base, Work* wk, int B, int L, int D, int V) {
  const size_t nblk = ceil_div(V, kBlockUnit);
  size_t at = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + at : nullptr;
    at += (bytes + 255) & ~size_t(255);
    return p;
  };
  const size_t cpd = chunks_per_doc(L, V);
  wk->cnt = static_cast<int*>(take((size_t)B * nblk * L * 4));
  wk->blk_nnz = static_cast<int*>(take((size_t)B * nblk * 4));
  wk->max_chunks = static_cast<int*>(take(4));
  if (D > 0) {
    wk->offsets = static_cast<int*>(take(((size_t)B * L + 1) * 4));
    wk->entries = static_cast<int2*>(take((size_t)B * V * 8));
    wk->chunks = static_cast<int4*>(take((size_t)B * cpd * 16));
    wk->doc_chunks = static_cast<int*>(take((size_t)B * 4));
    wk->counter = static_cast<int*>(take((size_t)B * L * 4));
    wk->gcounter = static_cast<int*>(take((size_t)B * cpd * 4));
    wk->partials = static_cast<float*>(take((size_t)B * cpd * D * 4));
  }
  return at;
}

int launch_buckets(const void* g, const void* idx, const void* mask, const Work& wk, int B, int L,
                   int V, cudaStream_t s) {
  const int nblk = ceil_div(V, kBlockUnit), lw = L < kLWin ? L : kLWin;
  const dim3 grid(nblk, B, ceil_div(L, kLWin));
  const size_t smem = (size_t)lw * sizeof(int);  // count: the block's; scatter: each warp's
  const BucketArgs a{static_cast<const float*>(g), static_cast<const int32_t*>(idx),
                     static_cast<const int32_t*>(mask), B, L, V};
  bucket_count_kernel<<<grid, kThreads, smem, s>>>(a, wk.cnt, wk.blk_nnz, wk.max_chunks, nblk);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bucket_scan_kernel<<<B, kThreads, 0, s>>>(wk.blk_nnz, wk.cnt, wk.offsets, wk.chunks,
                                            wk.doc_chunks, wk.counter, wk.gcounter,
                                            wk.max_chunks, B, L, nblk, chunks_per_doc(L, V));
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  bucket_scatter_kernel<<<grid, kThreads, kWarps * smem, s>>>(a, wk.cnt, wk.offsets, wk.entries, nblk);
  return (int)cudaGetLastError();
}

template <int NCH>
int launch_w(const void* g, const void* idx, const void* mask, const void* h, void* dw,
             void* dbias, int B, int L, int D, int V, cudaStream_t s) {
  bwd_w_kernel<NCH><<<ceil_div(V, kWarps), kThreads, 0, s>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(mask), static_cast<const __nv_bfloat16*>(h),
      static_cast<__nv_bfloat16*>(dw), static_cast<float*>(dbias), B, L, D, V);
  return (int)cudaGetLastError();
}

template <int NCH>
int launch_reduce(const Work& wk, const void* w, void* dh, int B, int L, int D, int V,
                  cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int cpd = chunks_per_doc(L, V);
  const long long want = ((long long)B * cpd + kWarps - 1) / kWarps;
  const int grid = (int)(want < (long long)sms * 8 ? want : (long long)sms * 8);
  bwd_h_reduce_kernel<NCH><<<grid, kThreads, 0, s>>>(
      wk.chunks, wk.doc_chunks, wk.max_chunks, wk.entries, static_cast<const __nv_bfloat16*>(w), wk.partials,
      wk.counter, wk.gcounter, static_cast<__nv_bfloat16*>(dh), B, L, D, cpd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int maxpool_head_bwd_max_dim() { return kMaxChunks * kCols; }

long long maxpool_head_bwd_workspace_bytes(int B, int L, int D, int V) {
  if (bad_sizes(B, L, V) || D < 0) return -1;
  Work wk;
  return (long long)carve(nullptr, &wk, B, L, D, V);
}

int maxpool_head_bwd_w(const void* g, const void* idx, const void* mask, const void* h, void* dw,
                       void* dbias, int B, int L, int D, int V, void* stream) {
  if (bad_args(h, dw, B, L, D, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + kCols - 1) / kCols) {
    case 1: return launch_w<1>(g, idx, mask, h, dw, dbias, B, L, D, V, s);
    case 2: return launch_w<2>(g, idx, mask, h, dw, dbias, B, L, D, V, s);
    case 3: return launch_w<3>(g, idx, mask, h, dw, dbias, B, L, D, V, s);
    case 4: return launch_w<4>(g, idx, mask, h, dw, dbias, B, L, D, V, s);
    case 5: return launch_w<5>(g, idx, mask, h, dw, dbias, B, L, D, V, s);
    default: return launch_w<6>(g, idx, mask, h, dw, dbias, B, L, D, V, s);
  }
}

// the counting sort alone: offsets [B*L + 1] int32, entries [B*V] of (int32
// v, fp32 coef) of which the first offsets[B*L] are the lists; work of
// maxpool_head_bwd_workspace_bytes(B, L, 0, V) bytes
int maxpool_head_bwd_buckets(const void* g, const void* idx, const void* mask, void* offsets,
                             void* entries, void* work, int B, int L, int V, void* stream) {
  if (bad_sizes(B, L, V)) return (int)cudaErrorInvalidValue;
  Work wk;
  carve(static_cast<char*>(work), &wk, B, L, 0, V);
  wk.offsets = static_cast<int*>(offsets);
  wk.entries = static_cast<int2*>(entries);
  return launch_buckets(g, idx, mask, wk, B, L, V, static_cast<cudaStream_t>(stream));
}

// the counting sort, then the reduce; work of
// maxpool_head_bwd_workspace_bytes(B, L, D, V) bytes
int maxpool_head_bwd_h(const void* g, const void* idx, const void* mask, const void* w, void* dh,
                       void* work, int B, int L, int D, int V, void* stream) {
  if (bad_args(w, dh, B, L, D, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Work wk;
  carve(static_cast<char*>(work), &wk, B, L, D, V);
  if (int rc = launch_buckets(g, idx, mask, wk, B, L, V, s)) return rc;
  switch ((D + kCols - 1) / kCols) {
    case 1: return launch_reduce<1>(wk, w, dh, B, L, D, V, s);
    case 2: return launch_reduce<2>(wk, w, dh, B, L, D, V, s);
    case 3: return launch_reduce<3>(wk, w, dh, B, L, D, V, s);
    case 4: return launch_reduce<4>(wk, w, dh, B, L, D, V, s);
    case 5: return launch_reduce<5>(wk, w, dh, B, L, D, V, s);
    default: return launch_reduce<6>(wk, w, dh, B, L, D, V, s);
  }
}

}  // extern "C"
