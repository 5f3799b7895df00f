// Backward of the fused MLM-head masked max-pool (csrc/maxpool_head.cu), for
// Hopper (sm_90a). The forward's training variant wrote idx[b, v], the
// position l that gave pooled[b, v]; given the upstream gradient g[b, v]
// (fp32), the gradient reaches only that position:
//
//   bwd_w:  dW[v, :]   = sum_b  g[b, v] * mask[b, idx[b, v]] * h[b, idx[b, v], :]
//           dbias[v]   = sum_b  g[b, v] * mask[b, idx[b, v]]
//   bwd_h:  dh[b, l, :] = mask[b, l] * sum_{v : idx[b, v] = l}  g[b, v] * W[v, :]
//
// h [B, L, D] bf16, W [V, D] bf16, mask [B, L] int32, g [B, V] fp32,
// idx [B, V] int32; dW [V, D], dbias [V], dh [B, L, D] fp32. All sums in fp32.
//
// In the JAX package this gradient is XLA's autodiff of the `lax.scan` head
// (opensearch_sparse_model_tuning_sample_tpu/models/bert.py:360-402,
// `mlm_maxpool`); the Pallas kernel it shadows (ops/pallas_maxpool.py, the
// `pallas_call` at :99) is forward only. The two agree where the maximum is
// unique. On a tie JAX splits the gradient evenly; the argmax gives it to
// one position. Ties at 0 where a masked position wins carry no gradient in
// either (mask = 0 there, and relu'(0) = 0 downstream).
//
// What bounds them: bytes. bwd_w reads g, idx (4 B each per (b, v)), mask
// and h, and writes dW and dbias in fp32: at [45, 64, 256, 30592] about
// 44 MB, ~13 us at 3.35 TB/s, against 2 * nnz(g * mask) * D fp32 FMA
// operations (~0.7 GFLOP, ~10 us at 67 TFLOP/s). bwd_h reads g, idx, mask and
// W, writes dh. Behind that sits the L2: each nonzero (b, v) reads one row of
// h (bwd_w) or of W (bwd_h), 512 B at D = 256; h (1.5 MB) and W (15.6 MB)
// stay in the 50 MB L2.
//
// Design: a gather-reduce with no atomics, so the result is deterministic.
//   * bwd_w: one warp per vocab row v. The lanes read 32 docs' (g, idx,
//     mask) at once; a ballot marks the nonzero coefficients (relu leaves
//     most of g at 0: 4 % nonzero on the smoke run's batch), and the warp
//     walks only those, in doc order: each coefficient broadcasts (shfl) and
//     every lane adds coef * h[b, l, :] for its 8-column groups (16-byte
//     loads) into fp32 registers, with up to 4 rows' loads in flight
//     (`accumulate_rows`). One store of the row at the end.
//   * bwd_h: one warp per (b, l). The caller hands each doc's vocab ids
//     ordered by argmax position (`order`, with the sorted positions `keys`;
//     the sort does no arithmetic of the gradient), so the v's of one (b, l)
//     are one run of `order[b, :]`, found by binary search in `keys[b, :]`.
//     The warp walks the run's nonzero g[b, v] in order (ballot) and adds
//     g[b, v] * W[v, :] the same way.
//     A masked position writes zeros without reading anything.
// Both launch on the caller's stream, allocate nothing and return
// cudaGetLastError(). D must be a multiple of 8 and at most 1536, h and W
// 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;             // warps per block
constexpr int kCols = 256;            // columns one warp covers per pass: 32 lanes x 8
constexpr int kMaxChunks = 6;         // D <= 6 * 256 = 1536
constexpr unsigned kFull = 0xffffffffu;

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

// For every lane j whose bit is set in `live`, lowest first: acc += c_j *
// base[off_j + lane's columns], where c_j = coef and off_j = off on lane j.
// Up to U rows' loads are in flight before their FMAs (a row is one 512-byte
// L2 read per 256 columns, and the FMAs wait on it); the sums still run in
// order, so the result is the same as one row at a time. Returns the sum of
// the coefficients, in the same order.
template <int NCH>
__device__ __forceinline__ float accumulate_rows(float (&acc)[NCH][8], unsigned live, float coef,
                                                 long long off,
                                                 const __nv_bfloat16* __restrict__ base, int D,
                                                 int lane) {
  constexpr int U = NCH <= 2 ? 4 : (NCH <= 4 ? 2 : 1);
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

__device__ __forceinline__ void store8(float* dst, const float (&acc)[8], float scale) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(acc[0] * scale, acc[1] * scale, acc[2] * scale, acc[3] * scale);
  d[1] = make_float4(acc[4] * scale, acc[5] * scale, acc[6] * scale, acc[7] * scale);
}

template <int NCH>
__global__ void __launch_bounds__(kWarps * 32)
bwd_w_kernel(const float* __restrict__ g, const int32_t* __restrict__ idx,
             const int32_t* __restrict__ mask, const __nv_bfloat16* __restrict__ h,
             float* __restrict__ dw, float* __restrict__ dbias, int B, int L, int D, int V) {
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (v >= V) return;
  float acc[NCH][8];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[k][i] = 0.f;
  float db = 0.f;

  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    float coef = 0.f;
    int l = 0;
    if (b < B) {
      const size_t o = (size_t)b * V + v;
      l = idx[o];
      coef = g[o] * (float)mask[(size_t)b * L + l];
    }
    // the docs with a nonzero coefficient, in doc order: row h[b, l]
    db += accumulate_rows<NCH>(acc, __ballot_sync(kFull, coef != 0.f), coef,
                               ((long long)b * L + l) * D, h, D, lane);
  }
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int col = k * kCols + lane * 8;
    if (col < D) store8(dw + (size_t)v * D + col, acc[k], 1.f);
  }
  if (lane == 0) dbias[v] = db;
}

template <int NCH>
__global__ void __launch_bounds__(kWarps * 32)
bwd_h_kernel(const float* __restrict__ g, const int32_t* __restrict__ keys,
             const int32_t* __restrict__ order, const int32_t* __restrict__ mask,
             const __nv_bfloat16* __restrict__ w, float* __restrict__ dh, int B, int L, int D,
             int V) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);  // (b, l)
  if (item >= B * L) return;
  const int b = item / L, l = item - b * L;
  float* out = dh + (size_t)item * D;
  const float m = (float)mask[item];
  float acc[NCH][8];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[k][i] = 0.f;

  if (m != 0.f) {
    // the run of v's whose argmax is l: [lower_bound(l), lower_bound(l + 1))
    const int32_t* kr = keys + (size_t)b * V;
    int lo = 0, hi = V;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (kr[mid] < l) lo = mid + 1; else hi = mid;
    }
    const int start = lo;
    hi = V;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (kr[mid] <= l) lo = mid + 1; else hi = mid;
    }
    const int end = lo;
    const int32_t* orow = order + (size_t)b * V;
    const float* grow = g + (size_t)b * V;
    for (int k0 = start; k0 < end; k0 += 32) {
      int v = 0;
      float coef = 0.f;
      if (k0 + lane < end) {
        v = orow[k0 + lane];
        coef = grow[v];
      }
      // the run's nonzero coefficients, in run order: row W[v]
      accumulate_rows<NCH>(acc, __ballot_sync(kFull, coef != 0.f), coef, (long long)v * D, w, D,
                           lane);
    }
  }
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int col = k * kCols + lane * 8;
    if (col < D) store8(out + col, acc[k], m);
  }
}

bool bad_args(const void* a, const void* b, int B, int L, int D, int V) {
  return B <= 0 || L <= 0 || V <= 0 || D <= 0 || D % 8 != 0 || D > kMaxChunks * kCols ||
         reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16;
}

}  // namespace

extern "C" {

int maxpool_head_bwd_max_dim() { return kMaxChunks * kCols; }

int maxpool_head_bwd_w(const void* g, const void* idx, const void* mask, const void* h, void* dw,
                       void* dbias, int B, int L, int D, int V, void* stream) {
  if (bad_args(h, dw, B, L, D, V)) return (int)cudaErrorInvalidValue;
  const dim3 grid((V + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* mk = static_cast<const int32_t*>(mask);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  auto* dwf = static_cast<float*>(dw);
  auto* dbf = static_cast<float*>(dbias);
  switch ((D + kCols - 1) / kCols) {
    case 1: bwd_w_kernel<1><<<grid, block, 0, s>>>(gf, ix, mk, hb, dwf, dbf, B, L, D, V); break;
    case 2: bwd_w_kernel<2><<<grid, block, 0, s>>>(gf, ix, mk, hb, dwf, dbf, B, L, D, V); break;
    case 3: bwd_w_kernel<3><<<grid, block, 0, s>>>(gf, ix, mk, hb, dwf, dbf, B, L, D, V); break;
    case 4: bwd_w_kernel<4><<<grid, block, 0, s>>>(gf, ix, mk, hb, dwf, dbf, B, L, D, V); break;
    case 5: bwd_w_kernel<5><<<grid, block, 0, s>>>(gf, ix, mk, hb, dwf, dbf, B, L, D, V); break;
    default: bwd_w_kernel<6><<<grid, block, 0, s>>>(gf, ix, mk, hb, dwf, dbf, B, L, D, V); break;
  }
  return (int)cudaGetLastError();
}

int maxpool_head_bwd_h(const void* g, const void* keys, const void* order, const void* mask,
                       const void* w, void* dh, int B, int L, int D, int V, void* stream) {
  if (bad_args(w, dh, B, L, D, V)) return (int)cudaErrorInvalidValue;
  const dim3 grid((B * L + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* gf = static_cast<const float*>(g);
  const auto* ky = static_cast<const int32_t*>(keys);
  const auto* od = static_cast<const int32_t*>(order);
  const auto* mk = static_cast<const int32_t*>(mask);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* dhf = static_cast<float*>(dh);
  switch ((D + kCols - 1) / kCols) {
    case 1: bwd_h_kernel<1><<<grid, block, 0, s>>>(gf, ky, od, mk, wb, dhf, B, L, D, V); break;
    case 2: bwd_h_kernel<2><<<grid, block, 0, s>>>(gf, ky, od, mk, wb, dhf, B, L, D, V); break;
    case 3: bwd_h_kernel<3><<<grid, block, 0, s>>>(gf, ky, od, mk, wb, dhf, B, L, D, V); break;
    case 4: bwd_h_kernel<4><<<grid, block, 0, s>>>(gf, ky, od, mk, wb, dhf, B, L, D, V); break;
    case 5: bwd_h_kernel<5><<<grid, block, 0, s>>>(gf, ky, od, mk, wb, dhf, B, L, D, V); break;
    default: bwd_h_kernel<6><<<grid, block, 0, s>>>(gf, ky, od, mk, wb, dhf, B, L, D, V); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
