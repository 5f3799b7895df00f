// Fused multi-head attention of one encoder layer, global, windowed or
// causal, for Hopper (sm_90a): the attention core of ModernBERT, of BERT's
// inference path and of Moonlight's MLA (`ops/attention.py`).
//
//     out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h] / sqrt(hqk) + M[b, i, j]) v[b, j, h]
//
// q, k [B, L, H, hqk], v [B, L, H, hv] bf16 (strided views with a contiguous
// head dim), mask [B, L] int32, out [B, L, H, hv] bf16 contiguous; hqk = hv
// (64 or 16) but in the causal kind, built at (192, 128), Moonlight's MLA,
// and (32, 16), its test width. M masks the keys whose mask is 0 and, in the
// windowed kind, the keys with |i - j| > window, in the causal kind the keys
// with j > i. A
// masked logit is -1e30, so a query whose visited keys are all masked takes
// their plain mean: finite, never NaN. Precision is `models/bert.py`'s: q.kT
// from bf16 operands accumulates in fp32, the softmax runs in fp32, the
// probabilities are rounded to bf16 before .v, which accumulates in fp32.
//
// It replaces no TPU kernel: the JAX package's BERT attention is plain `jnp`
// that XLA fuses, and it has no ModernBERT. It exists because the port's
// plain attention forms the fp32 [B, H, L, L] logits, 34 GB a layer at
// 8 x 8 192, and because a windowed layer computed densely would do L / 129
// times the work it needs.
//
// What bounds it, at ModernBERT-large's widths (hd 64, L up to 8 192): a
// global layer its operations, 4 L^2 hd a row and head (L / 2 operations a
// byte of q, k, v, o); a windowed layer its bytes (q, k, v read, o written
// once: 4 L hd 2 a row and head, against 4 (2 w + 1) L hd operations). A
// causal layer at Moonlight's dims and L <= 512 its bytes as well: a doc's
// n(n + 1) (hqk + hv) operations a head against its (2 hqk + 2 hv) n 2
// bytes cross near n = 1 180.
//
// Design (the FlashAttention-2 forward on mma.sync):
//   * One block of 4 warps per (tile of BM queries, doc, head); each warp
//     owns MT tiles of 16 query rows and keeps their context [16, hd],
//     running max and running sum in registers, so no [L, L] tensor exists
//     anywhere. A global layer takes MT 2 (BM 128): the two tiles share
//     every k and v operand a warp reads from shared memory, which halves
//     those reads per product (6 % faster than 8 warps of one tile each). A
//     windowed layer takes MT 1 (BM 64), so a tile of queries
//     visits 3 key tiles of 64 for a window of 129 keys.
//   * Key tiles of 64 rows of k and v stream through two shared-memory
//     buffers by cp.async (16 bytes a thread, rows past L zero-filled), the
//     next tile's copy in flight while the current one is computed; rows are
//     padded by 8 values so ldmatrix reads them without bank conflicts.
//   * q.kT and p.v are mma.sync m16n8k16 (bf16 in, fp32 accumulators), their
//     B operands by ldmatrix (.trans for v); the probabilities go from the
//     logits' accumulator registers to the A operand of p.v without shared
//     memory. The online softmax is in the log2 domain (ex2.approx). Every
//     tile takes the masks: skipping them on tiles whose keys are all live
//     made the global kernel 11 % slower (a second code path, registers
//     spilled).
//   * The global kind walks every key tile; the windowed one only the tiles
//     that meet [m0 - window, m0 + BM - 1 + window], so its work grows with
//     L (2 window + BM), not L^2; the causal one (4 warps of one 16-query
//     tile: at hqk 192 the q fragments and a context of 128 take 243
//     registers) the tiles up to its diagonal tile, its blocks taken from
//     the last query tile to the first so the longest start first, its
//     double-buffered k and v tiles (86 KB at (192, 128)) in dynamic shared
//     memory.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(). The trace names its three entry points
// `attention_global_kernel`, `attention_window_kernel` and
// `attention_causal_kernel`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 64;  // keys a tile
constexpr float kMasked = -1.0e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* mask;
  __nv_bfloat16* out;
  long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh, smb;
  int L, H, window;
  float scale_log2;  // log2(e) / sqrt(hd)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 values as bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, long long stride, int row,
                                              int col, int L) {
  if (row >= L) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * stride + col);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HQK, int HV, int WARPS, int MT>
struct Tile {
  static constexpr int BM = 16 * MT * WARPS;   // queries a block
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LDSK = HQK + 8;         // a shared row of k, padded (values)
  static constexpr int LDSV = HV + 8;          // and of v
  static constexpr int CHUNKSK = HQK / 8;      // 16-byte pieces of a row
  static constexpr int CHUNKSV = HV / 8;
  static constexpr int SMEM = 2 * kBlockN * (LDSK + LDSV) * 2 + 2 * kBlockN * 4;
};

// The three kinds of layer: every key, the keys within the window, or the
// keys at or before the query (causal).
enum Kind { kGlobal = 0, kWindow = 1, kCausal = 2 };

// MT: 16-row query tiles a warp owns. Two share each k and v operand that
// ldmatrix reads, which halves the shared-memory reads per product.
// HQK: the head dim of q and k; HV: that of v and the context. `smem`
// holds T::SMEM bytes. A causal block takes the query tiles from the last
// (the most keys) to the first, so the longest blocks start first.
template <int HQK, int HV, int WARPS, int MT, int KIND>
__device__ __forceinline__ void attention_body(const Params& p, unsigned char* smem) {
  using T = Tile<HQK, HV, WARPS, MT>;
  constexpr bool WINDOWED = KIND == kWindow, CAUSAL = KIND == kCausal;
  constexpr int KSTEPS = HQK / 16;      // k-steps of q.kT over the head dim
  constexpr int NTILES = kBlockN / 8;   // 8-key column tiles of the logits
  constexpr int DTILES = HV / 8;        // 8-wide column tiles of the context
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBlockN][LDSK]
  __nv_bfloat16* sV = sK + 2 * kBlockN * T::LDSK;              // [2][kBlockN][LDSV]
  int* sMask = reinterpret_cast<int*>(sV + 2 * kBlockN * T::LDSV);  // [2][kBlockN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int L = p.L;
  const int m0 = (CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * T::BM;
  const long long b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const __nv_bfloat16* Q = p.q + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* K = p.k + b * p.skb + h * p.skh;
  const __nv_bfloat16* V = p.v + b * p.svb + h * p.svh;
  const int* M = p.mask + b * p.smb;

  int lo = 0, hi = L;
  if (WINDOWED) {
    lo = max(m0 - p.window, 0) / kBlockN * kBlockN;
    hi = min(m0 + T::BM + p.window, L);
  }
  if (CAUSAL) hi = min(m0 + T::BM, L);
  const int n_tiles = (hi - lo + kBlockN - 1) / kBlockN;

  // starts the copies of key tile `tile` into buffer `buf`
  auto load_tile = [&](int tile, int buf) {
    const int n0 = lo + tile * kBlockN;
    if constexpr (HQK == HV) {
      for (int c = tid; c < kBlockN * T::CHUNKSK; c += T::THREADS) {
        const int r = c / T::CHUNKSK, col = (c % T::CHUNKSK) * 8;
        const bool ok = n0 + r < L;
        const long long key = ok ? n0 + r : 0;
        cp_async16(sK + (buf * kBlockN + r) * T::LDSK + col, K + key * p.skl + col, ok);
        cp_async16(sV + (buf * kBlockN + r) * T::LDSV + col, V + key * p.svl + col, ok);
      }
    } else {
      for (int c = tid; c < kBlockN * T::CHUNKSK; c += T::THREADS) {
        const int r = c / T::CHUNKSK, col = (c % T::CHUNKSK) * 8;
        const bool ok = n0 + r < L;
        const long long key = ok ? n0 + r : 0;
        cp_async16(sK + (buf * kBlockN + r) * T::LDSK + col, K + key * p.skl + col, ok);
      }
      for (int c = tid; c < kBlockN * T::CHUNKSV; c += T::THREADS) {
        const int r = c / T::CHUNKSV, col = (c % T::CHUNKSV) * 8;
        const bool ok = n0 + r < L;
        const long long key = ok ? n0 + r : 0;
        cp_async16(sV + (buf * kBlockN + r) * T::LDSV + col, V + key * p.svl + col, ok);
      }
    }
    for (int r = tid; r < kBlockN; r += T::THREADS)
      sMask[buf * kBlockN + r] = n0 + r < L ? M[n0 + r] : 0;
  };

  load_tile(0, 0);
  cp_async_commit();

  // this thread's query rows (r[mt], r[mt] + 8) and its first column within
  // an 8-wide tile
  const int cq = (lane % 4) * 2;
  int r_lo[MT];
  uint32_t qf[MT][KSTEPS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    r_lo[mt] = m0 + (warp * MT + mt) * 16 + lane / 4;
#pragma unroll
    for (int kd = 0; kd < KSTEPS; ++kd) {
      qf[mt][kd][0] = load_pair(Q, p.sql, r_lo[mt], 16 * kd + cq, L);
      qf[mt][kd][1] = load_pair(Q, p.sql, r_lo[mt] + 8, 16 * kd + cq, L);
      qf[mt][kd][2] = load_pair(Q, p.sql, r_lo[mt], 16 * kd + cq + 8, L);
      qf[mt][kd][3] = load_pair(Q, p.sql, r_lo[mt] + 8, 16 * kd + cq + 8, L);
    }
  }

  float o[MT][DTILES][4];
  float m_run[MT][2], l_run[MT][2];  // running max (log2 domain) and this thread's part of the sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < DTILES; ++d) o[mt][d][0] = o[mt][d][1] = o[mt][d][2] = o[mt][d][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -__int_as_float(0x7f800000);
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int buf = t & 1;
    const int n0 = lo + t * kBlockN;
    const __nv_bfloat16* ks = sK + buf * kBlockN * T::LDSK;
    const __nv_bfloat16* vs = sV + buf * kBlockN * T::LDSV;
    const int* mk = sMask + buf * kBlockN;

    // logits [16 MT, 64] of this warp's rows
    float s[MT][NTILES][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NTILES; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KSTEPS; ++kd) {
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        // matrices: keys 16np + 0..7 | 8..15 (x) head dims 16kd + 0..7 | 8..15
        const int mi = lane / 8;
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (16 * np + lane % 8 + (mi / 2) * 8) * T::LDSK + 16 * kd +
                            (mi % 2) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qf[mt][kd], bk[0], bk[1]);
          mma(s[mt][2 * np + 1], qf[mt][kd], bk[2], bk[3]);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // masks, scale to the log2 domain, row max over the quad
      float mx[2] = {kMasked, kMasked};
#pragma unroll
      for (int n = 0; n < NTILES; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + cq + (e & 1);
          bool ok = mk[col] != 0;
          if (WINDOWED) ok = ok && abs(r_lo[mt] + (e / 2) * 8 - (n0 + col)) <= p.window;
          if (CAUSAL) ok = ok && n0 + col <= r_lo[mt] + (e / 2) * 8;
          s[mt][n][e] = ok ? s[mt][n][e] * p.scale_log2 : kMasked;
          mx[e / 2] = fmaxf(mx[e / 2], s[mt][n][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mn = fmaxf(m_run[mt][i], quad_max(mx[i]));
        alpha[i] = exp2_approx(m_run[mt][i] - mn);
        m_run[mt][i] = mn;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NTILES; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = exp2_approx(s[mt][n][e] - m_run[mt][e / 2]);
          sum[e / 2] += s[mt][n][e];
        }
      }
      // each thread keeps its own part of the row sums; the quad adds them at the end
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[mt][i] = l_run[mt][i] * alpha[i] + sum[i];
#pragma unroll
      for (int d = 0; d < DTILES; ++d) {
        o[mt][d][0] *= alpha[0];
        o[mt][d][1] *= alpha[0];
        o[mt][d][2] *= alpha[1];
        o[mt][d][3] *= alpha[1];
      }
    }

    // context += p (bf16) . v
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < HV / 16; ++dp) {
        // matrices: keys 16kk + 0..7 | 8..15 (x) head dims 16dp + 0..7 | 8..15, transposed
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (16 * kk + lane % 8 + ((lane / 8) & 1) * 8) * T::LDSV +
                                  16 * dp + (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][2 * dp], a[mt], bv[0], bv[1]);
          mma(o[mt][2 * dp + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // the buffer is refilled at t + 1
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r_lo[mt] + 8 * i;
      const float inv = 1.f / quad_sum(l_run[mt][i]);
      if (row >= L) continue;
      __nv_bfloat16* out = p.out + ((b * L + row) * p.H + h) * HV;
#pragma unroll
      for (int d = 0; d < DTILES; ++d)
        *reinterpret_cast<uint32_t*>(out + 8 * d + cq) =
            pack_bf16(o[mt][d][2 * i] * inv, o[mt][d][2 * i + 1] * inv);
    }
  }
}

// a global layer: 4 warps of two 16-query tiles each (128 queries a block);
// a windowed one: 4 warps of one (64 queries, so a block visits 3 key
// tiles); a causal one: 4 warps of one (64 queries, so a block visits the
// key tiles up to its diagonal tile, and the registers hold a q.kT dim of
// 192 and a context of 128)
constexpr int kGlobalWarps = 4, kGlobalMT = 2;
constexpr int kWindowWarps = 4, kWindowMT = 1;
constexpr int kCausalWarps = 4, kCausalMT = 1;

template <int HD>
__global__ void __launch_bounds__(32 * kGlobalWarps, 2) attention_global_kernel(const Params p) {
  __shared__ __align__(16) unsigned char smem[Tile<HD, HD, kGlobalWarps, kGlobalMT>::SMEM];
  attention_body<HD, HD, kGlobalWarps, kGlobalMT, kGlobal>(p, smem);
}

template <int HD>
__global__ void __launch_bounds__(32 * kWindowWarps, 4) attention_window_kernel(const Params p) {
  __shared__ __align__(16) unsigned char smem[Tile<HD, HD, kWindowWarps, kWindowMT>::SMEM];
  attention_body<HD, HD, kWindowWarps, kWindowMT, kWindow>(p, smem);
}

// shared memory past the static 48 KB at HQK 192: dynamic
template <int HQK, int HV>
__global__ void __launch_bounds__(32 * kCausalWarps, 2) attention_causal_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  attention_body<HQK, HV, kCausalWarps, kCausalMT, kCausal>(p, smem_dyn);
}

template <int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  if (p.window > 0) {
    using T = Tile<HD, HD, kWindowWarps, kWindowMT>;
    const dim3 grid((p.L + T::BM - 1) / T::BM, B * p.H);
    attention_window_kernel<HD><<<grid, T::THREADS, 0, stream>>>(p);
  } else {
    using T = Tile<HD, HD, kGlobalWarps, kGlobalMT>;
    const dim3 grid((p.L + T::BM - 1) / T::BM, B * p.H);
    attention_global_kernel<HD><<<grid, T::THREADS, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int HQK, int HV>
int launch_causal(const Params& p, int B, cudaStream_t stream) {
  using T = Tile<HQK, HV, kCausalWarps, kCausalMT>;
  cudaError_t err = cudaFuncSetAttribute(attention_causal_kernel<HQK, HV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.L + T::BM - 1) / T::BM, B * p.H);
  attention_causal_kernel<HQK, HV><<<grid, T::THREADS, T::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// cp.async copies 16-byte pieces of k and v rows; q is read in pairs
int check(const void* q, const void* k, const void* v, const void* out, int B, int L, int H,
          int window, long long sqb, long long sql, long long sqh, long long skb, long long skl,
          long long skh, long long svb, long long svl, long long svh) {
  if (B <= 0 || L <= 0 || H <= 0 || window < 0 || B * (long long)H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long strides[] = {sqb, sql, sqh, skb, skl, skh, svb, svl, svh};
  for (long long s : strides)
    if (s % 8) return (int)cudaErrorMisalignedAddress;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

extern "C" {

// The query tile of each kind (the wrapper counts computed pairs from it).
int attention_block_m(int windowed) {
  return windowed ? Tile<64, 64, kWindowWarps, kWindowMT>::BM
                  : Tile<64, 64, kGlobalWarps, kGlobalMT>::BM;
}

int attention_causal_block_m() { return Tile<192, 128, kCausalWarps, kCausalMT>::BM; }

int attention_block_n() { return kBlockN; }

// q, k, v: [B, L, H, hd] bf16, hd 64 (ModernBERT's) or 16 (its test
// width), with the given strides (in values; the head dim contiguous); mask
// [B, L] int32 with row stride smb; out [B, L, H, hd] bf16 contiguous.
// window > 0: the windowed kind, |i - j| <= window.
int attention_bf16(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int L, int H, int hd, int window, float scale_log2,
                   long long sqb, long long sql, long long sqh, long long skb, long long skl,
                   long long skh, long long svb, long long svl, long long svh, long long smb,
                   void* stream) {
  const int rc = check(q, k, v, out, B, L, H, window, sqb, sql, sqh, skb, skl, skh, svb, svl, svh);
  if (rc) return rc;
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
           static_cast<__nv_bfloat16*>(out),
           sqb, sql, sqh, skb, skl, skh, svb, svl, svh, smb, L, H, window, scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The causal kind: key j reaches query i where j <= i and mask[j] != 0.
// q, k: [B, L, H, hqk], v: [B, L, H, hv] bf16 with the given strides;
// out [B, L, H, hv] bf16 contiguous. (hqk, hv) is (192, 128), Moonlight's
// MLA, or (32, 16), its test width.
int attention_causal_bf16(const void* q, const void* k, const void* v, const void* mask,
                          void* out, int B, int L, int H, int hqk, int hv, float scale_log2,
                          long long sqb, long long sql, long long sqh, long long skb,
                          long long skl, long long skh, long long svb, long long svl,
                          long long svh, long long smb, void* stream) {
  const int rc = check(q, k, v, out, B, L, H, 0, sqb, sql, sqh, skb, skl, skh, svb, svl, svh);
  if (rc) return rc;
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
           static_cast<__nv_bfloat16*>(out),
           sqb, sql, sqh, skb, skl, skh, svb, svl, svh, smb, L, H, 0, scale_log2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hqk == 192 && hv == 128) return launch_causal<192, 128>(p, B, s);
  if (hqk == 32 && hv == 16) return launch_causal<32, 16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
