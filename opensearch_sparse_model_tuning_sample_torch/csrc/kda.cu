// Kimi Delta Attention (KDA), the chunked forward, for Hopper (sm_90a): the
// linear-attention mixer of `models/kimi_linear.py` (`ops/kda.py`).
//
// Per (doc, head), with a state S (dk x dv, fp32) that starts at zero:
//
//   S_t = (I - beta_t k_t k_t^T) Diag(alpha_t) S_{t-1} + beta_t k_t v_t^T,   o_t = S_t^T q_t
//
// alpha_t = exp(g_t) per key channel (g <= 0), beta_t a scalar, q already
// scaled. Chunks of C = 64 positions; inside a chunk, with G_i the running
// sum of g over the chunk's positions up to i (a vector over dk) and S_0
// the state entering the chunk:
//
//   A_ij = sum_c k_ic k_jc exp(G_ic - G_jc)   (i > j),  T = (I + Diag(beta) A)^-1
//   P_ij = sum_c q_ic k_jc exp(G_ic - G_jc)   (i >= j)
//   Wk = T Diag(beta) (exp(G) * k),  U = T Diag(beta) v        (the WY/UT form)
//   W = U - Wk S_0,  O = (exp(G) * q) S_0 + P W
//   S_C = Diag(exp(G_C)) S_0 + (exp(G_C - G) * k)^T W
//
// Every exponent is a difference G_i - G_j with i >= j, or G_i itself, so
// each is <= 0: nothing overflows, whatever the decay (exp(-G) alone would,
// in fp32, at strong decay).
//
// Two kernels for the recurrence:
//   * `kda_intra_kernel`, one block a (chunk, head, doc), all in parallel:
//     G by a running sum per channel; A and P by blocks of 16 positions: a
//     diagonal block pair by pair (one exp of G_i - G_j a pair and channel,
//     shared by both), an off-diagonal block (i after j's block) through the
//     last position r before i's block, exp(G_i - G_j) = exp(G_i - G_r)
//     exp(G_r - G_j) with both factors <= 1, as one mma.sync product of
//     bf16 rows; T Diag(beta) [exp(G) k | v] by forward substitution (a
//     thread a column, the column in registers); then the chunk's Wk, Q~ =
//     exp(G) q, K^ = (exp(G_C - G) k)^T and P in bf16, U and exp(G_C) in
//     fp32, to scratch.
//   * `kda_state_kernel`, one block a (dv slice, head, doc), a sequential
//     pass over the chunks: the state slice is the fp32 accumulator of
//     mma.sync m16n8k16 (bf16 operands: a bf16 copy of S^T in shared memory),
//     the chunk's operands double-buffered through cp.async. At 32 heads dv
//     is cut in two slices of 64, so two docs fill 128 of the 132 SMs.
// And three one-pass elementwise kernels around them, a warp a (position,
// head) row: `kda_conv_kernel` (the short causal convolution, SiLU and, for
// q and k, the row's L2 norm), `kda_gate_kernel` (g = -exp(A_log)
// softplus(f + dt_bias)) and `kda_gated_norm_kernel` (RMSNorm(o) w
// sigmoid(gate), to bf16).
// Products accumulate in fp32; G, A, T, U and S are fp32. Positions past L
// read as zeros (g 0, beta 0), so a chunk that ends past the doc changes
// nothing. Each launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(). It replaces no TPU kernel: the JAX package has
// no linear attention.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64, THREADS = 256;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// acc[2][4] += A[16 rows, K] . Bt[16 rows (n), K]^T: A row-major at a (ld
// values), Bt row-major at bt (ld values), both in shared memory, K % 16 == 0
template <int K>
__device__ __forceinline__ void mma_block(float (&acc)[2][4], const __nv_bfloat16* a, int lda,
                                          const __nv_bfloat16* bt, int ldb) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4], bf[4];
    ldmatrix_x4(af, a + (lane % 16) * lda + k0 + (lane / 16) * 8);
    ldmatrix_x4(bf, bt + (lane % 8 + (mi / 2) * 8) * ldb + k0 + (mi % 2) * 8);
    mma(acc[0], af, bf[0], bf[1]);
    mma(acc[1], af, bf[2], bf[3]);
  }
}

struct Strides {  // of q, k, v, g in elements: [B, L, H, d] as (b, t, h)
  long long b, t, h;
};

struct IntraArgs {
  const __nv_bfloat16 *q, *k, *v;
  const float* g;     // [B, L, H, DK]
  const float* beta;  // [B, L, H]
  Strides sq, sk, sv, sg, sb;
  __nv_bfloat16* wk;   // [B, H, N, C, DK]
  float* u;            // [B, H, N, C, DV]
  __nv_bfloat16* qg;   // [B, H, N, C, DK]
  __nv_bfloat16* kgt;  // [B, H, N, DK, C]
  __nv_bfloat16* p;    // [B, H, N, C, C]
  float* gend;         // [B, H, N, DK]
  int L, H, N;
  float scale;
};

// ------------------------------------------------------------- intra chunk

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS) kda_intra_kernel(const IntraArgs a) {
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DK + DV <= THREADS && DK <= THREADS, "dims");
  constexpr int LDK = DK + 4;  // fp32 rows padded: float4 loads of 8 rows hit 8 bank groups
  constexpr int LDC = C + 4;
  extern __shared__ __align__(16) float sm[];
  float* G = sm;             // [C][LDK] running sums of g
  float* K = G + C * LDK;    // [C][LDK]
  float* Q = K + C * LDK;    // [C][LDK] (scaled)
  float* A = Q + C * LDK;    // [C][LDC] beta_i A_ij, i > j; 0 elsewhere
  float* P = A + C * LDC;    // [C][LDC]
  float* bt = P + C * LDC;   // [C]
  constexpr int LDB = DK + 8;  // bf16 rows, padded: ldmatrix conflict-free
  __nv_bfloat16* KE = reinterpret_cast<__nv_bfloat16*>(bt + C);  // [C][LDB]
  __nv_bfloat16* QE = KE + C * LDB;                               // [C][LDB]
  __nv_bfloat16* F = QE + C * LDB;                                // [96][LDB]

  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = n * C;
  const long long blk = ((long long)b * a.H + h) * a.N + n;

  for (int idx = tid; idx < C * DK; idx += THREADS) {
    const int i = idx / DK, c = idx % DK, t = t0 + i;
    float kv = 0.f, qv = 0.f, gv = 0.f;
    if (t < a.L) {
      kv = __bfloat162float(a.k[b * a.sk.b + t * a.sk.t + h * a.sk.h + c]);
      qv = __bfloat162float(a.q[b * a.sq.b + t * a.sq.t + h * a.sq.h + c]) * a.scale;
      gv = a.g[b * a.sg.b + t * a.sg.t + h * a.sg.h + c];
    }
    K[i * LDK + c] = kv;
    Q[i * LDK + c] = qv;
    G[i * LDK + c] = gv;
  }
  if (tid < C) {
    const int t = t0 + tid;
    bt[tid] = t < a.L ? a.beta[b * a.sb.b + t * a.sb.t + h * a.sb.h] : 0.f;
  }
  __syncthreads();
  if (tid < DK) {
    float s = 0.f;
    for (int i = 0; i < C; ++i) {
      s += G[i * LDK + tid];
      G[i * LDK + tid] = s;
    }
  }
  __syncthreads();

  // A and P by blocks of 16 x 16 positions. A diagonal block (i, j in one
  // block) pair by pair, one exp a pair and channel: exp(G_i - G_j). An
  // off-diagonal block (i in block a, j in block b < a) through the last
  // position r = 16a - 1 before block a, j <= r < i: exp(G_i - G_j) =
  // exp(G_i - G_r) exp(G_r - G_j), both factors <= 1, so the block is a
  // product of (k_i or q_i) exp(G_i - G_r) and k_j exp(G_r - G_j) on mma.sync
  // (bf16 operands, fp32 sums).
  {
    const int il = tid / 16, jl = tid % 16;
    for (int blkd = 0; blkd < C / 16; ++blkd) {
      const int i = blkd * 16 + il, j = blkd * 16 + jl;
      float sa = 0.f, sp = 0.f;
      if (j <= i) {
        const float4* gi = reinterpret_cast<const float4*>(G + i * LDK);
        const float4* gj = reinterpret_cast<const float4*>(G + j * LDK);
        const float4* ki = reinterpret_cast<const float4*>(K + i * LDK);
        const float4* kj = reinterpret_cast<const float4*>(K + j * LDK);
        const float4* qi = reinterpret_cast<const float4*>(Q + i * LDK);
#pragma unroll 4
        for (int c4 = 0; c4 < DK / 4; ++c4) {
          const float4 x = gi[c4], y = gj[c4], u = ki[c4], w = kj[c4], z = qi[c4];
          float e;
          e = __expf(x.x - y.x) * w.x; sa += u.x * e; sp += z.x * e;
          e = __expf(x.y - y.y) * w.y; sa += u.y * e; sp += z.y * e;
          e = __expf(x.z - y.z) * w.z; sa += u.z * e; sp += z.z * e;
          e = __expf(x.w - y.w) * w.w; sa += u.w * e; sp += z.w * e;
        }
      }
      A[i * LDC + j] = j < i ? bt[i] * sa : 0.f;
      P[i * LDC + j] = sp;
    }
    // the blocks above the diagonal are 0
    for (int idx = tid; idx < C * C; idx += THREADS) {
      const int i = idx / C, j = idx % C;
      if (j / 16 > i / 16) A[i * LDC + j] = P[i * LDC + j] = 0.f;
    }
    // KE, QE: rows 16.. of k and q times exp(G_i - G_r); F: for a = 1, 2, 3
    // the rows j < 16a of k times exp(G_r - G_j), r = 16a - 1
    for (int idx = tid; idx < (C - 16) * DK; idx += THREADS) {
      const int i = 16 + idx / DK, c = idx % DK, r = (i / 16) * 16 - 1;
      const float e = __expf(G[i * LDK + c] - G[r * LDK + c]);
      KE[i * LDB + c] = __float2bfloat16(K[i * LDK + c] * e);
      QE[i * LDB + c] = __float2bfloat16(Q[i * LDK + c] * e);
    }
    for (int idx = tid; idx < 96 * DK; idx += THREADS) {
      const int row = idx / DK, c = idx % DK;
      const int a = row < 16 ? 1 : row < 48 ? 2 : 3, j = row - (a - 1) * a * 8;
      const int r = 16 * a - 1;
      F[row * LDB + c] = __float2bfloat16(K[j * LDK + c] * __expf(G[r * LDK + c] - G[j * LDK + c]));
    }
  }
  __syncthreads();
  {
    // 6 off-diagonal blocks x (A, P): a warp a task or two
    const int lane = tid % 32, warp = tid / 32, g = lane / 4, t4 = lane % 4;
    for (int task = warp; task < 12; task += THREADS / 32) {
      const int pair = task / 2, which = task % 2;  // which: 0 A, 1 P
      const int a = pair < 1 ? 1 : pair < 3 ? 2 : 3, b = pair - (a - 1) * a / 2;
      float acc[2][4] = {};
      const __nv_bfloat16* lhs = (which ? QE : KE) + (16 * a) * LDB;
      const __nv_bfloat16* rhs = F + ((a - 1) * a * 8 + 16 * b) * LDB;
      mma_block<DK>(acc, lhs, LDB, rhs, LDB);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 16 * a + g + (c >= 2 ? 8 : 0), j = 16 * b + jj * 8 + 2 * t4 + (c & 1);
          if (which)
            P[i * LDC + j] = acc[jj][c];
          else
            A[i * LDC + j] = bt[i] * acc[jj][c];
        }
    }
  }
  __syncthreads();

  // X = (I + A)^-1 Diag(beta) [exp(G) k | v]: a thread a column, rows in order
  if (tid < DK + DV) {
    const bool key = tid < DK;
    const int col = key ? tid : tid - DK;
    float x[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float y = 0.f;
      const int t = t0 + i;
      if (key)
        y = __expf(G[i * LDK + col]) * K[i * LDK + col];
      else if (t < a.L)
        y = __bfloat162float(a.v[b * a.sv.b + t * a.sv.t + h * a.sv.h + col]);
      y *= bt[i];
#pragma unroll
      for (int j = 0; j < i; ++j) y -= A[i * LDC + j] * x[j];
      x[i] = y;
    }
    if (key) {
      __nv_bfloat16* o = a.wk + blk * C * DK + col;
#pragma unroll
      for (int i = 0; i < C; ++i) o[i * DK] = __float2bfloat16(x[i]);
    } else {
      float* o = a.u + blk * C * DV + col;
#pragma unroll
      for (int i = 0; i < C; ++i) o[i * DV] = x[i];
    }
  }

  // the chunk's other operands
  const float* glast = G + (C - 1) * LDK;
  for (int idx = tid; idx < C * DK; idx += THREADS) {
    const int i = idx / DK, c = idx % DK;
    a.qg[blk * C * DK + idx] = __float2bfloat16(Q[i * LDK + c] * __expf(G[i * LDK + c]));
  }
  for (int idx = tid; idx < C * DK; idx += THREADS) {  // K^ transposed: [DK][C]
    const int c = idx / C, i = idx % C;
    a.kgt[blk * C * DK + idx] =
        __float2bfloat16(K[i * LDK + c] * __expf(glast[c] - G[i * LDK + c]));
  }
  for (int idx = tid; idx < C * C; idx += THREADS)
    a.p[blk * C * C + idx] = __float2bfloat16(P[(idx / C) * LDC + idx % C]);
  if (tid < DK) a.gend[blk * DK + tid] = __expf(glast[tid]);
}

// ------------------------------------------------------------ state pass

struct StateArgs {
  const __nv_bfloat16 *wk, *qg, *kgt, *p;
  const float *u, *gend;
  float* o;  // [B, L, H, DV]
  int L, H, N;
};

template <int DK, int DVS>
struct StateSmem {
  static constexpr int LDA = DK + 8;  // bf16 rows of DK, padded: ldmatrix conflict-free
  static constexpr int LDJ = C + 8;   // bf16 rows of C
  // one stage: Wk [C][LDA], Q~ [C][LDA], K^ [DK][LDJ], P [C][LDJ] (bf16); U [C][DVS], e^G_C [DK]
  static constexpr int WK = 0, QG = WK + C * LDA * 2, KG = QG + C * LDA * 2,
                       PP = KG + DK * LDJ * 2, UU = PP + C * LDJ * 2, GE = UU + C * DVS * 4,
                       STAGE = GE + DK * 4;
  // S^T [DVS][LDA] and W^T [DVS][LDJ] (bf16) after both stages
  static constexpr int ST = 2 * STAGE, WT = ST + DVS * LDA * 2, BYTES = WT + DVS * LDJ * 2;
  static_assert(STAGE % 16 == 0 && WK % 16 == 0 && QG % 16 == 0 && KG % 16 == 0 &&
                    PP % 16 == 0 && UU % 16 == 0 && GE % 16 == 0 && ST % 16 == 0 &&
                    WT % 16 == 0,
                "16-byte aligned regions");
};

template <int DK, int DVS>
__global__ void __launch_bounds__(THREADS) kda_state_kernel(const StateArgs a) {
  using S = StateSmem<DK, DVS>;
  constexpr int LDA = S::LDA, LDJ = S::LDJ;
  constexpr int WB = (C / 16) * (DVS / 16);   // 16 x 16 blocks of W and O
  constexpr int SB = (DK / 16) * (DVS / 16);  // of the state slice
  constexpr int WPW = (WB + 7) / 8, SPW = (SB + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int DV = gridDim.x * DVS, c0 = slice * DVS;
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem + S::ST);
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem + S::WT);

  auto load = [&](int n, int stage) {
    unsigned char* base = smem + stage * S::STAGE;
    const long long blk = ((long long)b * a.H + h) * a.N + n;
    constexpr int RA = DK / 8, RJ = C / 8, RU = DVS / 4;  // 16-byte pieces a row
    for (int c = tid; c < C * RA; c += THREADS) {
      const int r = c / RA, x = (c % RA) * 8;
      cp_async16(base + S::WK + (r * LDA + x) * 2, a.wk + blk * C * DK + r * DK + x);
      cp_async16(base + S::QG + (r * LDA + x) * 2, a.qg + blk * C * DK + r * DK + x);
    }
    for (int c = tid; c < DK * RJ; c += THREADS) {
      const int r = c / RJ, x = (c % RJ) * 8;
      cp_async16(base + S::KG + (r * LDJ + x) * 2, a.kgt + blk * C * DK + r * C + x);
    }
    for (int c = tid; c < C * RJ; c += THREADS) {
      const int r = c / RJ, x = (c % RJ) * 8;
      cp_async16(base + S::PP + (r * LDJ + x) * 2, a.p + blk * C * C + r * C + x);
    }
    for (int c = tid; c < C * RU; c += THREADS) {
      const int r = c / RU, x = (c % RU) * 4;
      cp_async16(base + S::UU + (r * DVS + x) * 4, a.u + blk * C * DV + r * DV + c0 + x);
    }
    for (int c = tid; c < DK / 4; c += THREADS)
      cp_async16(base + S::GE + c * 16, a.gend + blk * DK + c * 4);
  };

  float sacc[SPW][2][4];
#pragma unroll
  for (int s = 0; s < SPW; ++s)
#pragma unroll
    for (int j = 0; j < 2; ++j) sacc[s][j][0] = sacc[s][j][1] = sacc[s][j][2] = sacc[s][j][3] = 0.f;
  for (int i = tid; i < DVS * LDA; i += THREADS) st[i] = __float2bfloat16(0.f);

  load(0, 0);
  cp_async_commit();
  if (a.N > 1) load(1, 1);
  cp_async_commit();

  for (int n = 0; n < a.N; ++n) {
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* base = smem + (n % 2) * S::STAGE;
    const __nv_bfloat16* WK = reinterpret_cast<const __nv_bfloat16*>(base + S::WK);
    const __nv_bfloat16* QG = reinterpret_cast<const __nv_bfloat16*>(base + S::QG);
    const __nv_bfloat16* KG = reinterpret_cast<const __nv_bfloat16*>(base + S::KG);
    const __nv_bfloat16* PP = reinterpret_cast<const __nv_bfloat16*>(base + S::PP);
    const float* UU = reinterpret_cast<const float*>(base + S::UU);
    const float* GE = reinterpret_cast<const float*>(base + S::GE);

    // W = U - Wk S_0, kept as W^T in bf16
#pragma unroll
    for (int s = 0; s < WPW; ++s) {
      const int blkw = warp + 8 * s;
      if (blkw >= WB) break;
      const int r0 = (blkw / (DVS / 16)) * 16, n0 = (blkw % (DVS / 16)) * 16;
      float acc[2][4] = {};
      mma_block<DK>(acc, WK + r0 * LDA, LDA, st + n0 * LDA, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + g + (c >= 2 ? 8 : 0), col = n0 + j * 8 + 2 * t4 + (c & 1);
          wt[col * LDJ + row] = __float2bfloat16(UU[row * DVS + col] - acc[j][c]);
        }
    }
    __syncthreads();

    // O = Q~ S_0 + P W
    const int t0 = n * C;
#pragma unroll
    for (int s = 0; s < WPW; ++s) {
      const int blkw = warp + 8 * s;
      if (blkw >= WB) break;
      const int r0 = (blkw / (DVS / 16)) * 16, n0 = (blkw % (DVS / 16)) * 16;
      float acc[2][4] = {};
      mma_block<DK>(acc, QG + r0 * LDA, LDA, st + n0 * LDA, LDA);
      mma_block<C>(acc, PP + r0 * LDJ, LDJ, wt + n0 * LDJ, LDJ);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int t = t0 + r0 + g + hh * 8;
          if (t >= a.L) continue;
          const int col = c0 + n0 + j * 8 + 2 * t4;
          float2* out = reinterpret_cast<float2*>(
              a.o + (((long long)b * a.L + t) * a.H + h) * DV + col);
          *out = make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
        }
    }

    // S = Diag(e^G_C) S_0 + K^ W, in the fp32 accumulators
#pragma unroll
    for (int s = 0; s < SPW; ++s) {
      const int blks = warp + 8 * s;
      if (blks >= SB) break;
      const int r0 = (blks / (DVS / 16)) * 16, n0 = (blks % (DVS / 16)) * 16;
      const float e0 = GE[r0 + g], e1 = GE[r0 + g + 8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sacc[s][j][0] *= e0;
        sacc[s][j][1] *= e0;
        sacc[s][j][2] *= e1;
        sacc[s][j][3] *= e1;
      }
      mma_block<C>(sacc[s], KG + r0 * LDJ, LDJ, wt + n0 * LDJ, LDJ);
    }
    __syncthreads();  // every read of this stage, of S^T and of W^T is done

#pragma unroll
    for (int s = 0; s < SPW; ++s) {
      const int blks = warp + 8 * s;
      if (blks >= SB) break;
      const int r0 = (blks / (DVS / 16)) * 16, n0 = (blks % (DVS / 16)) * 16;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = r0 + g + (c >= 2 ? 8 : 0), col = n0 + j * 8 + 2 * t4 + (c & 1);
          st[col * LDA + row] = __float2bfloat16(sacc[s][j][c]);
        }
    }
    if (n + 2 < a.N) load(n + 2, n % 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------- elementwise passes
// One warp a (doc, position, head) row of d <= 128 channels, 4 a lane.

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// y = SiLU(causal depthwise conv of x, width K, zeros before position 0),
// and with NORM each head's row divided by sqrt(sum y^2 + 1e-6). x [B, L,
// H * d] bf16 with strides (sxb, sxt), w [H * d, K] fp32, y [B, L, H * d]
// bf16 contiguous.
template <bool NORM>
__global__ void __launch_bounds__(256) kda_conv_kernel(const __nv_bfloat16* __restrict__ x,
                                                       long long sxb, long long sxt,
                                                       const float* __restrict__ w,
                                                       __nv_bfloat16* __restrict__ y, int B, int L,
                                                       int H, int d, int K) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= (long long)B * L * H) return;
  const int lane = threadIdx.x % 32, h = (int)(row % H);
  const int t = (int)((row / H) % L), b = (int)(row / ((long long)H * L));
  const int c0 = lane * 4, ch = h * d + c0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (c0 < d) {
    for (int s = 0; s < K; ++s) {
      const int tt = t - (K - 1) + s;
      if (tt < 0) continue;
      float xv[4];
      load4(x + b * sxb + tt * sxt + ch, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += w[(ch + i) * K + s] * xv[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = acc[i] / (1.f + __expf(-acc[i]));
  }
  if (NORM) {
    const float inv = rsqrtf(warp_sum(acc[0] * acc[0] + acc[1] * acc[1] + acc[2] * acc[2] +
                                      acc[3] * acc[3]) + 1e-6f);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= inv;
  }
  if (c0 < d) store4(y + ((long long)b * L + t) * H * d + ch, acc);
}

// g = -exp(A_log[h]) softplus(f + dt_bias) (softplus(x) = x above 20, as
// torch's), f and g [n / (H d), H * d] fp32 contiguous.
__global__ void __launch_bounds__(256) kda_gate_kernel(const float* __restrict__ f,
                                                       const float* __restrict__ a_log,
                                                       const float* __restrict__ dt_bias,
                                                       float* __restrict__ g, long long n, int H,
                                                       int d) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % ((long long)H * d));
    const float x = f[i] + dt_bias[c];
    const float sp = x > 20.f ? x : log1pf(expf(x));
    g[i] = -expf(a_log[c / d]) * sp;
  }
}

// out = o / sqrt(mean(o^2) + eps) * w * sigmoid(gate) per (row, head), o
// [rows, d] fp32, gate [rows, d] fp32, w [d], out bf16, all contiguous.
__global__ void __launch_bounds__(256) kda_gated_norm_kernel(const float* __restrict__ o,
                                                             const float* __restrict__ wn,
                                                             const float* __restrict__ gate,
                                                             __nv_bfloat16* __restrict__ out,
                                                             long long rows, int d, float eps) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int c0 = (threadIdx.x % 32) * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f}, gv[4] = {0.f, 0.f, 0.f, 0.f};
  if (c0 < d) {
    const float4 a = *reinterpret_cast<const float4*>(o + row * d + c0);
    const float4 z = *reinterpret_cast<const float4*>(gate + row * d + c0);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    gv[0] = z.x, gv[1] = z.y, gv[2] = z.z, gv[3] = z.w;
  }
  const float inv =
      rsqrtf(warp_sum(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]) / d + eps);
  if (c0 >= d) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = v[i] * inv * wn[c0 + i] / (1.f + __expf(-gv[i]));
  store4(out + row * d + c0, v);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int DK, int DV>
int launch_intra(const IntraArgs& a, int B, cudaStream_t s) {
  constexpr int bytes = (3 * C * (DK + 4) + 2 * C * (C + 4) + C) * 4 + (2 * C + 96) * (DK + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(kda_intra_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kda_intra_kernel<DK, DV><<<dim3(a.N, a.H, B), THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int DK, int DVS>
int launch_state(const StateArgs& a, int B, int DV, cudaStream_t s) {
  constexpr int bytes = StateSmem<DK, DVS>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kda_state_kernel<DK, DVS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kda_state_kernel<DK, DVS><<<dim3(DV / DVS, a.H, B), THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k [B, L, H, DK] and v [B, L, H, DV] bf16, g [B, L, H, DK] and beta
// [B, L, H] fp32, each with a unit last stride and the strides given (in
// elements, (b, t, h) each); the scratch wk, qg, kgt [B, H, N, C * DK] bf16,
// p [B, H, N, C * C] bf16, u [B, H, N, C * DV] and gend [B, H, N, DK] fp32,
// N = ceil(L / 64). (DK, DV) is (128, 128) or (16, 16).
int kda_intra_bf16(const void* q, const void* k, const void* v, const void* g, const void* beta,
                   const long long* strides, void* wk, void* u, void* qg, void* kgt, void* p,
                   void* gend, int B, int L, int H, int DK, int DV, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const int N = (L + C - 1) / C;
  const Strides* sd = reinterpret_cast<const Strides*>(strides);
  IntraArgs a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(g),
              static_cast<const float*>(beta), sd[0], sd[1], sd[2], sd[3], sd[4],
              static_cast<__nv_bfloat16*>(wk), static_cast<float*>(u),
              static_cast<__nv_bfloat16*>(qg), static_cast<__nv_bfloat16*>(kgt),
              static_cast<__nv_bfloat16*>(p), static_cast<float*>(gend), L, H, N, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (DK == 128 && DV == 128) return launch_intra<128, 128>(a, B, s);
  if (DK == 16 && DV == 16) return launch_intra<16, 16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// the scratch of kda_intra_bf16 -> o [B, L, H, DV] fp32 (contiguous)
int kda_state_bf16(const void* wk, const void* u, const void* qg, const void* kgt, const void* p,
                   const void* gend, void* o, int B, int L, int H, int DK, int DV,
                   void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (!aligned16(wk) || !aligned16(u) || !aligned16(qg) || !aligned16(kgt) || !aligned16(p) ||
      !aligned16(gend) || !aligned16(o))
    return (int)cudaErrorMisalignedAddress;
  const int N = (L + C - 1) / C;
  StateArgs a{static_cast<const __nv_bfloat16*>(wk), static_cast<const __nv_bfloat16*>(qg),
              static_cast<const __nv_bfloat16*>(kgt), static_cast<const __nv_bfloat16*>(p),
              static_cast<const float*>(u), static_cast<const float*>(gend),
              static_cast<float*>(o), L, H, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (DK == 128 && DV == 128) return launch_state<128, 64>(a, B, DV, s);
  if (DK == 16 && DV == 16) return launch_state<16, 16>(a, B, DV, s);
  return (int)cudaErrorInvalidValue;
}

// x [B, L, H * d] bf16 (unit last stride, row strides sxb, sxt, even), w
// [H * d, K] fp32, y [B, L, H * d] bf16; d % 4 == 0, d <= 128.
int kda_conv_bf16(const void* x, long long sxb, long long sxt, const void* w, void* y, int B,
                  int L, int H, int d, int K, int norm, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || d <= 0 || d > 128 || d % 4 || K <= 0 || sxb % 4 || sxt % 4)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * L * H;
  const dim3 grid((unsigned)((rows + 7) / 8));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto yp = static_cast<__nv_bfloat16*>(y);
  if (norm)
    kda_conv_kernel<true><<<grid, 256, 0, s>>>(xp, sxb, sxt, static_cast<const float*>(w), yp, B,
                                                L, H, d, K);
  else
    kda_conv_kernel<false><<<grid, 256, 0, s>>>(xp, sxb, sxt, static_cast<const float*>(w), yp,
                                                 B, L, H, d, K);
  return (int)cudaGetLastError();
}

// f, g [n / (H d), H * d] fp32 contiguous, a_log [H], dt_bias [H * d] fp32
int kda_gate_f32(const void* f, const void* a_log, const void* dt_bias, void* g, long long n,
                 int H, int d, void* stream) {
  if (n <= 0 || H <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + 255) / 256;
  kda_gate_kernel<<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(a_log),
      static_cast<const float*>(dt_bias), static_cast<float*>(g), n, H, d);
  return (int)cudaGetLastError();
}

// o, gate [rows, d] fp32 contiguous, w [d] fp32, out [rows, d] bf16; d % 4
// == 0, d <= 128
int kda_gated_norm_f32(const void* o, const void* w, const void* gate, void* out, long long rows,
                       int d, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d > 128 || d % 4) return (int)cudaErrorInvalidValue;
  if (!aligned16(o) || !aligned16(gate)) return (int)cudaErrorMisalignedAddress;
  kda_gated_norm_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<const float*>(w), static_cast<const float*>(gate),
      static_cast<__nv_bfloat16*>(out), rows, d, eps);
  return (int)cudaGetLastError();
}

int kda_chunk() { return C; }

}  // extern "C"
