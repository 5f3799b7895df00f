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
// What bounds it, at Moonlight's widths (D 2 048, I 1 408, 64 experts, 6 a
// token): per layer 2 * R * 3 * D * I operations at 989 TFLOP/s against the
// held experts' weights read once (64 * 3 * D * I * 2 bytes, 1.1 GB) plus
// the rows in and out. With R = 6 * 13.8k tokens a full batch's products
// take 48 ms of operations against 0.4 ms of bytes: the tensor cores bound
// it, until the rows per expert fall near 2 * 989 / 3.35 / 2 ~ 300.
//
// Design (a grouped tiled GEMM on mma.sync):
//   * The host knows R (from the shapes) but not how the rows fall on the
//     experts, so the grid's y covers the most row tiles any split can take,
//     floor((R + E * (BM - 1)) / BM); each block finds its expert and its
//     first row by a walk over the offsets (thread 0, E steps) and returns
//     at once past the last tile. Consecutive blocks of y take consecutive
//     row tiles of one expert, and x runs over the output columns fastest, so
//     an expert's weights are read from memory about once and then from L2.
//   * A block of 8 warps computes a [128 rows, 128 weight rows] tile: 2 x 4
//     warps of [64, 32]. For gate-up the block's 128 weight rows are 64 of
//     gate and the same 64 of up, and each warp holds 16 of each, so the
//     thread that holds gate column c holds up column c too, and SiLU·mul
//     is a register epilogue (64 output columns a block). For down the 128
//     rows are 128 output columns.
//   * K steps of 32 through a 4-stage cp.async ring (rows padded by 8
//     values, ldmatrix conflict-free), mma.sync m16n8k16 bf16 -> fp32; rows
//     past the group, weight rows past N and K past its end read as zeros.
// The combine: one block per token, 16-byte loads of its k rows.
// Each launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(). The trace names them `moe_gate_up_kernel`,
// `moe_down_kernel` and `moe_combine_kernel`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, THREADS = 256;
constexpr int LDS = BK + 8;  // a shared row, padded (values)
constexpr int SMEM = STAGES * (BM + BN) * LDS * 2;

struct Args {
  const __nv_bfloat16* x;   // [R, K]; gate-up: the tokens [T, K], row r at token[r]
  const __nv_bfloat16* w0;  // [E, N, K]: gate, or down
  const __nv_bfloat16* w1;  // [E, N, K]: up (gate-up only)
  const int* offsets;       // [E + 1]
  __nv_bfloat16* out;       // [R, N]
  int R, K, N, E;
  const long long* token;   // [R] (gate-up only)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + expf(-g)); }

// Which expert and which of its rows this block takes: thread 0 walks the
// offsets. Returns false past the last tile.
__device__ __forceinline__ bool find_tile(const Args& a, int& e_out, int& r0, int& r1) {
  __shared__ int found[3];
  if (threadIdx.x == 0) {
    int tile = blockIdx.y, e = 0, start = 0, end = 0;
    found[0] = -1;
    for (; e < a.E; ++e) {
      start = a.offsets[e];
      end = a.offsets[e + 1];
      const int tiles = (end - start + BM - 1) / BM;
      if (tile < tiles) {
        found[0] = e;
        found[1] = start + tile * BM;
        found[2] = end;
        break;
      }
      tile -= tiles;
    }
  }
  __syncthreads();
  e_out = found[0];
  r0 = found[1];
  r1 = found[2];
  return e_out >= 0;
}

// GATE_UP: 64 gate rows and the same 64 up rows a block, SiLU·mul epilogue;
// row r of the group reads x[token[r]] (the tokens in place). Else 128
// weight rows (output columns) a block, row r reading x[r].
template <bool GATE_UP>
__device__ __forceinline__ void grouped_gemm(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int e, r0, r1;
  if (!find_tile(a, e, r0, r1)) return;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDS]
  __nv_bfloat16* sB = sA + STAGES * BM * LDS;                   // [STAGES][BN][LDS]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * (GATE_UP ? BN / 2 : BN);
  const long long wexp = (long long)e * a.N * a.K;
  const __nv_bfloat16* W0 = a.w0 + wexp;
  const __nv_bfloat16* W1 = GATE_UP ? a.w1 + wexp : nullptr;
  const int KT = (a.K + BK - 1) / BK;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    // 128 rows x 4 pieces of 16 bytes, of x and of the weights: 2 + 2 a thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS, r = c / 4, col = (c % 4) * 8;
      const bool kok = k0 + col < a.K;
      const int row = r0 + r;
      const bool ok = kok && row < r1;
      const long long src = GATE_UP ? (ok ? a.token[row] : 0) : row;
      cp_async16(sA + (st * BM + r) * LDS + col, a.x + (ok ? src * a.K + k0 + col : 0), ok);
      int wr;
      const __nv_bfloat16* W;
      if (GATE_UP) {
        wr = n0 + (r & 63);
        W = r < 64 ? W0 : W1;
      } else {
        wr = n0 + r;
        W = W0;
      }
      const bool wok = kok && wr < a.N;
      cp_async16(sB + (st * BN + r) * LDS + col, W + (wok ? (long long)wr * a.K + k0 + col : 0),
                 wok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }

  // the weight rows of n8 tiles 2p, 2p + 1 of this warp
  const int brow[2] = {GATE_UP ? wn * 16 : wn * 32, GATE_UP ? 64 + wn * 16 : wn * 32 + 16};

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int st = kt % STAGES;
    const __nv_bfloat16* As = sA + st * BM * LDS;
    const __nv_bfloat16* Bs = sB + st * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], As + (wm * 64 + i * 16 + lane % 16) * LDS + 16 * kk + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int mi = lane / 8;
        uint32_t bf[4];
        ldmatrix_x4(bf, Bs + (brow[p] + lane % 8 + (mi / 2) * 8) * LDS + 16 * kk + (mi % 2) * 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma(acc[i][2 * p], af[i], bf[0], bf[1]);
          mma(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // register c of n8 tile j: row g (+8 for c >= 2), column 2t + (c & 1)
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + wm * 64 + i * 16 + g + hh * 8;
      if (row >= r1) continue;
      __nv_bfloat16* o = a.out + (long long)row * a.N;
      if (GATE_UP) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 16 + j * 8 + 2 * t;
          if (col >= a.N) continue;
          const float h0 = silu(acc[i][j][2 * hh]) * acc[i][j + 2][2 * hh];
          const float h1 = silu(acc[i][j][2 * hh + 1]) * acc[i][j + 2][2 * hh + 1];
          *reinterpret_cast<uint32_t*>(o + col) = pack_bf16(h0, h1);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + wn * 32 + j * 8 + 2 * t;
          if (col >= a.N) continue;
          *reinterpret_cast<uint32_t*>(o + col) =
              pack_bf16(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
        }
      }
    }
}

__global__ void __launch_bounds__(THREADS, 2) moe_gate_up_kernel(const Args a) {
  grouped_gemm<true>(a);
}

__global__ void __launch_bounds__(THREADS, 2) moe_down_kernel(const Args a) {
  grouped_gemm<false>(a);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch_gemm(bool gate_up, const Args& a, cudaStream_t s) {
  if (a.R < 0 || a.K <= 0 || a.N <= 0 || a.E <= 0 || a.K % 8 || a.N % 2 ||
      (gate_up && a.token == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(a.x) || !aligned16(a.w0) || (gate_up && !aligned16(a.w1)) || !aligned16(a.out))
    return (int)cudaErrorMisalignedAddress;
  if (a.R == 0) return 0;
  const long long tiles = ((long long)a.R + (long long)a.E * (BM - 1)) / BM;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const int cols = gate_up ? BN / 2 : BN;
  const dim3 grid((a.N + cols - 1) / cols, (unsigned)tiles);
  auto kern = gate_up ? moe_gate_up_kernel : moe_down_kernel;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, THREADS, SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [T, D] the tokens, token [R] int64 the token of each row sorted by
// expert, gate and up [E, I, D], offsets [E + 1] int32 (on the card;
// offsets[E] <= R), h [R, I]: only the rows of the E groups (up to
// offsets[E]) are read and written; D a multiple of 8.
int moe_gate_up_bf16(const void* x, const void* token, const void* gate, const void* up,
                     const void* offsets, void* h, int R, int D, int I, int E, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gate),
               static_cast<const __nv_bfloat16*>(up), static_cast<const int*>(offsets),
               static_cast<__nv_bfloat16*>(h), R, D, I, E, static_cast<const long long*>(token)};
  return launch_gemm(true, a, static_cast<cudaStream_t>(stream));
}

// h [R, I], down [E, D, I], offsets as above, y [R, D]; I a multiple of 8.
int moe_down_bf16(const void* h, const void* down, const void* offsets, void* y, int R, int I,
                  int D, int E, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(h), static_cast<const __nv_bfloat16*>(down),
               nullptr, static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(y), R, I, D,
               E, nullptr};
  return launch_gemm(false, a, static_cast<cudaStream_t>(stream));
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

int moe_block_m() { return BM; }

}  // extern "C"
