// Fused MLM-head masked max-pool for Hopper (sm_90a):
//
//     out[b, v] = max_l  mask[b, l] * (h[b, l, :] . w[v, :] + bias[v])
//
// h [B, L, D] bf16 (the post-LayerNorm head hidden states), mask [B, L] int32,
// w [V, D] bf16 (tied word embeddings or an untied decoder), bias [V] fp32,
// out [B, V] fp32. The [B, L, V] logits never reach device memory.
//
// Replaces the TPU kernel opensearch_sparse_model_tuning_sample_tpu/ops/
// pallas_maxpool.py (`_kernel`, launched by `maxpool_head`), with the
// semantics of the production head bert.mlm_maxpool: the bias is added in
// fp32 after an fp32-accumulated product, then the sum is multiplied by the
// mask, so a masked position contributes exactly 0 (not -inf) and an
// all-masked row pools to 0. Positions at or past L contribute nothing.
//
// What bounds it: 2*B*L*D*V operations against ~(V*D*2 + B*L*D*2 + B*V*4)
// bytes. At the mini width (B=50, L=128, D=256, V=30592) that is 1.0e11
// operations against 25 MB, so the bf16 tensor-core rate bounds it (about
// 0.10 ms at 989 TFLOP/s), not the 3.35 TB/s memory.
//
// Design (simple first; wgmma, TMA and a persistent grid are later work):
//   * a block owns one vocab tile of TV rows and a tile of TB docs and loops
//     over all of L for each doc itself: no carry between blocks, no atomics,
//     a deterministic result;
//   * the vocab tile of w stays in shared memory for all the block's docs;
//     h is staged LC sequence rows at a time;
//   * the product runs on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate). The vocab is the M side, the sequence the N side, so
//     the max over L is a max over each accumulator row: within a thread,
//     then across the four lanes of a quad;
//   * a step whose positions are all masked skips the product: each of its
//     positions contributes exactly 0, which the running max takes directly;
//   * shared rows are padded by 8 bf16 so the fragment loads are free of
//     bank conflicts for every D.
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLC = 32;          // sequence rows staged per step
constexpr int kNT = kLC / 8;     // n8 tiles per step
constexpr int kTB = 8;           // docs per block
constexpr int kMaxSmem = 232448; // dynamic shared memory a block may use

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MT m16 tiles of vocab rows per warp: the block's vocab tile is TV = 64*MT.
template <int MT>
__global__ void __launch_bounds__(kThreads)
maxpool_head_kernel(const __nv_bfloat16* __restrict__ h,
                    const int32_t* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    float* __restrict__ out, int B, int L, int D, int V) {
  constexpr int TV = kWarps * MT * 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D16 = (D + 15) & ~15;
  const int stride = D16 + 8;  // bf16 per shared row
  const int vecs = D16 / 8;    // 16-byte vectors per shared row
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* h_s = w_s + TV * stride;
  float* m_s = reinterpret_cast<float*>(h_s + kLC * stride);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // quad row, lane in quad
  const int v0 = blockIdx.x * TV;
  const int row0 = warp * MT * 16;        // this warp's first row in the tile

  // stage the vocab tile; rows past V and columns past D are zero
  for (int i = tid; i < TV * vecs; i += kThreads) {
    const int r = i / vecs, c = (i - r * vecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (v0 + r < V && c < D)
      val = *reinterpret_cast<const uint4*>(w + (size_t)(v0 + r) * D + c);
    *reinterpret_cast<uint4*>(w_s + r * stride + c) = val;
  }

  float bias_r[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int v = v0 + row0 + mt * 16 + g + hh * 8;
      bias_r[mt][hh] = v < V ? bias[v] : 0.f;
    }

  const int b_end = min((int)blockIdx.y * kTB + kTB, B);
  for (int b = blockIdx.y * kTB; b < b_end; ++b) {
    float run[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) run[mt][0] = run[mt][1] = -INFINITY;

    for (int l0 = 0; l0 < L; l0 += kLC) {
      __syncthreads();  // the last step's readers are done with h_s and m_s
      const __nv_bfloat16* hb = h + ((size_t)b * L + l0) * D;
      for (int i = tid; i < kLC * vecs; i += kThreads) {
        const int r = i / vecs, c = (i - r * vecs) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (l0 + r < L && c < D)
          val = *reinterpret_cast<const uint4*>(hb + (size_t)r * D + c);
        *reinterpret_cast<uint4*>(h_s + r * stride + c) = val;
      }
      int live = 0;
      if (tid < kLC) {
        float m = 0.f;
        if (l0 + tid < L) {
          m = (float)mask[(size_t)b * L + l0 + tid];
          live = m != 0.f;
        }
        m_s[tid] = m;
      }
      live = __syncthreads_or(live);
      const int rows = min(kLC, L - l0);
      if (!live) {
        // every position here is masked and contributes exactly 0
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          run[mt][0] = fmaxf(run[mt][0], 0.f);
          run[mt][1] = fmaxf(run[mt][1], 0.f);
        }
        continue;
      }

      float acc[MT][kNT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

      for (int k0 = 0; k0 < D16; k0 += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const __nv_bfloat16* p = w_s + (row0 + mt * 16 + g) * stride + k0 + 2 * t;
          a[mt][0] = ld_pair(p);
          a[mt][1] = ld_pair(p + 8 * stride);
          a[mt][2] = ld_pair(p + 8);
          a[mt][3] = ld_pair(p + 8 * stride + 8);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const __nv_bfloat16* p = h_s + (nt * 8 + g) * stride + k0 + 2 * t;
          const uint32_t b0 = ld_pair(p), b1 = ld_pair(p + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_16816(acc[mt][nt], a[mt], b0, b1);
        }
      }

      // accumulator (mt, nt): c0,c1 -> vocab row g, positions 2t, 2t+1;
      // c2,c3 -> vocab row g+8, same positions
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int l = nt * 8 + 2 * t + j;
          if (l < rows) {
            const float m = m_s[l];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              run[mt][0] = fmaxf(run[mt][0], (acc[mt][nt][j] + bias_r[mt][0]) * m);
              run[mt][1] = fmaxf(run[mt][1], (acc[mt][nt][2 + j] + bias_r[mt][1]) * m);
            }
          }
        }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float r = run[mt][hh];
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
        r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
        const int v = v0 + row0 + mt * 16 + g + hh * 8;
        if (t == 0 && v < V) out[(size_t)b * V + v] = r;
      }
  }
}

size_t smem_bytes(int mt, int D) {
  const int stride = ((D + 15) & ~15) + 8;
  return (size_t)(kWarps * mt * 16 + kLC) * stride * 2 + kLC * sizeof(float);
}

template <int MT>
int launch(const void* h, const void* mask, const void* w, const void* bias,
           void* out, int B, int L, int D, int V, cudaStream_t stream) {
  const size_t smem = smem_bytes(MT, D);
  cudaError_t err = cudaFuncSetAttribute(
      maxpool_head_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int TV = kWarps * MT * 16;
  const dim3 grid((V + TV - 1) / TV, (B + kTB - 1) / kTB);
  maxpool_head_kernel<MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const int32_t*>(mask),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), B, L, D, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest hidden width the kernel takes (the vocab tile and one staged step
// must fit in shared memory); the wrapper raises above it.
int maxpool_head_max_dim() {
  int D = 8;
  while (smem_bytes(1, D + 8) <= (size_t)kMaxSmem) D += 8;
  return D;
}

int maxpool_head_bf16(const void* h, const void* mask, const void* w,
                      const void* bias, void* out, int B, int L, int D, int V,
                      void* stream) {
  if (B <= 0 || L <= 0 || V <= 0 || D <= 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(2, D) <= (size_t)kMaxSmem)
    return launch<2>(h, mask, w, bias, out, B, L, D, V, s);
  if (smem_bytes(1, D) <= (size_t)kMaxSmem)
    return launch<1>(h, mask, w, bias, out, B, L, D, V, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
