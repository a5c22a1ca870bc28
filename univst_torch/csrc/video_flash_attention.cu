// Sparse-causal video flash attention for Hopper (sm_90a), in two layouts.
//
// Replaces the Pallas TPU kernels of univst_tpu/attention/pallas_attention.py:
//   K1 video_flash_attention (_kernel): head-major q [B, F, H, Lq, dh],
//      k/v [B, F, H, L, dh], ctx [B, F, H, Lc, dh];
//   K2 video_flash_attention_folded (_kernel_folded): token-major q
//      [B, F, Lq, H, dh], k/v [B, F, L, H, dh], ctx [B, F, Lc, H, dh] -- free
//      views of a projection output [B*F, L, H*dh], so no head transpose
//      exists on either side.
// One kernel body serves both: the layout is a template parameter that only
// changes the addressing (a (frame, head) row starts at
// ((frame * H + h) * len) * dh with token stride dh head-major, and at
// frame * len * H * dh + h * dh with token stride H * dh token-major).
// Target frame f of row (b, f, h) attends the concatenation of the K/V of
// its source frames srcs[f, s], read in place from the unexpanded tensors:
// the gather is address arithmetic, no expanded K/V exists. A slot that
// repeats an earlier source of the same frame has mult 0 and is skipped; the
// kept slot weights its probability mass by its multiplicity (exact: softmax
// over duplicated keys). An optional per-frame context K/V (ctx above) is one
// more pass, limited to ctx_valid keys.
//
// Design: one block per (b*f*h row, 64-query tile); an in-block loop walks
// the kept slots' 64-key tiles and then the context tiles through shared
// memory. The online softmax runs in base 2 in fp32 registers; the output
// is written once, in the input type. Blocks share no state, so they may run
// in any order.
//
// Bound on the card: tensor-core FLOPs (4 * Lq * dh * L * kept slots per
// row), far above the bytes moved. bf16 inputs therefore run on the tensor
// cores: four warps of 16 query rows each issue mma.sync m16n8k16 for
// Q K^T and P V (fp32 accumulators), with the Q fragments held in registers
// for the whole key loop and V staged transposed so each B fragment is one
// 32-bit load. dh is padded to the 16-wide MMA depth in shared memory only
// (dh=40 -> 48), never in device memory. fp32 inputs keep exact fp32
// arithmetic on the CUDA cores (16x16 threads, 4x4 logits each). No
// cp.async/TMA pipelining and no wgmma yet: loads and math of a tile do not
// overlap, which is the next step toward the bound.
//
// Token-major loads: a head's token row is dh contiguous values (128 bytes
// at dh=64), H * dh apart from the next token's. Tiles are read row by row
// with 16-byte moves, consecutive threads on consecutive 16-byte chunks of
// one row, so every 32-byte sector is used whole. The V tile stays
// row-major in shared memory and the P V B-fragments come from
// ldmatrix.trans (a transposed staging would put consecutive threads on
// rows 3 KB apart). Ragged q tiles (Lq = 4096 + 333 in the SD3 merged
// [img | ctx] stream) and ragged key tiles are masked in the kernel.
//
// C entry points (ctypes), each returning cudaGetLastError() after its
// launch: univst_video_flash_attention (K1, head-major) and
// univst_video_flash_attention_tokens (K2, token-major).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads, 4x4 logits each
constexpr int MAX_DH = 128;
constexpr int NC_MAX = MAX_DH / 16;  // output columns per thread
constexpr float NEG = -1e30f;

// Offset of the (frame, head) row of a [.., len, ..] tensor, frame = b * F + f;
// its tokens are token_stride<TM>(H, dh) elements apart.
template <bool TM>
__device__ __forceinline__ size_t row_base(int frame, int h, int H, int len, int dh) {
  return TM ? (size_t)frame * len * H * dh + (size_t)h * dh : ((size_t)frame * H + h) * len * dh;
}

template <bool TM>
__device__ __forceinline__ int token_stride(int H, int dh) {
  return TM ? H * dh : dh;
}

// ---------------------------------------------------------------------------
// fp32: exact fp32 arithmetic on the CUDA cores
// ---------------------------------------------------------------------------

// rows x dh tile from a source with rows `ts` apart into dst[r * ld + d];
// rows past `valid` are zero.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* __restrict__ src,
                                          int valid, int dh, int ts, int tid) {
  for (int i = tid; i < BK * dh; i += THREADS) {
    const int r = i / dh, d = i - r * dh;
    dst[r * ld + d] = r < valid ? src[(size_t)r * ts + d] : 0.f;
  }
}

size_t smem_bytes(int dh) {
  const int ld = dh | 1;
  return sizeof(float) * ((size_t)BQ * ld + (size_t)BK * ld + (size_t)BK * dh +
                          (size_t)BQ * (BK + 1));
}

template <bool TM>
__global__ void __launch_bounds__(THREADS)
    vfa_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ ck,
               const float* __restrict__ cv, float* __restrict__ out,
               const int* __restrict__ srcs, const int* __restrict__ mult, int F, int H,
               int Lq, int L, int Lc, int ctx_valid, int dh, int S, float scale_log2) {
  extern __shared__ float smem[];
  const int ld = dh | 1;  // odd stride: the 16 key rows a warp reads hit 16 banks
  float* Qs = smem;           // [BQ][ld]
  float* Ks = Qs + BQ * ld;   // [BK][ld]
  float* Vs = Ks + BK * ld;   // [BK][dh]
  float* Ps = Vs + BK * dh;   // [BQ][BK + 1]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int row = blockIdx.x;  // (b * F + f) * H + h
  const int hh = row % H, f = (row / H) % F, b = row / (H * F);
  const int q0 = blockIdx.y * BQ;
  const int nc = (dh + 15) >> 4;
  const int ts = token_stride<TM>(H, dh);
  const size_t qbase = row_base<TM>(row / H, hh, H, Lq, dh);

  load_tile(Qs, ld, q + qbase + (size_t)q0 * ts, min(BQ, Lq - q0), dh, ts, tid);

  float m[4], l[4], o[4][NC_MAX];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC_MAX; ++c) o[i][c] = 0.f;
  }

  // One key tile: logits, online-softmax update, P @ V. `w` is the slot
  // multiplicity (1 for the context).
  auto tile = [&](const float* kp, const float* vp, int valid, float w) {
    __syncthreads();  // everyone is done with the previous Ks/Vs/Ps
    load_tile(Ks, ld, kp, valid, dh, ts, tid);
    load_tile(Vs, dh, vp, valid, dh, ts, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (tx + 16 * j < valid) ? s[i][j] * scale_log2 : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are 16 consecutive lanes
#pragma unroll
      for (int off = 8; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        Ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p * w;
      }
#pragma unroll
      for (int off = 8; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + w * sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC_MAX; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC_MAX; ++c) {
        const int d = tx + 16 * c;
        if (c < nc && d < dh) {
          const float vv = Vs[kk * dh + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], vv, o[i][c]);
        }
      }
    }
  };

  for (int s = 0; s < S; ++s) {
    const int w = mult[f * S + s];
    if (w == 0) continue;  // duplicate of an earlier slot (uniform per block)
    const size_t base = row_base<TM>(b * F + srcs[f * S + s], hh, H, L, dh);
    for (int k0 = 0; k0 < L; k0 += BK)
      tile(k + base + (size_t)k0 * ts, v + base + (size_t)k0 * ts, min(BK, L - k0), (float)w);
  }
  if (ck != nullptr) {
    const size_t base = row_base<TM>(row / H, hh, H, Lc, dh);
    for (int k0 = 0; k0 < ctx_valid; k0 += BK)
      tile(ck + base + (size_t)k0 * ts, cv + base + (size_t)k0 * ts, min(BK, ctx_valid - k0),
           1.f);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float inv = 1.f / l[i];
    float* orow = out + qbase + (size_t)r * ts;
#pragma unroll
    for (int c = 0; c < NC_MAX; ++c) {
      const int d = tx + 16 * c;
      if (c < nc && d < dh) orow[d] = o[i][c] * inv;
    }
  }
}

template <bool TM>
int launch_fp32(const void* q, const void* k, const void* v, const void* ck, const void* cv,
                void* out, const int* srcs, const int* mult, int B, int F, int H, int Lq, int L,
                int Lc, int ctx_valid, int dh, int S, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      vfa_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(MAX_DH));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * F * H, (Lq + BQ - 1) / BQ);
  vfa_kernel<TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(ck), static_cast<const float*>(cv), static_cast<float*>(out),
      srcs, mult, F, H, Lq, L, Lc, ctx_valid, dh, S, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16: tensor-core path (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

constexpr int MQ = 64;            // query rows per block: 4 warps x 16
constexpr int MK = 64;            // keys per tile
constexpr int MMA_THREADS = 128;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo -> low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 b16 matrices from shared memory, transposed: lanes 8j..8j+7 give
// the row addresses of matrix j, and r[j] receives the B fragment half
// {M_j[2c][g], M_j[2c + 1][g]} (g = lane / 4, c = lane % 4) of mma.m16n8k16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 64 x dh rows of a source with rows `ts` apart into dst[r * ld + d] with
// 16-byte moves (consecutive threads on consecutive 16-byte chunks of a
// row); columns [dh, DP) and rows past `valid` are zero.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* __restrict__ src,
                                          int valid, int dh, int ts, int tid) {
  constexpr int VPR = DP / 8;
  const int vdh = dh / 8;
  for (int i = tid; i < MK * VPR; i += MMA_THREADS) {
    const int r = i / VPR, c = i - r * VPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < vdh) val = *reinterpret_cast<const uint4*>(src + (size_t)r * ts + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

// The same tile transposed: dst[d * ldt + r] = src[r, d] (consecutive
// threads take consecutive rows, so the 2-byte stores fill whole words).
template <int DP>
__device__ __forceinline__ void load_cols(bf16* dst, int ldt, const bf16* __restrict__ src,
                                          int valid, int dh, int tid) {
  constexpr int VPR = DP / 8;
  const int vdh = dh / 8;
  for (int i = tid; i < MK * VPR; i += MMA_THREADS) {
    const int c = i / MK, r = i - c * MK;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid && c < vdh) val = *reinterpret_cast<const uint4*>(src + (size_t)r * dh + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c * 8 + j) * ldt + r] = e[j];
  }
}

template <int DP, bool TM>
__global__ void __launch_bounds__(MMA_THREADS)
    vfa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ ck,
                   const bf16* __restrict__ cv, bf16* __restrict__ out,
                   const int* __restrict__ srcs, const int* __restrict__ mult, int F, int H,
                   int Lq, int L, int Lc, int ctx_valid, int dh, int S, float scale_log2) {
  constexpr int LD = DP + 8;   // Q/K smem row stride: 16-byte rows on staggered banks
  constexpr int LDT = MK + 8;  // V^T smem row stride
  constexpr int KS = DP / 16;  // MMA k-steps of Q K^T
  constexpr int NT = DP / 8;   // 8-wide output column tiles
  __shared__ __align__(16) bf16 QKs[MQ * LD];  // the Q tile, then each K tile
  // head-major: V^T [DP][LDT]; token-major: V row-major [MK][LD] (ldmatrix.trans)
  __shared__ __align__(16) bf16 Vt[TM ? MK * LD : DP * LDT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // MMA fragment row / column pair
  const int row = blockIdx.x;             // (b * F + f) * H + h
  const int hh = row % H, f = (row / H) % F, b = row / (H * F);
  const int q0 = blockIdx.y * MQ;
  const int r0 = warp * 16;
  const int ts = token_stride<TM>(H, dh);
  const size_t qbase = row_base<TM>(row / H, hh, H, Lq, dh);

  load_rows<DP>(QKs, LD, q + qbase + (size_t)q0 * ts, min(MQ, Lq - q0), dh, ts, tid);
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* p = QKs + (r0 + g) * LD + kk * 16 + 2 * c;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LD);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LD + 8);
  }
  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g + 8 of the warp

  auto tile = [&](const bf16* kp, const bf16* vp, int valid, float w) {
    __syncthreads();  // the Q fragments / previous tile are consumed
    load_rows<DP>(QKs, LD, kp, valid, dh, ts, tid);
    if constexpr (TM)
      load_rows<DP>(Vt, LD, vp, valid, dh, ts, tid);
    else
      load_cols<DP>(Vt, LDT, vp, valid, dh, tid);
    __syncthreads();

    float s[MK / 8][4];
#pragma unroll
    for (int j = 0; j < MK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const bf16* p = QKs + (8 * j + g) * LD + kk * 16 + 2 * c;
        mma_bf16(s[j], qf[kk], ld32(p), ld32(p + 8));
      }
    }
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = 8 * j + 2 * c + e < valid;
        s[j][e] = ok ? s[j][e] * scale_log2 : NEG;
        s[j][2 + e] = ok ? s[j][2 + e] * scale_log2 : NEG;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    // a row's 64 logits live in the 4 lanes of a quad
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < MK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - mn0);
        s[j][2 + e] = exp2f(s[j][2 + e] - mn1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * a0 + w * sum0;
    l1 = l1 * a1 + w * sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      o[t][0] *= a0;
      o[t][1] *= a0;
      o[t][2] *= a1;
      o[t][3] *= a1;
    }
    // P @ V: the logit accumulators of two adjacent key tiles are exactly
    // the A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(w * s[2 * kk][0], w * s[2 * kk][1]);
      pa[1] = pack_bf16(w * s[2 * kk][2], w * s[2 * kk][3]);
      pa[2] = pack_bf16(w * s[2 * kk + 1][0], w * s[2 * kk + 1][1]);
      pa[3] = pack_bf16(w * s[2 * kk + 1][2], w * s[2 * kk + 1][3]);
      if constexpr (TM) {
        // matrices: keys kk*16 + {0, 8} x columns 8t + {0, 8} -> the B
        // fragments of output tiles t and t + 1 (NT is even)
        const int mat = lane >> 3;
        const bf16* p = Vt + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * LD + 8 * (mat >> 1);
#pragma unroll
        for (int t = 0; t < NT; t += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, p + 8 * t);
          mma_bf16(o[t], pa, bv[0], bv[1]);
          mma_bf16(o[t + 1], pa, bv[2], bv[3]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const bf16* p = Vt + (8 * t + g) * LDT + kk * 16 + 2 * c;
          mma_bf16(o[t], pa, ld32(p), ld32(p + 8));
        }
      }
    }
  };

  for (int s = 0; s < S; ++s) {
    const int w = mult[f * S + s];
    if (w == 0) continue;  // duplicate of an earlier slot (uniform per block)
    const size_t base = row_base<TM>(b * F + srcs[f * S + s], hh, H, L, dh);
    for (int k0 = 0; k0 < L; k0 += MK)
      tile(k + base + (size_t)k0 * ts, v + base + (size_t)k0 * ts, min(MK, L - k0), (float)w);
  }
  if (ck != nullptr) {
    const size_t base = row_base<TM>(row / H, hh, H, Lc, dh);
    for (int k0 = 0; k0 < ctx_valid; k0 += MK)
      tile(ck + base + (size_t)k0 * ts, cv + base + (size_t)k0 * ts, min(MK, ctx_valid - k0),
           1.f);
  }

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int ra = q0 + r0 + g, rb = ra + 8;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int col = 8 * t + 2 * c;  // dh % 8 == 0: col < dh covers col + 1
    if (col >= dh) continue;
    if (ra < Lq)
      *reinterpret_cast<uint32_t*>(out + qbase + (size_t)ra * ts + col) =
          pack_bf16(o[t][0] * inv0, o[t][1] * inv0);
    if (rb < Lq)
      *reinterpret_cast<uint32_t*>(out + qbase + (size_t)rb * ts + col) =
          pack_bf16(o[t][2] * inv1, o[t][3] * inv1);
  }
}

template <int DP, bool TM>
int launch_mma(const void* q, const void* k, const void* v, const void* ck, const void* cv,
               void* out, const int* srcs, const int* mult, int B, int F, int H, int Lq, int L,
               int Lc, int ctx_valid, int dh, int S, float sm_scale, cudaStream_t stream) {
  const dim3 grid(B * F * H, (Lq + MQ - 1) / MQ);
  vfa_mma_kernel<DP, TM><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(ck), static_cast<const bf16*>(cv), static_cast<bf16*>(out), srcs,
      mult, F, H, Lq, L, Lc, ctx_valid, dh, S, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <bool TM>
int launch(const void* q, const void* k, const void* v, const void* ck, const void* cv, void* out,
           const int* srcs, const int* mult, int B, int F, int H, int Lq, int L, int Lc,
           int ctx_valid, int dh, int S, float sm_scale, int is_bf16, void* stream) {
  if (dh <= 0 || dh > MAX_DH || dh % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
#define VFA_MMA(DP)                                                                            \
  case DP:                                                                                     \
    return launch_mma<DP, TM>(q, k, v, ck, cv, out, srcs, mult, B, F, H, Lq, L, Lc, ctx_valid,  \
                              dh, S, sm_scale, st);
    switch ((dh + 15) / 16 * 16) {  // MMA depth: dh padded to 16 on chip
      VFA_MMA(16) VFA_MMA(32) VFA_MMA(48) VFA_MMA(64)
      VFA_MMA(80) VFA_MMA(96) VFA_MMA(112) VFA_MMA(128)
    }
#undef VFA_MMA
    return (int)cudaErrorInvalidValue;
  }
  return launch_fp32<TM>(q, k, v, ck, cv, out, srcs, mult, B, F, H, Lq, L, Lc, ctx_valid, dh, S,
                         sm_scale, st);
}

}  // namespace

// K1: head-major q [B, F, H, Lq, dh], k/v [B, F, H, L, dh], ctx [B, F, H, Lc, dh].
extern "C" int univst_video_flash_attention(const void* q, const void* k, const void* v,
                                            const void* ctx_k, const void* ctx_v, void* out,
                                            const int* srcs, const int* mult, int B, int F,
                                            int H, int Lq, int L, int Lc, int ctx_valid, int dh,
                                            int S, float sm_scale, int is_bf16, void* stream) {
  return launch<false>(q, k, v, ctx_k, ctx_v, out, srcs, mult, B, F, H, Lq, L, Lc, ctx_valid, dh,
                       S, sm_scale, is_bf16, stream);
}

// K2: token-major q [B, F, Lq, H, dh], k/v [B, F, L, H, dh], ctx [B, F, Lc, H, dh].
extern "C" int univst_video_flash_attention_tokens(const void* q, const void* k, const void* v,
                                                   const void* ctx_k, const void* ctx_v,
                                                   void* out, const int* srcs, const int* mult,
                                                   int B, int F, int H, int Lq, int L, int Lc,
                                                   int ctx_valid, int dh, int S, float sm_scale,
                                                   int is_bf16, void* stream) {
  return launch<true>(q, k, v, ctx_k, ctx_v, out, srcs, mult, B, F, H, Lq, L, Lc, ctx_valid, dh,
                      S, sm_scale, is_bf16, stream);
}
