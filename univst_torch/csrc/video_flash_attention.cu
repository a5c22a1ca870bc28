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
// changes the addressing (the TMA tensor maps below, and the output stores).
// Target frame f of row (b, f, h) attends the concatenation of the K/V of
// its source frames srcs[f, s], read in place from the unexpanded tensors
// (k/v hold Fk frames a batch row: F, or, for a rank of a frame-sharded
// run, its own frames followed by the halo frames they read):
// the gather is address arithmetic, no expanded K/V exists. A slot that
// repeats an earlier source of the same frame has mult 0 and is skipped; the
// kept slot weights its probability mass by its multiplicity (exact: softmax
// over duplicated keys). An optional per-frame context K/V (ctx above) is one
// more pass, limited to ctx_valid keys.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s; exponentials
// on the MUFU at 16 per clock per SM and on the FMA pipe at 128 operations
// per clock per SM over the 6 of ex2_fma below: 37.3 per clock per SM in
// all, 9.76e12/s at the 1980 MHz max clock of an NVIDIA H100 80GB HBM3 at
// 700 W), per call at the main shapes
// (univst_torch/attention/video_flash.py::work counts them):
//   K1 [B=2, F=16, H=8, L=4096, dh=40], (-1, 0, 'first'), 45 kept slots:
//      1.93e12 FLOPs -> 1.95 ms; 1.21e10 exponentials -> 1.24 ms (2.89 ms
//      on the MUFU alone); 0.34 GB -> 0.10 ms. The tensor cores are the
//      floor only if part of the exponentials leaves the MUFU.
//   K2 [B=2, F=16, H=24, Lq=4429, L=4096, dh=64] + 333 ctx rows:
//      1.03e13 FLOPs -> 10.44 ms; 4.03e10 exponentials -> 4.13 ms (9.64 ms
//      on the MUFU alone); 1.74 GB -> 0.52 ms. The tensor cores are the
//      floor, with the MUFU alone within 8% of it.
// Bytes are far below both, so the design keeps every K/V byte in L2 and
// the tensor cores and the exponential units busy at once:
//   * launch order: the q tiles of one (b, f, h) row are adjacent block
//     indices, so the blocks resident at once share a few rows' source K/V,
//     which stays in the 50 MB L2 (row-major order streamed it from HBM on
//     every wave);
//   * 128 query rows per block (two consumer warpgroups of 64) and 192-key
//     tiles (128 at dh > 64, where the output accumulator is wider): each
//     K/V byte brought into shared memory serves 128 queries; setmaxnreg
//     gives the consumers 240 registers a thread for the logits, the
//     probabilities and the output of a tile;
//   * a producer warp keeps a ring of 4 (3 at dh > 64) K/V stages in flight
//     with TMA (cp.async.bulk.tensor) on mbarrier full/empty pairs; the
//     gather is a TMA coordinate (source frame, head, token), and the tensor
//     maps' zero fill supplies the dh pad (a 64-column box on dh = 40) and
//     the ragged query, key and context tiles (the context map is ctx_valid
//     tokens long, so keys past it read as zeros and are masked), so no pad
//     exists in device memory;
//   * wgmma for both products: S = Q K^T from shared memory (K-major, dh
//     padded to the 16-deep step), O += P V with P from registers and V read
//     MN-major through the descriptor's transpose bit (no transposed copy),
//     N = dh padded to 16; the multiplicity weight enters P as + log2(w) in
//     the exponent;
//   * softmax overlapped with the products: the two consumer warpgroups take
//     turns on named barriers, so one computes exponentials while the
//     other's products run, and within a warpgroup the P V of tile t - 1
//     runs while the softmax of tile t does (FlashAttention-3's schedule);
//   * less work around the exponential unit: the exponentials run against
//     the running max without waiting for the tile's or rescaling O (the
//     rare tile whose logits outgrow it by more than 8 is recomputed), and a
//     quarter of them run as a cubic on the FMA pipe (FlashAttention-4's
//     split; the other three quarters still take K1 2.17 ms of MUFU time,
//     above its tensor floor).
// The online softmax runs in base 2 in fp32 registers; the output is written
// once, in the input type. fp32 inputs keep exact fp32 arithmetic on the
// CUDA cores (16x16 threads, 4x4 logits each, one block per row and 64-query
// tile), which no main path runs.
//
// C entry points (ctypes), each returning cudaGetLastError() after its
// launch: univst_video_flash_attention (K1, head-major) and
// univst_video_flash_attention_tokens (K2, token-major).

#include <cuda.h>  // CUtensorMap and its enums (types only: no driver library is linked)
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
               const int* __restrict__ srcs, const int* __restrict__ mult, int F, int Fk,
               int H, int Lq, int L, int Lc, int ctx_valid, int dh, int S, float scale_log2) {
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
    const size_t base = row_base<TM>(b * Fk + srcs[f * S + s], hh, H, L, dh);
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
                void* out, const int* srcs, const int* mult, int B, int F, int Fk, int H, int Lq,
                int L, int Lc, int ctx_valid, int dh, int S, float sm_scale,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  cudaError_t err = cudaFuncSetAttribute(
      vfa_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(MAX_DH));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * F * H, (Lq + BQ - 1) / BQ);
  vfa_kernel<TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(ck), static_cast<const float*>(cv), static_cast<float*>(out),
      srcs, mult, F, Fk, H, Lq, L, Lc, ctx_valid, dh, S, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: Hopper path (TMA ring, wgmma, two ping-ponging consumer warpgroups)
// ---------------------------------------------------------------------------

constexpr int HQ = 128;               // query rows per block: two consumer warpgroups x 64
constexpr int ATOM = 64;              // bf16 columns of one 128-byte swizzled row
constexpr int HOPPER_THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int MAX_SLOTS = 16;         // source slots per target frame
constexpr int ROW_BYTES = 2 * ATOM;   // one swizzled row
constexpr int FMA_EXP_EVERY = 4;      // every 4th 8-key group's exponentials run on the FMA pipe
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of `parity` to complete. (No trap on a long wait: a
// trap path keeps ptxas from giving the consumers more than 168 registers.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}

// One TMA box into shared memory, completing on `bar`. Head-major maps are
// {dh, len, frames * H} at (col, token, frame * H + h); token-major maps are
// {dh, H, len, frames} at (col, h, token, frame).
template <bool TM>
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                        int tok, int frame, int h, int H) {
  if constexpr (TM)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(h), "r"(tok),
        "r"(frame)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(tok),
        "r"(frame * H + h)
        : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1 = 128B swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x on the FMA pipe (FlashAttention-4's split of the exponentials): round
// x to n + f, f in [-0.5, 0.5], a cubic for 2^f (relative error 1.0e-4,
// a twentieth of a bf16 half-ulp) and n added to the exponent bits: six
// fp32 operations on the FMA pipe (three adds, three FMAs). x is
// clamped to [-125, 126]: -inf gives 2^-125 in place of 0, a weight no
// output can show, and a logit far above the running max still reads as
// huge (the caller's check then recomputes the tile).
__device__ __forceinline__ float ex2_fma(float x) {
  x = fminf(fmaxf(x, -125.f), 126.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: n in the low mantissa bits
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.05500893f, f, 0.24221097f), f, 0.6932829f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo -> low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Named barriers 1 and 2: the tensor-core turn of consumer warpgroup 0 / 1;
// 3 and 4: votes within consumer warpgroup 0 / 1.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// True on every thread of a warpgroup if `pred` holds on any of them
// (named barrier `id`, 128 threads).
__device__ __forceinline__ bool wg_any(bool pred, int id) {
  uint32_t any;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, 128, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(any)
      : "r"(static_cast<uint32_t>(pred)), "r"(id)
      : "memory");
  return any != 0;
}

// D[64 x 128] (+)= A B^T, A and B K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 192] (+)= A B^T, A and B K-major in shared memory (128-byte swizzle).
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x N] += A B, A from registers (bf16 pairs in the accumulator layout),
// B MN-major in shared memory (128-byte swizzle, transpose bit set): N is
// the head dim padded to 16, so no product runs on pad columns past it.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Tile shapes by the number KS of 16-deep Q K^T steps (dh padded to 16).
// dh <= 64 is one 64-column atom with 192-key tiles; dh <= 128 is two atoms
// with 128-key tiles, which keep the output accumulator, the logits and the
// probabilities of a tile within the consumers' registers, and the ring
// within shared memory. Shared memory holds the Q tile, then STAGES K tiles
// and STAGES V tiles, each NA column atoms of rows x 128 bytes (1024-byte
// aligned: the swizzle repeats every 8 rows), then the barriers and the slot
// table.
template <int KS>
struct HopperCfg {
  static constexpr int NA = KS <= 4 ? 1 : 2;
  static constexpr int DP = 16 * KS;    // P V output width: dh padded to 16
  static constexpr int BK = NA == 1 ? 192 : 128;
  static constexpr int STAGES = NA == 1 ? 4 : 3;
  static constexpr int QA_BYTES = HQ * ROW_BYTES;  // one column atom of Q
  static constexpr int KA_BYTES = BK * ROW_BYTES;  // one column atom of a K or V tile
  static constexpr int Q_BYTES = NA * QA_BYTES;
  static constexpr int KV_BYTES = NA * KA_BYTES;
  static constexpr int TILES = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = 1024 + TILES + (2 * STAGES + 1) * 8 + MAX_SLOTS * 8 + 16;
};

// One block: 128 query rows of one (b, f, h) row; the producer warp walks the
// kept slots' key tiles and then the context tiles through a ring of STAGES
// K/V tiles; each consumer warpgroup owns 64 query rows.
template <int KS, bool TM>
__global__ void __launch_bounds__(HOPPER_THREADS, 1)
    vfa_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tck,
                      const __grid_constant__ CUtensorMap tcv, bf16* __restrict__ out,
                      const int* __restrict__ srcs, const int* __restrict__ mult, int F, int Fk,
                      int H, int Lq, int L, int ctx_valid, int dh, int S, int nq,
                      float scale_log2) {
  using Cfg = HopperCfg<KS>;
  constexpr int NA = Cfg::NA, BK = Cfg::BK, STAGES = Cfg::STAGES;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~static_cast<uintptr_t>(1023));
  uint8_t* sk = sq + Cfg::Q_BYTES;
  uint8_t* sv = sk + STAGES * Cfg::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sq + Cfg::TILES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  int* kept_src = reinterpret_cast<int*>(qbar + 1);
  float* kept_lw = reinterpret_cast<float*>(kept_src + MAX_SLOTS);
  int* nkept_s = reinterpret_cast<int*>(kept_lw + MAX_SLOTS);

  const int tid = threadIdx.x;
  const int row = blockIdx.x / nq;  // (b * F + f) * H + h; a row's q tiles are adjacent
  const int q0 = (blockIdx.x - row * nq) * HQ;
  const int hh = row % H, frame = row / H, f = frame % F, b = frame / F;

  if (tid == 0) {
    // kept slots of this frame: source frame and log2 of the multiplicity
    int n = 0;
    for (int s = 0; s < S; ++s) {
      const int w = mult[f * S + s];
      if (w > 0) {
        kept_src[n] = srcs[f * S + s];
        kept_lw[n] = log2f(static_cast<float>(w));
        ++n;
      }
    }
    *nkept_s = n;
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nkept = *nkept_s;
  const int nk = (L + BK - 1) / BK;  // key tiles per source frame
  const int nslot = nkept * nk;
  const int ntiles = nslot + (ctx_valid + BK - 1) / BK;  // ctx_valid is 0 without context

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load, and hands
    // its registers to the consumers (up to 240 a thread). ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(qbar, Cfg::Q_BYTES);
#pragma unroll
      for (int a = 0; a < NA; ++a)
        tma_box<TM>(sq + a * Cfg::QA_BYTES, &tq, qbar, a * ATOM, q0, frame, hh, H);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * Cfg::KV_BYTES);
        const bool ctx = t >= nslot;
        const int i = ctx ? 0 : t / nk;
        const int tok = (ctx ? t - nslot : t - i * nk) * BK;
        const int src = ctx ? frame : b * Fk + kept_src[i];
        uint8_t* kd = sk + st * Cfg::KV_BYTES;
        uint8_t* vd = sv + st * Cfg::KV_BYTES;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          tma_box<TM>(kd + a * Cfg::KA_BYTES, ctx ? &tck : &tk, &full[st], a * ATOM, tok, src, hh,
                      H);
          tma_box<TM>(vd + a * Cfg::KA_BYTES, ctx ? &tcv : &tv, &full[st], a * ATOM, tok, src, hh,
                      H);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128 - 1;  // 0 or 1
    const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, c = lane & 3;
    const uint32_t q_addr = smem_u32(sq) + cw * 64 * ROW_BYTES;
    const uint32_t k_addr = smem_u32(sk), v_addr = smem_u32(sv);

    float o[Cfg::DP / 2];  // output accumulator: rows g / g + 8, columns 8j + 2c (+1)
#pragma unroll
    for (int i = 0; i < Cfg::DP / 2; ++i) o[i] = 0.f;
    float s[BK / 2];         // logits of the current tile, same layout
    uint32_t p[BK / 16][4];  // bf16 probabilities of the previous tile
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // row max and (thread-partial) sum

    // S = Q K^T for tile t (issued, not awaited)
    auto issue_qk = [&](int t) {
      const uint32_t kb = k_addr + (t % STAGES) * Cfg::KV_BYTES;
      fence_regs(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        const uint64_t da = sw128_desc(q_addr + (kk >> 2) * Cfg::QA_BYTES + off, 16, 1024);
        const uint64_t db = sw128_desc(kb + (kk >> 2) * Cfg::KA_BYTES + off, 16, 1024);
        if constexpr (BK == 192)
          wgmma_ss_n192(s, da, db, kk > 0);
        else
          wgmma_ss_n128(s, da, db, kk > 0);
      }
      wg_commit();
    };
    // O += P V for tile t (issued, not awaited)
    auto issue_pv = [&](int t) {
      const uint32_t vb = v_addr + (t % STAGES) * Cfg::KV_BYTES;
      fence_regs(o);
      fence_regs(p);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t d = sw128_desc(vb + kk * 16 * ROW_BYTES, Cfg::KA_BYTES, 1024);
        wgmma_rs<Cfg::DP>(o, p[kk], d);
      }
      wg_commit();
    };
    // Logits past the tile's valid keys read -inf; returns log2 of the
    // tile's slot multiplicity.
    auto mask = [&](int t) {
      const bool ctx = t >= nslot;
      const int i = ctx ? 0 : t / nk;
      const int valid = ctx ? min(BK, ctx_valid - (t - nslot) * BK) : min(BK, L - (t - i * nk) * BK);
      if (valid < BK) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (8 * j + 2 * c + e >= valid) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
      }
      return ctx ? 0.f : kept_lw[i];
    };
    // The tile's row maxima of the scaled logits (scale_log2 > 0), in four
    // independent chains, then across the quad that holds a row.
    auto tile_max = [&](float& mx0, float& mx1) {
      float xa[4], xb[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) xa[k] = xb[k] = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        xa[j & 3] = fmaxf(xa[j & 3], fmaxf(s[4 * j], s[4 * j + 1]));
        xb[j & 3] = fmaxf(xb[j & 3], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(fmaxf(xa[0], xa[1]), fmaxf(xa[2], xa[3]));
      mx1 = fmaxf(fmaxf(xb[0], xb[1]), fmaxf(xb[2], xb[3]));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2)) * scale_log2;
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2)) * scale_log2;
    };
    // The weighted probabilities exp2(x * scale + nb) into s (nb = log2 w -
    // row max); returns this thread's row sums, in four chains.
    auto exps = [&](float nb0, float nb1, float& r0, float& r1) {
      float xa[4] = {0.f, 0.f, 0.f, 0.f}, xb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x0 = fmaf(s[4 * j + e], scale_log2, nb0);
          const float x1 = fmaf(s[4 * j + 2 + e], scale_log2, nb1);
          const bool fma_pipe = FMA_EXP_EVERY > 0 && j % FMA_EXP_EVERY == FMA_EXP_EVERY - 1;
          s[4 * j + e] = fma_pipe ? ex2_fma(x0) : ex2(x0);
          s[4 * j + 2 + e] = fma_pipe ? ex2_fma(x1) : ex2(x1);
          xa[j & 3] += s[4 * j + e];
          xb[j & 3] += s[4 * j + 2 + e];
        }
      r0 = (xa[0] + xa[1]) + (xa[2] + xa[3]);
      r1 = (xb[0] + xb[1]) + (xb[2] + xb[3]);
    };
    // Online softmax of tile t, exact: the row max first, then the
    // probabilities; the rescale factors of the earlier rows go to a0 / a1.
    auto softmax_exact = [&](int t, float& a0, float& a1) {
      fence_regs(s);
      const float lw = mask(t);
      float mx0, mx1, r0, r1;
      tile_max(mx0, mx1);
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = ex2(m0 - mn0);
      a1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      exps(lw - mn0, lw - mn1, r0, r1);
      l0 = l0 * a0 + r0;
      l1 = l1 * a1 + r1;
    };
    // Online softmax of tile t against the running max, so the exponentials
    // need not wait for the tile's max, nor compute it, and O needs no
    // rescale. Probabilities up to 2^8 are harmless in fp32 and bf16
    // (numerator and denominator share the max); a thread's partial row sum
    // above 2^8 (or infinite) shows a logit that outgrew the running max by
    // more than that. Returns true, leaving s spent, if this happened on some
    // row of the warpgroup (a row's first tiles, rarely later): the caller
    // then recomputes S and takes softmax_exact.
    auto softmax_fast = [&](int t) {
      fence_regs(s);
      const float lw = mask(t);
      float r0, r1;
      exps(lw - m0, lw - m1, r0, r1);
      if (wg_any(!(r0 <= 256.f && r1 <= 256.f), 3 + cw)) return true;
      l0 += r0;
      l1 += r1;
      return false;
    };
    // The probabilities of two adjacent 8-key column groups are exactly the
    // A fragment of one 16-key step of P V.
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % STAGES]);
    };

    // Ping-pong: a warpgroup issues its products only in its turn (named
    // barrier 1 + cw) and hands the turn over right after, so one warpgroup's
    // exponentials run while the other's products do. Warpgroup 0 goes first.
    const int my_turn = 1 + cw, other_turn = 2 - cw;
    if (cw == 1) bar_arrive(other_turn);
    mbar_wait(qbar, 0);

    float a0, a1;
    mbar_wait(&full[0], 0);
    bar_sync(my_turn);
    issue_qk(0);
    bar_arrive(other_turn);
    wg_wait<0>();
    softmax_exact(0, a0, a1);  // o is still zero: nothing to rescale
    pack_p();
    for (int t = 1; t < ntiles; ++t) {
      mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
      bar_sync(my_turn);
      issue_qk(t);
      issue_pv(t - 1);
      bar_arrive(other_turn);
      wg_wait<1>();  // S of tile t is ready; P V of tile t - 1 may still run
      const bool rescale = softmax_fast(t);
      if (rescale) {
        issue_qk(t);
        wg_wait<0>();
        softmax_exact(t, a0, a1);
      }
      wg_wait<0>();
      fence_regs(o);
      release(t - 1);
      if (rescale) {
#pragma unroll
        for (int j = 0; j < Cfg::DP / 8; ++j) {
          o[4 * j + 0] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
      }
      pack_p();
    }
    bar_sync(my_turn);
    issue_pv(ntiles - 1);
    if (cw == 0) bar_arrive(other_turn);  // warpgroup 1 takes the last turn
    wg_wait<0>();
    fence_regs(o);
    release(ntiles - 1);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int ts = token_stride<TM>(H, dh);
    bf16* obase = out + row_base<TM>(frame, hh, H, Lq, dh);
    const int ra = q0 + cw * 64 + warp * 16 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < Cfg::DP / 8; ++j) {
      const int col = 8 * j + 2 * c;  // dh % 8 == 0: col < dh covers col + 1
      if (col >= dh) continue;
      if (ra < Lq)
        *reinterpret_cast<uint32_t*>(obase + static_cast<size_t>(ra) * ts + col) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (rb < Lq)
        *reinterpret_cast<uint32_t*>(obase + static_cast<size_t>(rb) * ts + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so nothing links
// against the driver library.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one [.., len, ..] operand: `valid` tokens of each
// (frame, head) row are addressable (rows past it read as zeros), `len`
// sets the strides; boxes are 64 columns x `box_rows` tokens, 128-byte
// swizzled, and columns past dh read as zeros (the pad to the MMA depth).
template <bool TM>
bool encode(CUtensorMap* map, const void* base, int frames, int H, int len, int valid, int dh,
            int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0) return false;
  const cuuint64_t e = sizeof(bf16);
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], unit[4] = {1, 1, 1, 1};
  cuuint32_t rank;
  if (TM) {
    rank = 4;
    dims[0] = dh, dims[1] = H, dims[2] = valid, dims[3] = frames;
    strides[0] = e * dh, strides[1] = e * H * dh, strides[2] = e * len * H * dh;
    box[0] = ATOM, box[1] = 1, box[2] = box_rows, box[3] = 1;
  } else {
    rank = 3;
    dims[0] = dh, dims[1] = valid, dims[2] = static_cast<cuuint64_t>(frames) * H;
    strides[0] = e * dh, strides[1] = e * len * dh;
    box[0] = ATOM, box[1] = box_rows, box[2] = 1;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KS, bool TM>
int launch_hopper(const void* q, const void* k, const void* v, const void* ck, const void* cv,
                  void* out, const int* srcs, const int* mult, int B, int F, int Fk, int H,
                  int Lq, int L, int Lc, int ctx_valid, int dh, int S, float sm_scale,
                  cudaStream_t stream) {
  using Cfg = HopperCfg<KS>;
  if (S > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const int frames = B * F;  // q, out and context rows
  CUtensorMap tq, tk, tv, tck, tcv;
  bool ok = encode<TM>(&tq, q, frames, H, Lq, Lq, dh, HQ) &&
            encode<TM>(&tk, k, B * Fk, H, L, L, dh, Cfg::BK) &&
            encode<TM>(&tv, v, B * Fk, H, L, L, dh, Cfg::BK);
  if (ck != nullptr)
    ok = ok && encode<TM>(&tck, ck, frames, H, Lc, ctx_valid, dh, Cfg::BK) &&
         encode<TM>(&tcv, cv, frames, H, Lc, ctx_valid, dh, Cfg::BK);
  else
    tck = tk, tcv = tv, ctx_valid = 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vfa_hopper_kernel<KS, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Lq + HQ - 1) / HQ;
  vfa_hopper_kernel<KS, TM><<<frames * H * nq, HOPPER_THREADS, Cfg::BYTES, stream>>>(
      tq, tk, tv, tck, tcv, static_cast<bf16*>(out), srcs, mult, F, Fk, H, Lq, L, ctx_valid, dh,
      S, nq, sm_scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <bool TM>
int launch(const void* q, const void* k, const void* v, const void* ck, const void* cv, void* out,
           const int* srcs, const int* mult, int B, int F, int Fk, int H, int Lq, int L, int Lc,
           int ctx_valid, int dh, int S, float sm_scale, int is_bf16, void* stream) {
  if (dh <= 0 || dh > MAX_DH || dh % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
#define VFA_HOPPER(KS)                                                                         \
  case KS:                                                                                     \
    return launch_hopper<KS, TM>(q, k, v, ck, cv, out, srcs, mult, B, F, Fk, H, Lq, L, Lc,      \
                                 ctx_valid, dh, S, sm_scale, st);
    switch ((dh + 15) / 16) {  // 16-deep steps of Q K^T: dh padded to 16 on chip
      VFA_HOPPER(1) VFA_HOPPER(2) VFA_HOPPER(3) VFA_HOPPER(4)
      VFA_HOPPER(5) VFA_HOPPER(6) VFA_HOPPER(7) VFA_HOPPER(8)
    }
#undef VFA_HOPPER
    return (int)cudaErrorInvalidValue;
  }
  return launch_fp32<TM>(q, k, v, ck, cv, out, srcs, mult, B, F, Fk, H, Lq, L, Lc, ctx_valid, dh,
                         S, sm_scale, st);
}

}  // namespace

// K1: head-major q [B, F, H, Lq, dh], k/v [B, Fk, H, L, dh], ctx [B, F, H, Lc, dh];
// srcs/mult [F, S] index k/v's Fk frames.
extern "C" int univst_video_flash_attention(const void* q, const void* k, const void* v,
                                            const void* ctx_k, const void* ctx_v, void* out,
                                            const int* srcs, const int* mult, int B, int F,
                                            int Fk, int H, int Lq, int L, int Lc, int ctx_valid,
                                            int dh, int S, float sm_scale, int is_bf16,
                                            void* stream) {
  return launch<false>(q, k, v, ctx_k, ctx_v, out, srcs, mult, B, F, Fk, H, Lq, L, Lc, ctx_valid,
                       dh, S, sm_scale, is_bf16, stream);
}

// K2: token-major q [B, F, Lq, H, dh], k/v [B, Fk, L, H, dh], ctx [B, F, Lc, H, dh];
// srcs/mult [F, S] index k/v's Fk frames.
extern "C" int univst_video_flash_attention_tokens(const void* q, const void* k, const void* v,
                                                   const void* ctx_k, const void* ctx_v,
                                                   void* out, const int* srcs, const int* mult,
                                                   int B, int F, int Fk, int H, int Lq, int L,
                                                   int Lc, int ctx_valid, int dh, int S,
                                                   float sm_scale, int is_bf16, void* stream) {
  return launch<true>(q, k, v, ctx_k, ctx_v, out, srcs, mult, B, F, Fk, H, Lq, L, Lc, ctx_valid,
                      dh, S, sm_scale, is_bf16, stream);
}
