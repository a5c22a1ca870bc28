// GroupNorm, with an optional SiLU after it, for bf16 on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves GroupNorm to XLA, which
// fuses its statistics and affine into the neighbouring ops. The port's
// eager fp32 chain (univst_torch/models/group_norm.py::group_norm_plain)
// made about 11 launches a call and moved ~52 bytes an element (the fp32
// upcast, var_mean, the normalisation, the affine, the cast back, then the
// SiLU); this kernel moves 4-6 (x read twice, the second time partly
// from L2, and y written once).
//
// x, y: bf16 [N, HW, C] (channels-last: the layout the SD UNet and the VAEs
// run in, since their first conv takes a permuted input and every later op
// keeps its strides) with N = videos * F frames; G groups of Cg = C / G
// channels. Statistics are taken per (video, group) over (F, HW, Cg) (F =
// num_frames for the SD UNet's frame-spanning norms, F = 1 per frame). Then
// y = (x - mean) * rsqrt(var + eps) * w[c] + b[c], optionally y *
// sigmoid(y), in fp32, rounded once to bf16. w, b: [C], bf16 or fp32.
//
// What bounds it on an H100 SXM: bytes (3.35 TB/s); a few fp32 operations an
// element against ~295 the tensor cores would need per byte. At the main
// shape, the SD-1.5 UNet's first resnet norm [32, 320, 64, 64] with F = 16
// (two videos, 64 groups of 655,360 elements, 84 MB), reading x once and
// writing y once is 168 MB, 0.050 ms.
//
// A video's F * HW rows of C channels are contiguous, and group g is the
// column band [g * Cg, (g + 1) * Cg). A block of T = (512 / (C / 8)) * (C / 8)
// threads reads whole rows with 16-byte loads: thread t always holds the
// same 8 channels (t % (C / 8)), of at most two groups, and Rb = T / (C / 8)
// rows at a time, so its scale and shift are loaded once. Each video's rows
// are cut into slices, so that videos x slices blocks fill the SMs. Two
// launches: pass 1 writes a (mean, M2) partial for each (slice, group);
// pass 2 combines a video's partials in a fixed order (Chan's formula) and
// normalises a slice, walking the slices in reverse of pass 1 so that the
// tail pass 1 left in the 50 MB L2 is read first. Moments are Welford's
// (count, mean, M2), merged by Chan's formula per batch of loads and then in
// fixed orders: no atomics, so the output is the same bit for bit from run
// to run. Each thread keeps 2 loads in flight, and two 512-thread blocks fit
// an SM.
//
// C entry point (ctypes), returning cudaGetLastError() after its launches:
// univst_group_norm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 2;  // loads in flight a thread (64 registers: two blocks an SM)

using bf16 = __nv_bfloat16;

// Welford moments of `n` elements: mean and the sum of squared deviations.
struct Moments {
  float n, mean, m2;
};

// Chan's merge of two sets of moments.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n, d = b.mean - a.mean, r = b.n / n;
  return {n, fmaf(d, r, a.mean), a.m2 + b.m2 + d * d * a.n * r};
}

// 8 bf16 elements moved as one 16-byte access.
struct Pack8 {
  static __device__ __forceinline__ uint4 load(const bf16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

__device__ __forceinline__ float param(const void* p, int c, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const bf16*>(p)[c])
                 : static_cast<const float*>(p)[c];
}

constexpr int kMaxGroups = 128;

struct RowGeometry {
  int C, G, Cg;  // channels, groups, channels a group
  int vpr, Rb;   // vectors a row (C / 8), rows a block reads at once (blockDim / vpr)
  int RV;        // rows a video (frames * HW)
  int S, chunk;  // slices a video, rows a slice
};

// Thread t's channel vector: its first channel, and how many of its 8
// channels lie in the first of its groups.
__device__ __forceinline__ void row_lane(const RowGeometry& g, int& c0, int& ga, int& split) {
  c0 = (threadIdx.x % g.vpr) * 8;
  ga = c0 / g.Cg;
  split = min(8, (ga + 1) * g.Cg - c0);
}

__global__ void __launch_bounds__(kThreads, 2) group_norm_rows_stats_kernel(
    const bf16* __restrict__ x, float2* __restrict__ part, RowGeometry g) {
  __shared__ Moments lane_m[2][kThreads];
  const int v = blockIdx.x / g.S, s = blockIdx.x - v * g.S;
  int c0, ga, split;
  row_lane(g, c0, ga, split);
  const int r0 = s * g.chunk, r1 = min(r0 + g.chunk, g.RV);
  const bf16* base = x + (long long)v * g.RV * g.C + c0;
  Moments ma{0.f, 0.f, 0.f}, mb{0.f, 0.f, 0.f};
  for (int r = r0 + (int)threadIdx.x / g.vpr; r < r1; r += g.Rb * kUnroll) {
    uint4 raw[kUnroll];
    int valid = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * g.Rb < r1) {
        raw[u] = Pack8::load(base + (long long)(r + u * g.Rb) * g.C);
        valid = u + 1;
      }
    }
    float val[kUnroll][8];
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < valid) {
        Pack8::unpack(raw[u], val[u]);
#pragma unroll
        for (int i = 0; i < 8; ++i) (i < split ? sa : sb) += val[u][i];
      }
    }
    const float na = (float)(valid * split), nb = (float)(valid * (8 - split));
    const float mean_a = sa / na, mean_b = nb > 0.f ? sb / nb : 0.f;
    float qa = 0.f, qb = 0.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (u < valid) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = val[u][i] - (i < split ? mean_a : mean_b);
          if (i < split) qa = fmaf(d, d, qa);
          else qb = fmaf(d, d, qb);
        }
      }
    }
    ma = merge(ma, Moments{na, mean_a, qa});
    mb = merge(mb, Moments{nb, mean_b, qb});
  }
  lane_m[0][threadIdx.x] = ma;
  lane_m[1][threadIdx.x] = mb;
  __syncthreads();
  // one thread a group merges the lanes that hold its channels, row by row
  for (int gg = threadIdx.x; gg < g.G; gg += blockDim.x) {
    const int lo = gg * g.Cg / 8, hi = ((gg + 1) * g.Cg - 1) / 8;
    Moments acc{0.f, 0.f, 0.f};
    for (int ro = 0; ro < g.Rb; ++ro) {
      for (int cv = lo; cv <= hi; ++cv) {
        acc = merge(acc, lane_m[(cv * 8) / g.Cg == gg ? 0 : 1][ro * g.vpr + cv]);
      }
    }
    part[(long long)blockIdx.x * g.G + gg] = make_float2(acc.mean, acc.m2);
  }
}

__global__ void __launch_bounds__(kThreads, 2) group_norm_rows_apply_kernel(
    const bf16* __restrict__ x, bf16* __restrict__ y, const float2* __restrict__ part,
    const void* w, const void* b, RowGeometry g, float eps, int silu, int w_bf16) {
  __shared__ Moments stage[kThreads];
  __shared__ float mean_g[kMaxGroups], rstd_g[kMaxGroups];
  const int bid = gridDim.x - 1 - blockIdx.x;
  const int v = bid / g.S, s = bid - v * g.S;
  // the video's partials: thread t merges group t % G's slices t / G, + P,
  // ...; then one thread a group merges those P results in order
  const int P = blockDim.x / g.G;
  if ((int)threadIdx.x < P * g.G) {
    const int gg = threadIdx.x % g.G;
    Moments acc{0.f, 0.f, 0.f};
    for (int i0 = threadIdx.x / g.G; i0 < g.S; i0 += P * 8) {
      float2 pv[8];  // eight loads in flight, then their merges in order
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (i0 + k * P < g.S) pv[k] = part[((long long)v * g.S + i0 + k * P) * g.G + gg];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * P;
        if (i < g.S) {
          acc = merge(acc, Moments{(float)(min(g.chunk, g.RV - i * g.chunk) * g.Cg), pv[k].x,
                                   pv[k].y});
        }
      }
    }
    stage[threadIdx.x] = acc;
  }
  __syncthreads();
  if ((int)threadIdx.x < g.G) {
    Moments acc{0.f, 0.f, 0.f};
    for (int p = 0; p < P; ++p) acc = merge(acc, stage[p * g.G + threadIdx.x]);
    mean_g[threadIdx.x] = acc.mean;
    rstd_g[threadIdx.x] = rsqrtf(acc.m2 / acc.n + eps);
  }
  __syncthreads();
  int c0, ga, split;
  row_lane(g, c0, ga, split);
  float mu[8], a[8], sh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = i < split ? ga : ga + 1;
    mu[i] = mean_g[gi];
    a[i] = rstd_g[gi] * param(w, c0 + i, w_bf16);
    sh[i] = param(b, c0 + i, w_bf16);
  }
  const int r0 = s * g.chunk, r1 = min(r0 + g.chunk, g.RV);
  const long long base = (long long)v * g.RV * g.C + c0;
  for (int r = r0 + (int)threadIdx.x / g.vpr; r < r1; r += g.Rb * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * g.Rb < r1) raw[u] = Pack8::load(x + base + (long long)(r + u * g.Rb) * g.C);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (r + u * g.Rb < r1) {
        float val[8];
        Pack8::unpack(raw[u], val);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          val[i] = fmaf(val[i] - mu[i], a[i], sh[i]);
          if (silu) val[i] = __fdividef(val[i], 1.f + __expf(-val[i]));
        }
        Pack8::store(y + base + (long long)(r + u * g.Rb) * g.C, val);
      }
    }
  }
}

}  // namespace

// x, y: bf16 [N, HW, C] (C % 8 == 0, C <= 4096, G <= 128, each 8 channels
// from a multiple of 8 within two groups, x and y 16-byte aligned); w, b:
// [C] (bf16 if w_bf16, else fp32); statistics over `frames` consecutive
// frames a group; `slices` slices of `chunk` rows a video, and `part` holds
// 2 floats a slice and group.
extern "C" int univst_group_norm(const void* x, void* y, const void* w, const void* b, void* part,
                                 int N, int C, int HW, int G, int frames, int slices, int chunk,
                                 float eps, int silu, int w_bf16, int device, void* stream) {
  int current = -1;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  RowGeometry g;
  g.C = C;
  g.G = G;
  g.Cg = C / G;
  g.vpr = C / 8;
  g.Rb = kThreads / g.vpr;
  g.RV = frames * HW;
  g.S = slices;
  g.chunk = chunk;
  const int threads = g.Rb * g.vpr, blocks = N / frames * slices;
  const bool ok = C % 8 == 0 && g.vpr <= kThreads && G <= kMaxGroups && slices > 0 &&
                  ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  int err;
  if (!ok) {
    err = (int)cudaErrorInvalidValue;
  } else {
    auto st = static_cast<cudaStream_t>(stream);
    group_norm_rows_stats_kernel<<<blocks, threads, 0, st>>>(static_cast<const bf16*>(x),
                                                            static_cast<float2*>(part), g);
    group_norm_rows_apply_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), static_cast<const float2*>(part), w,
        b, g, eps, silu, w_bf16);
    err = (int)cudaGetLastError();
  }
  if (current != device && current >= 0) cudaSetDevice(current);
  return err;
}
