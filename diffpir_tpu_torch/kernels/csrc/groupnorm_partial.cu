// The sharded GroupNorm's partial statistics, NHWC, for Hopper (sm_90a).
//
// Replaces, for an image whose rows are spread over several ranks (spatial
// parallelism), the statistics half of the TPU kernel
// diffpir_tpu/pallas/groupnorm.py::groupnorm_silu: per (sample, group) the
// unfinished statistics of this shard's pixels, three fp32 each,
//   bf16: (sum x, sum x^2, n)     fp32: (n, mean, M2), M2 centred,
// which the caller gathers over the ranks and merges in rank order
// (kernels/groupnorm.py::merge_partial_stats) before the apply launch.
//
// Bound on this card: memory, one read of the tensor over 3.35 TB/s.  The
// shards of the port's models are 0.1-50 MB: most of them are too small to
// fill the card, so one launch's latency and the reduction after the loads
// set their time; the large ones, read from L2 as a UNet's activations
// mostly are, need every SM reading.
//
// Design: no block waits on another through global memory (no ticket, no
// fence, no atomics: a fixed order of every sum, so reruns are
// bit-identical).
//   * Channel chunks: K chunks of whole groups, a block each, so that a
//     small layer at batch 4 still gives 32 blocks.
//   * Each block reads its pixels with 16-byte vectors (8 bf16 or 4 fp32
//     channels) of a fixed channel column, eight in flight a thread (the last
//     batch predicated), sums per channel in registers (fp32: x - shift, the
//     first pixel being the shift), reduces its rows in shared memory in two
//     fixed-order stages, and joins each group's channels in a warp's
//     shuffle tree (fp32 by Chan's formula).
//   * Where one block a (sample, chunk) is too little for the card, M pixel
//     segments of a (sample, chunk) write their pairs to a workspace, and a
//     programmatic dependent launch (gn_partial_merge) joins them in the same
//     tree.
// The wrapper (kernels/groupnorm.py::partial_plan) picks K, M and the pixel
// rows per shape from sweeps on the H100 (scripts/gn_partial_probe.py).
//
// Built with -DDIFFPIR_GN_STAMPS, thread 0 of every block records the global
// timer at three points (start, loads done, block reduced) and its SM's id
// into g_stamps, four a block in (sample, chunk, segment) order, which
// scripts/gn_partial_probe.py builds and reads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxGroups = 64;
constexpr int kMaxThreads = 512;
constexpr int kMaxC = 2048;
constexpr int kInFlight = 8;  // 16-byte vectors a thread has in flight
// the most dynamic shared memory a launch takes for its row sums:
// 2 * (R + J) * C floats with R * C <= 512 * 8 and J * C <= 2048
constexpr size_t kMaxSmem = sizeof(float) * 2 * (kMaxThreads * 8 + kMaxC);

#ifdef DIFFPIR_GN_STAMPS
constexpr int kStamps = 4;
constexpr int kMaxStampBlocks = 4096;
__device__ unsigned long long g_stamps[kMaxStampBlocks * kStamps];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x != 0) return;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  if (blk >= kMaxStampBlocks) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamps[blk * kStamps + k] = t;
  if (k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[blk * kStamps + 3] = sm;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ __forceinline__ void unpack(const Raw& u, float (&f)[N]) {
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  static __device__ __forceinline__ float scalar(const float* p) { return *p; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw& u, float (&f)[N]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// (n, mean, M2) of two disjoint sets -> of their union (Chan et al.); the
// fast division keeps the IEEE division's subroutine, and its spills, out
// of the kernel
__device__ __forceinline__ void chan_merge(float& n, float& mu, float& m2, float nb,
                                           float mub, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb; mu = mub; m2 = m2b;
    return;
  }
  const float nt = n + nb, d = mub - mu, w = __fdividef(nb, nt);
  mu = fmaf(d, w, mu);
  m2 = m2 + m2b + d * d * (n * w);
  n = nt;
}

// (n, mean, M2) or (sum x, sum x^2) of one group from lanes 0..31 of a warp,
// joined in a fixed tree (lane l with lane l + o, o = 16, 8, 4, 2, 1): the
// result in lane 0
template <bool kCentred>
__device__ __forceinline__ void warp_join(float& n, float& u1, float& u2) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, o);
    const float b1 = __shfl_down_sync(0xffffffffu, u1, o);
    const float b2 = __shfl_down_sync(0xffffffffu, u2, o);
    if (kCentred) {
      chan_merge(n, u1, u2, nb, b1, b2);
    } else {
      u1 += b1;
      u2 += b2;
    }
  }
}

// the count, pixels times channels of a group, of segment l of HW pixels
// cut into segments of `seg`
__device__ __forceinline__ float segment_count(int HW, int seg, int l, int cg) {
  const int a = min(HW, l * seg);
  return (float)(min(HW, a + seg) - a) * (float)cg;
}

// (a, b) of one group of a (sample, chunk) -> its three output floats
template <bool kCentred>
__device__ __forceinline__ void write_stats(float* o, float n_all, float u1, float u2) {
  o[0] = kCentred ? n_all : u1;
  o[1] = kCentred ? u1 : u2;
  o[2] = kCentred ? u2 : n_all;
}

// Grid (K * M, B): block (k * M + m, b) reads segment m of sample b's pixels
// (segments of `seg` pixels), channels [k*Cc, (k+1)*Cc) (Gc = G/K whole
// groups).  With one segment it writes the output; with M > 1 it writes the
// segment's pair per group to ws[b][k][m][g] for gn_partial_merge.  Thread i <
// NV * R (NV = Cc / Vec::N) reads vector column i % NV of pixel rows i / NV,
// R rows in all; blockDim is NV * R rounded up to whole warps.  Dynamic
// shared memory 2 * (R + J) * Cc floats of row sums, J = max(1, min(R,
// blockDim / Cc)).
// (one block an SM in the bounds: without it ptxas holds fp32's kernel to 64
// registers and spills)
template <typename T, bool kCentred>
__global__ void __launch_bounds__(kMaxThreads, 1)
gn_partial(const T* __restrict__ x, float* __restrict__ out, float2* __restrict__ ws,
           int HW, int C, int G, int Cc, int M, int seg, int R) {
  using V_ = Vec<T>;
  constexpr int V = V_::N;
  using Raw = typename V_::Raw;
  extern __shared__ __align__(16) float sm[];
  stamp(0);

  // a merge launch that follows may start and wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.y, k = blockIdx.x / M, m = blockIdx.x % M;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int NV = Cc / V, v = tid % NV, r = tid / NV;
  const bool active = r < R;  // a thread of the last warp's padding reads nothing
  const int J = max(1, min(R, nthr / Cc));
  const int cg_ = C / G, Gc = Cc / cg_;
  float* sm1 = sm;                  // [R][Cc]
  float* sm2 = sm + R * Cc;         // [R][Cc]
  float* q1 = sm + 2 * R * Cc;      // [J][Cc]
  float* q2 = q1 + J * Cc;          // [J][Cc]
  const int p0 = min(HW, m * seg), p1 = min(HW, p0 + seg), np = p1 - p0;
  const T* xb = x + (size_t)b * HW * C + (size_t)k * Cc;

  float sh[V], a1[V], a2[V];
#pragma unroll
  for (int e = 0; e < V; ++e) sh[e] = a1[e] = a2[e] = 0.f;
  if (kCentred && np > 0 && active)
    V_::unpack(*reinterpret_cast<const Raw*>(xb + (size_t)p0 * C + v * V), sh);

  auto add = [&](const Raw& u) {
    float f[V];
    V_::unpack(u, f);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = f[e] - sh[e];
      a1[e] += d;
      a2[e] = fmaf(d, d, a2[e]);
    }
  };
  // the thread's pixels p0 + r, p0 + r + R, ...: kInFlight 16-byte vectors
  // in flight, the last batch predicated
  const size_t pstride = (size_t)C / V;  // Raw vectors per pixel
  const Raw* xp = reinterpret_cast<const Raw*>(xb + v * V);
  for (int p = active ? p0 + r : p1; p < p1; p += kInFlight * R) {
    Raw u[kInFlight];
#pragma unroll
    for (int i = 0; i < kInFlight; ++i)
      if (p + i * R < p1) u[i] = __ldg(xp + (size_t)(p + i * R) * pstride);
#pragma unroll
    for (int i = 0; i < kInFlight; ++i)
      if (p + i * R < p1) add(u[i]);
  }
  if (active) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sm1[r * Cc + v * V + e] = a1[e];
      sm2[r * Cc + v * V + e] = a2[e];
    }
  }
  __syncthreads();
  stamp(1);

  // rows -> J parts per channel: part j adds rows j, j + J, ... in order
  for (int i = tid; i < J * Cc; i += nthr) {
    const int c = i % Cc, j = i / Cc;
    float t1 = 0.f, t2 = 0.f;
    for (int q = j; q < R; q += J) {
      t1 += sm1[q * Cc + c];
      t2 += sm2[q * Cc + c];
    }
    q1[i] = t1;
    q2[i] = t2;
  }
  __syncthreads();

  // one warp a group: lane l takes channels l, l + 32, ... of the group (its
  // parts in order; fp32 turns the shifted sums into the channel's mean and
  // centred M2 over the segment), then the lanes join in warp_join's tree (fp32
  // by Chan's formula, each channel counting np pixels)
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
  const float fnp = (float)np;
  for (int g = warp; g < Gc; g += nwarps) {
    float n = 0.f, u1 = 0.f, u2 = 0.f;
    for (int j0 = lane; j0 < cg_; j0 += 32) {
      const int c = g * cg_ + j0;
      float t1 = 0.f, t2 = 0.f;
      for (int j = 0; j < J; ++j) {
        t1 += q1[j * Cc + c];
        t2 += q2[j * Cc + c];
      }
      if (kCentred) {
        if (np > 0) {
          const float shift = V_::scalar(xb + (size_t)p0 * C + c), m = __fdividef(t1, fnp);
          chan_merge(n, u1, u2, fnp, shift + m, fmaxf(t2 - t1 * m, 0.f));
        }
      } else {
        u1 += t1;
        u2 += t2;
      }
    }
    warp_join<kCentred>(n, u1, u2);
    if (lane == 0) {
      if (M > 1)
        ws[((size_t)(b * gridDim.x) + blockIdx.x) * Gc + g] = make_float2(u1, u2);
      else
        write_stats<kCentred>(out + 3 * ((size_t)b * G + k * Gc + g),
                              (float)HW * (float)cg_, u1, u2);
    }
  }
  stamp(2);
}

// Grid (K, B): the M segments' pairs of (sample b, chunk k) joined per group,
// lane l of a warp holding segment l, in warp_join's tree.  A programmatic
// dependent of gn_partial: it waits for that grid before it reads ws.
template <bool kCentred>
__global__ void gn_partial_merge(const float2* __restrict__ ws, float* __restrict__ out,
                                 int HW, int G, int Gc, int cg, int M, int seg) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int k = blockIdx.x, K = gridDim.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int g = warp; g < Gc; g += nwarps) {
    float n = 0.f, u1 = 0.f, u2 = 0.f;
    if (lane < M) {
      const float2 pk = __ldcg(ws + ((size_t)(b * K + k) * M + lane) * Gc + g);
      u1 = pk.x;
      u2 = pk.y;
      n = segment_count(HW, seg, lane, cg);
    }
    warp_join<kCentred>(n, u1, u2);
    if (lane == 0)
      write_stats<kCentred>(out + 3 * ((size_t)b * G + k * Gc + g), (float)HW * (float)cg,
                            u1, u2);
  }
}

template <typename T, bool kCentred>
cudaError_t launch(const T* x, float* out, float2* ws, int B, int HW, int C, int G, int K,
                   int M, int R, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  const int Cc = C / K;
  const int threads = ((Cc / V) * R + 31) / 32 * 32;
  const int J = std::max(1, std::min(R, threads / Cc));
  const size_t smem = sizeof(float) * 2 * (size_t)(R + J) * Cc;
  auto kern = gn_partial<T, kCentred>;
  // set once per instantiation: shared memory past the 48 KB default
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr != cudaSuccess) return attr;
  const int seg = (HW + M - 1) / M;
  kern<<<dim3(K * M, B), threads, smem, st>>>(x, out, ws, HW, C, G, Cc, M, seg, R);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || M == 1) return e;
  // the segments' merge, launched as a programmatic dependent
  const int Gc = G / K;
  cudaLaunchConfig_t mcfg = {};
  mcfg.gridDim = dim3(K, B);
  mcfg.blockDim = dim3(32 * std::min(Gc, 32));
  mcfg.stream = st;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  mcfg.attrs = pdl;
  mcfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&mcfg, gn_partial_merge<kCentred>, (const float2*)ws, out, HW, G,
                         Gc, C / G, M, seg);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// partial receives 3*B*G floats, per (sample, group) bf16 (sum x, sum x^2, n)
// or fp32 (n, mean, M2) of this tensor's pixels.  K channel chunks of whole
// groups (each a multiple of the vector); M segments of the pixels (1..32),
// one block each; R pixel rows a block: (C / K / vector) * R <= 512 threads.
// With M > 1 the workspace holds 2 * B * K * M * (G / K) floats and a second
// launch merges the segments.  x 16-byte aligned; C a multiple of 8 (bf16) or
// 4 (fp32).  Returns a cudaError_t.
extern "C" int diffpir_groupnorm_partial_stats(const void* x, void* partial,
                                               void* workspace, int B, int HW, int C, int G,
                                               int K, int M, int rows, int is_bf16,
                                               void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const int Cc = K > 0 ? C / K : 0;
  const int threads = K > 0 ? (Cc / vec * rows + 31) / 32 * 32 : 0;
  if (B <= 0 || B > 65535 || HW <= 0 || G <= 0 || G > kMaxGroups || C % G != 0 ||
      C > kMaxC || K <= 0 || G % K != 0 || Cc % vec != 0 || rows <= 0 ||
      threads > kMaxThreads || M <= 0 || M > 32 || (M > 1 && workspace == nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(partial);
  float2* ws = static_cast<float2*>(workspace);
  if (is_bf16)
    return (int)launch<__nv_bfloat16, false>(static_cast<const __nv_bfloat16*>(x), out, ws,
                                             B, HW, C, G, K, M, rows, st);
  return (int)launch<float, true>(static_cast<const float*>(x), out, ws, B, HW, C, G, K, M,
                                  rows, st);
}
