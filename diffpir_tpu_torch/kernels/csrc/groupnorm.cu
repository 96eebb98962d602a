// GroupNorm (fp32 statistics) + optional FiLM + optional SiLU, NHWC, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel diffpir_tpu/pallas/groupnorm.py::groupnorm_silu.
// The math follows GroupNorm32's XLA path (diffpir_tpu/models/unet.py:83-131),
// not the Pallas kernel's: fp32 inputs take a centred variance, bf16 inputs
// the one-pass E[x^2] - mean^2 clamped at 0.  The affine step, FiLM
// y*(1+fs)+fb and SiLU are folded into one multiply-add per element:
//   w = rstd*scale, off = bias - mean*w;  with FiLM w *= 1+fs, off = off*(1+fs)+fb.
//
// Bound on this card: memory.  The least the function moves is one read and
// one write of the tensor, (2 * B*H*W*C * itemsize) bytes over 3.35 TB/s.
// This design reads the input twice and writes it once, so it can reach
// about two thirds of that bound on tensors larger than the 50 MB L2; below
// that the second read comes from L2, and at the UNet's smaller layers the
// two launches' latency sets the time.
//
// Design: two launches per call, in both types.
//   1. gn_stats, grid (slice, sample): each thread reads 16-byte vectors
//      (8 bf16 or 4 fp32 channels) of a fixed channel column and strides the
//      pixels of the slice, so it keeps per-channel partial sums in
//      registers.  The block reduces them over its rows in shared memory in
//      a fixed order and writes one (a, b) pair per group:
//        bf16: (sum x, sum x^2);
//        fp32: (mean, M2) of the block's own pixels, centred: sums of
//              x - shift, with the slice's first pixel as the shift, give
//              each channel's mean and M2, and the channels of a group are
//              merged exactly.
//      The last block of a sample to finish (a __threadfence, then an atomic
//      ticket on a per-sample counter that this block resets to 0) merges the
//      slices in a fixed order with all its threads: thread i takes group
//      i % G and slices i / G, i / G + blockDim/G, ... (eight loads in
//      flight), then one thread per group joins those partial results in
//      order; fp32 merges with Chan's parallel formula, so no second read of
//      the input is needed for the centred variance.  It writes (mean, rstd)
//      per group.  No floating-point atomics: reruns are bit-identical.
//   2. gn_apply, a programmatic dependent launch (PDL) of gn_stats: its
//      blocks start once every gn_stats block runs and load their first
//      pixels (16-byte vectors), and only then wait for gn_stats' grid, so
//      the second launch's latency and its first loads overlap the
//      statistics.  Each block folds the statistics with scale, bias and
//      FiLM into (w, off) per channel in shared memory; each thread keeps
//      those of its fixed channel column in registers and writes x*w + off
//      [then SiLU] over a grid-stride loop; there is no division or modulo
//      per element.
// Channels per group (C/32) is 3..24 on the port's models and is not assumed
// to be a power of two; a vector may span several groups.
//
// Split at that seam for an image whose rows are spread over several ranks
// (spatial parallelism): the shard's unfinished statistics come from a kernel
// of their own (groupnorm_partial.cu), and diffpir_groupnorm_apply_stats is
// gn_apply from a given (mean, rstd).  The caller gathers the shards' partial
// results and merges them in rank order between the two
// (kernels/groupnorm.py), so reruns stay bit-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroups = 64;
constexpr int kApplyPixels = 4;    // pixels per thread and item in gn_apply
constexpr int kApplyBlocks = 1056;  // gn_apply blocks, about 8 per SM

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&f)[N]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  static __device__ __forceinline__ float scalar(const float* p) { return *p; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[N]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// (n, mean, M2) of two disjoint sets -> of their union (Chan et al.)
__device__ __forceinline__ void chan_merge(float& n, float& mu, float& m2, float nb,
                                           float mub, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb; mu = mub; m2 = m2b;
    return;
  }
  const float nt = n + nb, d = mub - mu;
  mu = fmaf(d, nb / nt, mu);
  m2 = m2 + m2b + d * d * (n * nb / nt);
  n = nt;
}

// One launch: per-slice statistics, then (by the last slice block of each
// sample) the per-sample merge into (mean, rstd) per group.  blockDim = NV * R,
// NV = C / Vec::N; dynamic shared memory 2 * R * C floats.
template <typename T, bool kCentred>
__global__ void gn_stats(const T* __restrict__ x, int HW, int C, int G, int S,
                         int slice, int R, float eps, float2* __restrict__ part,
                         float2* __restrict__ stats, int* __restrict__ counters) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float sm[];  // [2][R][C]
  __shared__ int s_last;
  float* sm1 = sm;
  float* sm2 = sm + R * C;

  // let gn_apply's blocks launch and prefetch as soon as every block here
  // is running; they wait for this grid's results before reading them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int NV = C / V, v = tid % NV, r = tid / NV;
  const int p0 = s * slice, p1 = min(HW, p0 + slice), np = p1 - p0;
  const int cg = C / G;
  const T* xb = x + (size_t)b * HW * C;

  float sh[V], a1[V], a2[V];
  if (kCentred) {
    Vec<T>::load(xb + (size_t)p0 * C + v * V, sh);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) sh[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) a1[e] = a2[e] = 0.f;

  auto add = [&](const float (&f)[V]) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float d = f[e] - sh[e];
      a1[e] += d;
      a2[e] = fmaf(d, d, a2[e]);
    }
  };
  const T* xp = xb + v * V;
  int p = p0 + r;
  for (; p + 3 * R < p1; p += 4 * R) {  // four loads in flight
    float f0[V], f1[V], f2[V], f3[V];
    Vec<T>::load(xp + (size_t)p * C, f0);
    Vec<T>::load(xp + (size_t)(p + R) * C, f1);
    Vec<T>::load(xp + (size_t)(p + 2 * R) * C, f2);
    Vec<T>::load(xp + (size_t)(p + 3 * R) * C, f3);
    add(f0);
    add(f1);
    add(f2);
    add(f3);
  }
  for (; p < p1; p += R) {
    float f0[V];
    Vec<T>::load(xp + (size_t)p * C, f0);
    add(f0);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    sm1[r * C + v * V + e] = a1[e];
    sm2[r * C + v * V + e] = a2[e];
  }
  __syncthreads();

  // per channel: add the rows in order; fp32 turns the shifted sums into
  // the channel's mean and centred M2 over the slice
  const float fnp = (float)np;
  for (int c = tid; c < C; c += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int k = 0; k < R; ++k) {
      t1 += sm1[k * C + c];
      t2 += sm2[k * C + c];
    }
    if (kCentred) {
      const float shift = Vec<T>::scalar(xb + (size_t)p0 * C + c);
      sm1[c] = shift + t1 / fnp;
      sm2[c] = fmaxf(t2 - t1 * (t1 / fnp), 0.f);
    } else {
      sm1[c] = t1;
      sm2[c] = t2;
    }
  }
  __syncthreads();

  // per group: join its channels (equal counts, so the merge is exact)
  for (int g = tid; g < G; g += blockDim.x) {
    float u1 = 0.f, u2 = 0.f;
    for (int j = 0; j < cg; ++j) u1 += sm1[g * cg + j];
    if (kCentred) {
      const float mg = u1 / (float)cg;
      for (int j = 0; j < cg; ++j) {
        const float d = sm1[g * cg + j] - mg;
        u2 += sm2[g * cg + j] + fnp * d * d;
      }
      u1 = mg;
    } else {
      for (int j = 0; j < cg; ++j) u2 += sm2[g * cg + j];
    }
    part[((size_t)b * S + s) * G + g] = make_float2(u1, u2);
    __threadfence();
  }

  // last block of this sample to finish does the rest
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[b], 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // F = per * G threads: thread i takes group i % G and, in order, slices
  // i / G, i / G + per, ...  (up to eight loads in flight); then one thread
  // per group joins its per partial results in order.
  const int per = blockDim.x / G, F = per * G;
  float* sn = sm;  // reuse: 3 * F floats <= 2 * R * C
  float* s1 = sm + F;
  float* s2 = sm + 2 * F;
  if (tid < F) {
    const int g = tid % G;
    float n = 0.f, u1 = 0.f, u2 = 0.f;
    for (int k0 = tid / G; k0 < S; k0 += 8 * per) {
      float2 pk[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + j * per;
        if (k < S) pk[j] = __ldcg(part + ((size_t)b * S + k) * G + g);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + j * per;
        if (k >= S) break;
        if (kCentred) {
          const float nk = (float)(min(HW, (k + 1) * slice) - k * slice) * (float)cg;
          chan_merge(n, u1, u2, nk, pk[j].x, pk[j].y);
        } else {
          u1 += pk[j].x;
          u2 += pk[j].y;
        }
      }
    }
    sn[tid] = n;
    s1[tid] = u1;
    s2[tid] = u2;
  }
  __syncthreads();
  if (tid < G) {
    float n = 0.f, u1 = 0.f, u2 = 0.f;
    for (int i = tid; i < F; i += G) {
      if (kCentred) {
        chan_merge(n, u1, u2, sn[i], s1[i], s2[i]);
      } else {
        u1 += s1[i];
        u2 += s2[i];
      }
    }
    const float n_all = (float)HW * (float)cg;
    float mean, var;
    if (kCentred) {
      mean = u1;
      var = u2 / n_all;
    } else {
      mean = u1 / n_all;
      var = fmaxf(u2 / n_all - mean * mean, 0.f);
    }
    stats[(size_t)b * G + tid] = make_float2(mean, rsqrtf(var + eps));
  }
  if (tid == 0) counters[b] = 0;
}

// blockDim = NV * R; dynamic shared memory C float2.  An item is
// kApplyPixels*R consecutive pixels; block x takes items x, x + gridDim.x, ...
// Launched as a programmatic dependent of gn_stats, a block loads its first
// item before it waits for gn_stats' grid.
template <typename T>
__global__ void gn_apply(const T* __restrict__ x, T* __restrict__ out,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         const float* __restrict__ fs, const float* __restrict__ fb,
                         const float2* __restrict__ stats, int HW, int C, int G, int R,
                         int silu) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float2 swo[];  // (w, off) per channel of this sample
  const int b = blockIdx.y, tid = threadIdx.x;
  const int NV = C / V, v = tid % NV, r = tid / NV;
  const int c0 = v * V;
  const T* xb = x + (size_t)b * HW * C + c0;
  T* ob = out + (size_t)b * HW * C + c0;
  const int chunk = kApplyPixels * R;
  const int items = (HW + chunk - 1) / chunk;

  float f[kApplyPixels][V];
  int pix[kApplyPixels];
  auto load_item = [&](int q) {
#pragma unroll
    for (int k = 0; k < kApplyPixels; ++k) {
      const int p = q * chunk + r + k * R;
      pix[k] = p < HW ? p : -1;
      if (p < HW) Vec<T>::load(xb + (size_t)p * C, f[k]);
    }
  };
  int q = blockIdx.x;
  if (q < items) load_item(q);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // w = rstd*scale, off = bias - mean*w; with FiLM w *= 1+fs, off = off*(1+fs)+fb
  const int cg = C / G;
  for (int c = tid; c < C; c += blockDim.x) {
    const float2 st = __ldcg(stats + (size_t)b * G + c / cg);
    float w = st.y * scale[c];
    float off = bias[c] - st.x * w;
    if (fs != nullptr) {
      const float f1 = 1.f + fs[(size_t)b * C + c];
      w *= f1;
      off = off * f1 + fb[(size_t)b * C + c];
    }
    swo[c] = make_float2(w, off);
  }
  __syncthreads();
  float w[V], off[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    w[e] = swo[c0 + e].x;
    off[e] = swo[c0 + e].y;
  }

  for (; q < items; q += gridDim.x) {
    if (q != blockIdx.x) load_item(q);
#pragma unroll
    for (int k = 0; k < kApplyPixels; ++k) {
      if (pix[k] < 0) continue;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float y = fmaf(f[k][e], w[e], off[e]);
        if (silu) y = __fdividef(y, 1.f + __expf(-y));
        f[k][e] = y;
      }
      Vec<T>::store(ob + (size_t)pix[k] * C, f[k]);
    }
  }
}

template <typename T>
cudaError_t run(const T* x, T* out, const float* scale, const float* bias,
                const float* fs, const float* fb, float* ws, int* counters, int B,
                int HW, int C, int G, int S, int slice, int R, float eps, int silu,
                cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  float2* part = reinterpret_cast<float2*>(ws);
  float2* stats = part + (size_t)B * S * G;
  const int threads = (C / V) * R;
  const size_t smem = 2 * sizeof(float) * (size_t)R * C;
  gn_stats<T, sizeof(T) == 4><<<dim3(S, B), threads, smem, st>>>(
      x, HW, C, G, S, slice, R, eps, part, stats, counters);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int chunk = kApplyPixels * R;
  const int items = (HW + chunk - 1) / chunk;
  const int per_sample = (kApplyBlocks + B - 1) / B;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items < per_sample ? items : per_sample, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = sizeof(float2) * (size_t)C;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, gn_apply<T>, x, out, scale, bias, fs, fb,
                         (const float2*)stats, HW, C, G, R, silu);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// Workspace: 2*B*S*G + 2*B*G floats; counters: B ints, zero on entry and on
// return.  x and out 16-byte aligned; C a multiple of 8 (bf16) or 4 (fp32);
// rows * C/vector <= 1024 threads; slices of `slice` pixels, none empty.
// Returns a cudaError_t.
extern "C" int diffpir_groupnorm_silu(const void* x, void* out,
                                      const void* scale, const void* bias,
                                      const void* film_scale,
                                      const void* film_shift, void* workspace,
                                      void* counters, int B, int HW, int C,
                                      int G, int S, int slice, int rows,
                                      float eps, int silu, int is_bf16,
                                      void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  if (B <= 0 || B > 65535 || HW <= 0 || G <= 0 || G > kMaxGroups || C % G != 0 ||
      C % vec != 0 || rows <= 0 || (C / vec) * rows > 1024 ||
      2 * sizeof(float) * (size_t)rows * C > 48 * 1024 || S <= 0 || slice <= 0 ||
      (long long)S * slice < HW || (long long)(S - 1) * slice >= HW ||
      (film_scale == nullptr) != (film_shift == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* fs = static_cast<const float*>(film_scale);
  const float* fb = static_cast<const float*>(film_shift);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  if (is_bf16)
    return (int)run(static_cast<const __nv_bfloat16*>(x),
                    static_cast<__nv_bfloat16*>(out), sc, bi, fs, fb, ws, cnt, B,
                    HW, C, G, S, slice, rows, eps, silu, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), sc, bi,
                  fs, fb, ws, cnt, B, HW, C, G, S, slice, rows, eps, silu, st);
}

namespace {

template <typename T>
cudaError_t run_apply(const T* x, T* out, const float* scale, const float* bias,
                      const float* fs, const float* fb, const float2* stats, int B, int HW,
                      int C, int G, int R, int silu, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  const int chunk = kApplyPixels * R;
  const int items = (HW + chunk - 1) / chunk;
  const int per_sample = (kApplyBlocks + B - 1) / B;
  const dim3 grid(items < per_sample ? items : per_sample, B);
  // a plain launch: gn_apply's griddepcontrol.wait then returns at once
  gn_apply<T><<<grid, (C / V) * R, sizeof(float2) * (size_t)C, st>>>(
      x, out, scale, bias, fs, fb, stats, HW, C, G, R, silu);
  return cudaGetLastError();
}

bool bad_layout(int B, int HW, int C, int G, int rows, int vec) {
  return B <= 0 || B > 65535 || HW <= 0 || G <= 0 || G > kMaxGroups || C % G != 0 ||
         C % vec != 0 || rows <= 0 || (C / vec) * rows > 1024 ||
         2 * sizeof(float) * (size_t)rows * C > 48 * 1024;
}

}  // namespace

// The normalising half: stats holds (mean, rstd) per (sample, group), B*G
// float2; then as diffpir_groupnorm_silu's apply launch (FiLM, SiLU).
extern "C" int diffpir_groupnorm_apply_stats(const void* x, void* out, const void* scale,
                                             const void* bias, const void* film_scale,
                                             const void* film_shift, const void* stats,
                                             int B, int HW, int C, int G, int rows,
                                             int silu, int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  if (bad_layout(B, HW, C, G, rows, vec) ||
      (film_scale == nullptr) != (film_shift == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* fs = static_cast<const float*>(film_scale);
  const float* fb = static_cast<const float*>(film_shift);
  const float2* sts = static_cast<const float2*>(stats);
  if (is_bf16)
    return (int)run_apply(static_cast<const __nv_bfloat16*>(x),
                          static_cast<__nv_bfloat16*>(out), sc, bi, fs, fb, sts, B, HW, C,
                          G, rows, silu, st);
  return (int)run_apply(static_cast<const float*>(x), static_cast<float*>(out), sc, bi, fs,
                        fb, sts, B, HW, C, G, rows, silu, st);
}
