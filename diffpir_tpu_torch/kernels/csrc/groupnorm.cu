// GroupNorm (fp32 statistics) + optional FiLM + optional SiLU, NHWC, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel diffpir_tpu/pallas/groupnorm.py::groupnorm_silu.
// The math follows GroupNorm32's XLA path (diffpir_tpu/models/unet.py:83-131),
// not the Pallas kernel's: fp32 inputs take the two-pass centred variance,
// bf16 inputs the one-pass E[x^2] - mean^2 clamped at 0.  The affine step,
// FiLM y*(1+fs)+fb and SiLU are folded into one multiply-add per element:
//   w = rstd*scale, off = bias - mean*w;  with FiLM w *= 1+fs, off = off*(1+fs)+fb.
//
// Bound on this card: memory.  The kernel reads the input twice (three times
// for fp32) and writes it once; the least it could move is one read and one
// write, (2 * B*H*W*C * itemsize) bytes over 3.35 TB/s.
//
// Design.  On the TPU the grid runs in order, so the Pallas kernel carried
// per-channel sums in VMEM from one grid step to the next.  Here blocks run
// in parallel and in no order, so the reduction has three stages:
//   1. gn_partial: block (slice s, sample b) sums each channel over a slice
//      of pixels; 32 threads span 32 neighbouring channels (coalesced reads
//      of one NHWC row) and 8 thread rows stride the pixels.  The partial
//      sums go to a workspace the wrapper allocates.
//   2. gn_finalize: one block per sample adds the partials in a fixed order
//      (no atomics, so a run is reproducible bit for bit), forms the group
//      statistics and folds them with scale, bias and FiLM into (w, off)
//      per (sample, channel).
//   3. gn_apply: one pass over the input writes x*w + off [then SiLU] in the
//      input's type.
// Channels per group (C/32) is 3..24 on the port's models and is not assumed
// to be a power of two.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTX = 32;  // threads across channels
constexpr int kTY = 8;   // threads across pixels
constexpr int kMaxGroups = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// mode 0: sum and sum of squares (bf16 one pass)
// mode 1: sum only (fp32 first pass)
// mode 2: sum of squares about the group mean (fp32 second pass)
template <typename T>
__global__ void gn_partial(const T* __restrict__ x, int HW, int C, int G,
                           int slice, int S, const float* __restrict__ mean,
                           float* __restrict__ psum, float* __restrict__ psq,
                           int mode) {
  __shared__ float red1[kTY][kTX];
  __shared__ float red2[kTY][kTX];
  const int s = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p0 = s * slice;
  const int p1 = min(HW, p0 + slice);
  const int cg = C / G;
  const T* xb = x + (size_t)b * HW * C;
  for (int c0 = 0; c0 < C; c0 += kTX) {
    const int c = c0 + tx;
    float a1 = 0.f, a2 = 0.f;
    if (c < C) {
      const float m = (mode == 2) ? mean[b * G + c / cg] : 0.f;
      for (int p = p0 + ty; p < p1; p += kTY) {
        const float v = to_f(xb[(size_t)p * C + c]);
        if (mode == 2) {
          const float d = v - m;
          a2 += d * d;
        } else {
          a1 += v;
          if (mode == 0) a2 += v * v;
        }
      }
    }
    red1[ty][tx] = a1;
    red2[ty][tx] = a2;
    __syncthreads();
    if (ty == 0 && c < C) {
      float s1 = 0.f, s2 = 0.f;
      for (int k = 0; k < kTY; ++k) {
        s1 += red1[k][tx];
        s2 += red2[k][tx];
      }
      const size_t o = ((size_t)b * S + s) * C + c;
      psum[o] = s1;
      psq[o] = s2;
    }
    __syncthreads();
  }
}

// stage 0: bf16 one-pass statistics, then (w, off)
// stage 1: fp32 mean only
// stage 2: fp32 centred variance (mean from stage 1), then (w, off)
__global__ void gn_finalize(const float* __restrict__ psum,
                            const float* __restrict__ psq, int S, int C, int G,
                            float n, float eps, int stage,
                            float* __restrict__ mean, float* __restrict__ rstd,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            const float* __restrict__ fs,
                            const float* __restrict__ fb,
                            float* __restrict__ wo) {
  __shared__ float sm_mean[kMaxGroups];
  __shared__ float sm_rstd[kMaxGroups];
  const int b = blockIdx.x;
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      const int c = g * cg + j;
      float c1 = 0.f, c2 = 0.f;
      for (int s = 0; s < S; ++s) {
        const size_t o = ((size_t)b * S + s) * C + c;
        c1 += psum[o];
        c2 += psq[o];
      }
      t1 += c1;
      t2 += c2;
    }
    float m, var;
    if (stage == 0) {
      m = t1 / n;
      var = fmaxf(t2 / n - m * m, 0.f);
    } else if (stage == 1) {
      m = t1 / n;
      var = 0.f;
    } else {
      m = mean[b * G + g];
      var = t2 / n;
    }
    const float r = rsqrtf(var + eps);
    mean[b * G + g] = m;
    rstd[b * G + g] = r;
    sm_mean[g] = m;
    sm_rstd[g] = r;
  }
  if (stage == 1) return;  // uniform across the block: no barrier is skipped
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    float w = sm_rstd[g] * scale[c];
    float off = bias[c] - sm_mean[g] * w;
    if (fs != nullptr) {
      const float f = 1.f + fs[b * C + c];
      w = w * f;
      off = off * f + fb[b * C + c];
    }
    wo[2 * ((size_t)b * C + c)] = w;
    wo[2 * ((size_t)b * C + c) + 1] = off;
  }
}

template <typename T>
__global__ void gn_apply(const T* __restrict__ x, T* __restrict__ out,
                         const float* __restrict__ wo, int HW, int C, int silu) {
  const int b = blockIdx.y;
  const size_t n = (size_t)HW * C;
  const T* xb = x + b * n;
  T* ob = out + b * n;
  const float2* wob = reinterpret_cast<const float2*>(wo) + (size_t)b * C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const float2 w = wob[i % C];
    float y = to_f(xb[i]) * w.x + w.y;
    if (silu) y = y / (1.f + expf(-y));
    ob[i] = from_f<T>(y);
  }
}

template <typename T>
cudaError_t run(const T* x, T* out, const float* scale, const float* bias,
                const float* fs, const float* fb, float* ws, int B, int HW,
                int C, int G, int S, int slice, float eps, int silu,
                cudaStream_t st) {
  float* psum = ws;
  float* psq = psum + (size_t)B * S * C;
  float* mean = psq + (size_t)B * S * C;
  float* rstd = mean + (size_t)B * G;
  float* wo = rstd + (size_t)B * G;
  const float n = (float)HW * (float)(C / G);
  const dim3 pblock(kTX, kTY), pgrid(S, B);
  cudaError_t e;
  if (sizeof(T) == 2) {
    gn_partial<T><<<pgrid, pblock, 0, st>>>(x, HW, C, G, slice, S, nullptr,
                                            psum, psq, 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    gn_finalize<<<B, 256, 0, st>>>(psum, psq, S, C, G, n, eps, 0, mean, rstd,
                                   scale, bias, fs, fb, wo);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  } else {
    gn_partial<T><<<pgrid, pblock, 0, st>>>(x, HW, C, G, slice, S, nullptr,
                                            psum, psq, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    gn_finalize<<<B, 256, 0, st>>>(psum, psq, S, C, G, n, eps, 1, mean, rstd,
                                   scale, bias, fs, fb, wo);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    gn_partial<T><<<pgrid, pblock, 0, st>>>(x, HW, C, G, slice, S, mean, psum,
                                            psq, 2);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    gn_finalize<<<B, 256, 0, st>>>(psum, psq, S, C, G, n, eps, 2, mean, rstd,
                                   scale, bias, fs, fb, wo);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const size_t per_b = (size_t)HW * C;
  size_t gx = (per_b + 255) / 256;
  const size_t cap = (size_t)(2048 + B - 1) / B;
  if (gx > cap) gx = cap;
  gn_apply<T><<<dim3((unsigned)gx, B), 256, 0, st>>>(x, out, wo, HW, C, silu);
  return cudaGetLastError();
}

}  // namespace

// Workspace: 2*B*S*C + 2*B*G + 2*B*C floats.  Returns a cudaError_t.
extern "C" int diffpir_groupnorm_silu(const void* x, void* out,
                                      const void* scale, const void* bias,
                                      const void* film_scale,
                                      const void* film_shift, void* workspace,
                                      int B, int HW, int C, int G, int S,
                                      int slice, float eps, int silu,
                                      int is_bf16, void* stream) {
  if (G <= 0 || G > kMaxGroups || C % G != 0 || S <= 0 || slice <= 0 ||
      (film_scale == nullptr) != (film_shift == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* fs = static_cast<const float*>(film_scale);
  const float* fb = static_cast<const float*>(film_shift);
  float* ws = static_cast<float*>(workspace);
  if (is_bf16)
    return (int)run(static_cast<const __nv_bfloat16*>(x),
                    static_cast<__nv_bfloat16*>(out), sc, bi, fs, fb, ws, B, HW,
                    C, G, S, slice, eps, silu, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), sc,
                  bi, fs, fb, ws, B, HW, C, G, S, slice, eps, silu, st);
}
