// Self-attention in the legacy guided-diffusion QKV layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel diffpir_tpu/pallas/attention.py::legacy_qkv_attention.
// Input qkv is (B, T, 3*C) with the channel layout [head][q|k|v][ch]; the
// output is (B, T, C) with head h at channels h*ch .. h*ch+ch-1.  q and k are
// both scaled by ch^-1/4 (folded here into one 1/sqrt(ch) on q); logits and
// softmax are fp32.  The JAX XLA path (diffpir_tpu/models/unet.py:225-240)
// rounds logits and weights to bf16 in bf16 mode before P.V; this kernel keeps
// them in fp32 throughout, so in bf16 it differs from that path by up to the
// bf16 rounding of the weights (the stated tolerance is 3e-2).
//
// Bound on this card: at the UNet's shapes (T <= 1024, ch 32 or 64) the least
// time is set by operations, 4*B*heads*T*T*ch over the peak rate of the type;
// this first version uses scalar fp32 FMAs, far from that peak.
//
// Design.  The Pallas kernel held a whole (T, 3ch) head in VMEM and ran both
// products on the MXU.  Here one block of 64 threads takes one (batch*head,
// 64-row query tile); each thread owns one query row in registers (q and the
// output accumulator, ch floats each).  Key and value tiles of 64 rows are
// staged in shared memory straight from the legacy layout at offsets
// h*3ch + ch and h*3ch + 2ch (no transpose copy), and every thread reads them
// as broadcasts.  An online softmax (running max and sum, rescaled once per
// 16 keys) keeps the (T, T) logits out of memory.  wgmma/TMA come later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;     // query rows per block (one per thread)
constexpr int kBK = 64;     // key rows per shared-memory tile
constexpr int kChunk = 16;  // keys per softmax rescale

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int CH>
__global__ void __launch_bounds__(kBQ)
attn_kernel(const T* __restrict__ qkv, T* __restrict__ out, int T_, int H,
            float qscale) {
  __shared__ float Ks[kBK][CH];
  __shared__ float Vs[kBK][CH];
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int row = blockIdx.x * kBQ + threadIdx.x;
  const int W3 = 3 * H * CH;
  const T* base = qkv + (size_t)b * T_ * W3 + (size_t)h * 3 * CH;
  const bool valid = row < T_;

  float q[CH], acc[CH];
#pragma unroll
  for (int d = 0; d < CH; ++d) {
    q[d] = valid ? to_f(base[(size_t)row * W3 + d]) * qscale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < T_; k0 += kBK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBK * CH; idx += kBQ) {
      const int r = idx / CH, d = idx % CH;
      const int kr = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kr < T_) {
        kv = to_f(base[(size_t)kr * W3 + CH + d]);
        vv = to_f(base[(size_t)kr * W3 + 2 * CH + d]);
      }
      Ks[r][d] = kv;
      Vs[r][d] = vv;
    }
    __syncthreads();
    const int nk = min(kBK, T_ - k0);
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float mnew = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < CH; ++d) dot = fmaf(q[d], Ks[j][d], dot);
        s[jj] = (j < nk) ? dot : -INFINITY;
        mnew = fmaxf(mnew, s[jj]);
      }
      // mnew is finite: j0 < nk, so the chunk holds at least one key
      const float corr = expf(m - mnew);
      l *= corr;
#pragma unroll
      for (int d = 0; d < CH; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - mnew);
        l += p;
#pragma unroll
        for (int d = 0; d < CH; ++d) acc[d] = fmaf(p, Vs[j0 + jj][d], acc[d]);
      }
      m = mnew;
    }
  }
  if (valid) {
    const float inv = 1.f / l;
    T* o = out + ((size_t)b * T_ + row) * (H * CH) + (size_t)h * CH;
#pragma unroll
    for (int d = 0; d < CH; ++d) o[d] = from_f<T>(acc[d] * inv);
  }
}

template <typename T, int CH>
cudaError_t launch(const void* qkv, void* out, int B, int T_, int H,
                   cudaStream_t st) {
  const dim3 grid((T_ + kBQ - 1) / kBQ, B * H);
  const float qscale = 1.f / sqrtf((float)CH);
  attn_kernel<T, CH><<<grid, kBQ, 0, st>>>(static_cast<const T*>(qkv),
                                           static_cast<T*>(out), T_, H, qscale);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t; ch must be 32 or 64.
extern "C" int diffpir_legacy_qkv_attention(const void* qkv, void* out, int B,
                                            int T, int heads, int ch,
                                            int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || heads <= 0 || B * heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch == 32)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 32>(qkv, out, B, T, heads, st)
                         : launch<float, 32>(qkv, out, B, T, heads, st));
  if (ch == 64)
    return (int)(is_bf16 ? launch<__nv_bfloat16, 64>(qkv, out, B, T, heads, st)
                         : launch<float, 64>(qkv, out, B, T, heads, st));
  return (int)cudaErrorInvalidValue;
}
