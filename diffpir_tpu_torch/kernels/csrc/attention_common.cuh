// Helpers shared by attention.cu and attention_bf16_any.cu: ex2 and bf16
// packing, mbarriers and TMA copies, the grid of the sliced kernels and the
// tensor map they copy by.  All in an anonymous namespace: each file that
// includes them has its own.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// copies and stores by threads, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// the arrival of the one producer, which expects bytes from the copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// one box of the qkv tensor map (128 bytes of channels from c, part 0/1/2
// for q/k/v, head h, rows from row, sample b) to dst, swizzled; what lies
// past ch or T arrives as zeros
__device__ __forceinline__ void tma_chunk(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c, int part, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(part), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// Blocks of the sliced kernels: (pair, query tile, slice) on grid x
cudaError_t sliced_grid(int B, int T_, int H, int rows, int slices, unsigned* blocks) {
  const long long n = (long long)B * H * ((T_ + rows - 1) / rows) * slices;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = (unsigned)n;
  return cudaSuccess;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime's entry
// points (the library does not link libcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map the sliced kernels copy by: qkv as [B][T][H][q|k|v][ch],
// boxes of 128 bytes of channels (64 bf16, 32 floats) by rows rows,
// 128-byte swizzled, zeros past ch and T.  Needs rows of 16-byte multiples
// (ch % 8 == 0 in bf16, ch % 4 == 0 in fp32).
cudaError_t qkv_tensor_map(CUtensorMap* map, const void* qkv, bool bf16, int B, int T_, int H,
                           int ch, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = bf16 ? 2 : 4, w3 = (cuuint64_t)3 * H * ch;
  const cuuint64_t dims[5] = {(cuuint64_t)ch, 3, (cuuint64_t)H, (cuuint64_t)T_, (cuuint64_t)B};
  const cuuint64_t strides[4] = {ch * e, 3 * ch * e, w3 * e, (cuuint64_t)T_ * w3 * e};
  const cuuint32_t box[5] = {(cuuint32_t)(128 / e), 1, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        5, const_cast<void*>(qkv), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace
