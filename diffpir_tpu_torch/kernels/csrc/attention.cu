// Self-attention in the legacy guided-diffusion QKV layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel diffpir_tpu/pallas/attention.py::legacy_qkv_attention.
// Input qkv is (B, T, 3*C) with the channel layout [head][q|k|v][ch]; the
// output is (B, T, C) with head h at channels h*ch .. h*ch+ch-1.  q and k are
// both scaled by ch^-1/4, folded here into one log2(e)/sqrt(ch) on the fp32
// logits, which then go through exp2.  Logits and the softmax are fp32.  In
// bf16 the unnormalised weights are rounded to bf16 as the A operand of P.V
// (as diffpir_tpu/models/unet.py:238 rounds the weights before P.V) and the
// row sum divides the fp32 accumulator at the end.
//
// Bound on this card: at the UNet's shapes (T <= 1024, ch 16, 32 or 64) the
// least time is set by bytes (bf16) or by operations (fp32): one (b, head) pair
// reads 3*T*ch and writes T*ch elements and does 4*T*T*ch operations, under
// 300 operations per byte up to T = 1024.  In practice the bf16 kernel is held
// by latency and by its shared-memory and exp2 throughput per SM, not by the
// tensor cores; the first version was held by parallelism (one thread per
// query row) and scalar FMAs.
//
// Design, bf16 (attn_bf16): flash attention on tensor cores.  A block takes
// one (batch*head, query tile of 16 to 128 rows); each warp owns 16 or 32
// query rows (16 at ch 16), held as mma.sync A fragments loaded straight from
// the legacy layout (32 rows per warp halve the shared-memory reads per row:
// every K and V fragment feeds two products).  Key and value tiles of 64 rows are copied
// with 16-byte cp.async, double buffered, from row stride 3C at offsets
// h*3ch+ch and h*3ch+2ch (no transpose copy), into rows padded by 16 bytes so
// that ldmatrix reads them without bank conflicts (ldmatrix.trans for V).
// S = Q.K^T and O += P.V run as mma.sync.m16n8k16 (bf16 in, fp32 accumulate);
// the online softmax runs on the accumulator fragments, row max and sum by
// quad shuffles, exp2 by ex2.approx.  The wrapper picks the query tile from
// the grid (kernels/attention.py attention_rows_per_block) so that small
// batch*heads still fill the SMs.
//
// Design, fp32 (attn_f32): the fp32 tolerance rules out TF32, so this path
// stays on CUDA cores, where shared memory feeds a lane 32 floats per SM
// clock against 128 FMAs: each value read must serve several rows.  Eight
// lanes share two query rows: at ch 16 and 32 four split the keys of a tile
// and two the channels, at ch 64 two and four (16-byte chunks interleaved, dot
// products joined by shuffles).  Each thread keeps 16 q and 16 accumulator
// values per row in registers, uses every K and V value it reads for both
// rows, and keeps its own running (max, sum) per row; the key-split lanes are
// merged at the end.  K/V tiles of 32 rows are staged with a cp.async double
// buffer, padded so that the eight lanes' 16-byte reads hit distinct banks.
//
// Design, every other head width (1 .. 256): the TPU kernel takes any
// ch = C / heads, and a config with num_heads set and num_head_channels -1
// gives widths such as 96, 128 or 192.  In bf16 (attn_bf16_any) ch is
// padded to CHP, the next multiple of 16: Q of 64 rows and K/V tiles of 32
// keys are copied element by element (ch need not make 16-byte rows) into
// shared memory with the padding channels zero, and the tiles go through
// the same mma.sync path as attn_bf16 with 16 rows per warp.  In fp32
// (attn_f32_any) a simple kernel on CUDA cores takes ch at run time: 16
// rows per block, 8 lanes per row, Q and a 32-key K/V tile in shared memory
// (up to 82 KB at ch 256); every product reads shared memory, so it is slow.
//
// Design, widths above 256 (attn_wide, both types): a num_head_channels of
// -1 with one or two heads gives 320, 512 or 1024 channels a head, which no
// tile of registers holds.  The head width goes through shared memory in
// chunks of 64 channels: Q.K^T accumulates chunk by chunk, the logits of a
// 16-row query tile go to a workspace the wrapper allocates (16 * T floats a
// block), and P.V is written chunk by chunk.  Blocks loop over (pair, query
// tile) items, so neither the grid nor the workspace grows with the batch.
// The kernels above take the (batch, head) pairs on grid y, at most 65535;
// more pairs run as several launches over whole samples.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows k0 .. k0+BK-1 of K and V of one (batch, head) into padded
// shared tiles [BK][LD]; rows at or past T are zero-filled.
template <typename T, int CH, int BK, int LD>
__device__ __forceinline__ void load_kv_tile(const T* __restrict__ base, int W3,
                                             int k0, int T_, T* Ks, T* Vs) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = CH / kPer;    // chunks per row
  for (int i = threadIdx.x; i < BK * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const int key = k0 + r;
    const bool ok = key < T_;
    const T* src = base + (size_t)(ok ? key : 0) * W3 + c;
    cp_async16(Ks + r * LD + c, src + CH, ok ? 16 : 0);
    cp_async16(Vs + r * LD + c, src + 2 * CH, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBKb = 64;      // keys per tile
constexpr int kStagesb = 2;   // K/V tiles in flight, at most: a double buffer
constexpr int kMt2Rows = 64;  // query tiles from which warps own 32 rows

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
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

// MT m16 tiles (16*MT query rows) per warp: each K and V fragment read from
// shared memory feeds MT products.  Dynamic shared memory: stages * 2 *
// kBKb * (CH + 8) bf16, a ring of K/V tiles, stages = min(kStagesb, tiles).
template <int CH, int MT>
__global__ void __launch_bounds__(128)
attn_bf16(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
          int T_, int H, float scale_log2, int stages) {
  constexpr int LD = CH + 8;     // padded row: 16 bytes more
  constexpr int KS = CH / 16;    // k-steps of Q.K^T
  constexpr int NT = kBKb / 8;   // n-tiles of S
  constexpr int NO = CH / 8;     // n-tiles of O
  constexpr int TILE = kBKb * LD;
  extern __shared__ __align__(16) __nv_bfloat16 ring[];  // [stages][K, V][TILE]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int W3 = 3 * H * CH;
  const __nv_bfloat16* base = qkv + (size_t)b * T_ * W3 + (size_t)h * 3 * CH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = (blockIdx.x * (blockDim.x / 32) + warp) * 16 * MT;
  const int ntiles = (T_ + kBKb - 1) / kBKb;

  // prologue: tiles 0 .. stages-2 in flight, one commit group each
  for (int st = 0; st < stages - 1; ++st) {
    load_kv_tile<__nv_bfloat16, CH, kBKb, LD>(base, W3, st * kBKb, T_,
                                              ring + 2 * st * TILE,
                                              ring + (2 * st + 1) * TILE);
    cp_async_commit();
  }

  // Q as A fragments: rows r0+g and r0+g+8 of m-tile mt, channels 16kk + 2t4
  // (+1, +8, +9)
  uint32_t qa[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ra = row0 + 16 * mt + g, rb = ra + 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qa[mt][kk][0] = ra < T_ ? *reinterpret_cast<const uint32_t*>(base + (size_t)ra * W3 + c) : 0u;
      qa[mt][kk][1] = rb < T_ ? *reinterpret_cast<const uint32_t*>(base + (size_t)rb * W3 + c) : 0u;
      qa[mt][kk][2] = ra < T_ ? *reinterpret_cast<const uint32_t*>(base + (size_t)ra * W3 + c + 8) : 0u;
      qa[mt][kk][3] = rb < T_ ? *reinterpret_cast<const uint32_t*>(base + (size_t)rb * W3 + c + 8) : 0u;
    }
  }

  float o[MT][NO][4];
  // running max of the raw logits of rows g and g+8 (times scale_log2 when
  // used), and the row sums
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  // ldmatrix lane addressing: lane supplies row (lane % 8) of matrix lane / 8
  const int lr = lane % 8, lm = lane / 8;

  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();  // every warp is done with tile t-1, whose slot is refilled
    const int nxt = t + stages - 1;
    if (nxt < ntiles) {
      const int sl = nxt % stages;
      load_kv_tile<__nv_bfloat16, CH, kBKb, LD>(base, W3, nxt * kBKb, T_,
                                                ring + 2 * sl * TILE,
                                                ring + (2 * sl + 1) * TILE);
    }
    cp_async_commit();
    if (stages == 2) cp_async_wait<1>();  // tile t has landed (for this thread)
    else cp_async_wait<0>();
    __syncthreads();                 // ... and for every thread
    const __nv_bfloat16* Kt = ring + 2 * (t % stages) * TILE;
    const __nv_bfloat16* Vt = Kt + TILE;

    // S = Q K^T: matrix lm of an x4 load covers keys 8j..8j+7, channels 8*lm..
    // (ch >= 32); at ch 16 one x4 load covers two n-tiles, keys
    // 8(j + lm/2) .., channels 8(lm%2) ..
    float s[MT][NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
    if constexpr (CH == 16) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kt + (8 * (j + (lm >> 1)) + lr) * LD + 8 * (lm & 1));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][j], qa[mt][0], kb[0], kb[1]);
          mma_bf16(s[mt][j + 1], qa[mt][0], kb[2], kb[3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c0 = 0; c0 < CH; c0 += 32) {
          uint32_t kb[4];
          ldmatrix_x4(kb, Kt + (8 * j + lr) * LD + c0 + 8 * lm);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], qa[mt][c0 / 16], kb[0], kb[1]);
            mma_bf16(s[mt][j], qa[mt][c0 / 16 + 1], kb[2], kb[3]);
          }
        }
      }
    }

    // online softmax on the fragments: s[.][j][0..1] row g, [2..3] row g+8
    const int k0 = t * kBKb;
    if (k0 + kBKb > T_) {  // the ragged last tile: keys at or past T drop out
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t4 + (e & 1) >= T_) s[mt][j][e] = -INFINITY;
    }
    float sub[MT][2];  // the new row maxima, times scale_log2
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][j][0], s[mt][j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // every tile holds at least one key (k0 < T), so mx0 and mx1 are finite
      const float c0f = ex2((m[mt][0] - mx0) * scale_log2);
      const float c1f = ex2((m[mt][1] - mx1) * scale_log2);
      sub[mt][0] = mx0 * scale_log2;
      sub[mt][1] = mx1 * scale_log2;
      m[mt][0] = mx0;
      m[mt][1] = mx1;
      l[mt][0] *= c0f;
      l[mt][1] *= c1f;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[mt][n][0] *= c0f;
        o[mt][n][1] *= c0f;
        o[mt][n][2] *= c1f;
        o[mt][n][3] *= c1f;
      }
    }

    // per 16 keys: P as bf16 A fragments (two n-tiles of S), then O += P V;
    // V matrix lm: keys 16kk + 8*(lm&1) .., channels 8*(n + (lm>>1)) ..
#pragma unroll
    for (int kk = 0; kk < kBKb / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float p[2][4];
#pragma unroll
        for (int hlf = 0; hlf < 2; ++hlf) {
          const int j = 2 * kk + hlf;
          p[hlf][0] = ex2(fmaf(s[mt][j][0], scale_log2, -sub[mt][0]));
          p[hlf][1] = ex2(fmaf(s[mt][j][1], scale_log2, -sub[mt][0]));
          p[hlf][2] = ex2(fmaf(s[mt][j][2], scale_log2, -sub[mt][1]));
          p[hlf][3] = ex2(fmaf(s[mt][j][3], scale_log2, -sub[mt][1]));
          l[mt][0] += p[hlf][0] + p[hlf][1];
          l[mt][1] += p[hlf][2] + p[hlf][3];
        }
        pa[mt][0] = pack_bf16(p[0][0], p[0][1]);
        pa[mt][1] = pack_bf16(p[0][2], p[0][3]);
        pa[mt][2] = pack_bf16(p[1][0], p[1][1]);
        pa[mt][3] = pack_bf16(p[1][2], p[1][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + (16 * kk + 8 * (lm & 1) + lr) * LD + 8 * (n + (lm >> 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][n], pa[mt], vb[0], vb[1]);
          mma_bf16(o[mt][n + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  const int C = H * CH;
  __nv_bfloat16* ob = out + (size_t)b * T_ * C + (size_t)h * CH + 2 * t4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int ra = row0 + 16 * mt + g, rb = ra + 8;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      if (ra < T_)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * C + 8 * n) =
            __floats2bfloat162_rn(o[mt][n][0] * i0, o[mt][n][1] * i0);
      if (rb < T_)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * C + 8 * n) =
            __floats2bfloat162_rn(o[mt][n][2] * i1, o[mt][n][3] * i1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores, four threads per query row
// ---------------------------------------------------------------------------

constexpr int kBKf = 32;  // keys per tile
constexpr int kChunkf = 8;  // keys per thread between softmax rescales

// Eight lanes share two query rows: KS lanes split the keys of a tile and
// CS = 8 / KS lanes its channels, CPT = CH / CS each (16-byte chunks
// interleaved).  Each loaded K or V value serves both rows.  ch 16 splits as
// ch 32 does, with 8 channels (two chunks) per thread; KS stays at most 4 so
// that each thread's keys per tile (kBKf / KS) fill whole kChunkf chunks.
template <int CH>
struct F32Split {
  static constexpr int KS = CH == 64 ? 2 : 4;
  static constexpr int CS = 8 / KS;
  static constexpr int CPT = CH / CS;          // channels per thread (8 or 16)
  static constexpr int LD = CH + 4 * CS;       // padded row, in floats
  static_assert(CPT % 4 == 0 && (kBKf / KS) % kChunkf == 0, "bad fp32 split");
};

template <int CH>
__global__ void __launch_bounds__(256, 2)
attn_f32(const float* __restrict__ qkv, float* __restrict__ out, int T_, int H,
         float scale_log2) {
  using S = F32Split<CH>;
  constexpr int KS = S::KS, CS = S::CS, CPT = S::CPT, LD = S::LD;
  constexpr int NV = CPT / 4;          // float4 chunks per thread and row
  constexpr int KPT = kBKf / KS;       // keys per thread per tile
  __shared__ __align__(16) float Ks[2][kBKf * LD];
  __shared__ __align__(16) float Vs[2][kBKf * LD];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int W3 = 3 * H * CH;
  const float* base = qkv + (size_t)b * T_ * W3 + (size_t)h * 3 * CH;
  const int lane = threadIdx.x % 32, ql = lane % 8;
  const int kl = ql % KS, cl = ql / KS;
  const int row0 = blockIdx.x * (blockDim.x / 4) + (threadIdx.x / 8) * 2;
  const int ntiles = (T_ + kBKf - 1) / kBKf;

  load_kv_tile<float, CH, kBKf, LD>(base, W3, 0, T_, Ks[0], Vs[0]);
  cp_async_commit();

  // this thread's channels: 16-byte chunks cl, cl+CS, cl+2CS, ...
  float4 q[2][NV], acc[2][NV];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int c = 4 * (cl + CS * u);
      q[i][u] = row0 + i < T_
                    ? *reinterpret_cast<const float4*>(base + (size_t)(row0 + i) * W3 + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntiles) {
      load_kv_tile<float, CH, kBKf, LD>(base, W3, (t + 1) * kBKf, T_, Ks[cur ^ 1],
                                        Vs[cur ^ 1]);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks[cur];
    const float* Vt = Vs[cur];
    const int k0 = t * kBKf;

#pragma unroll
    for (int i0 = 0; i0 < KPT; i0 += kChunkf) {
      float s[2][kChunkf];
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kChunkf; ++i) {
        const int j = (i0 + i) * KS + kl;
        const float* kr = Kt + j * LD;
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * (cl + CS * u));
          d0 = fmaf(q[0][u].x, kv.x, d0);
          d0 = fmaf(q[0][u].y, kv.y, d0);
          d0 = fmaf(q[0][u].z, kv.z, d0);
          d0 = fmaf(q[0][u].w, kv.w, d0);
          d1 = fmaf(q[1][u].x, kv.x, d1);
          d1 = fmaf(q[1][u].y, kv.y, d1);
          d1 = fmaf(q[1][u].z, kv.z, d1);
          d1 = fmaf(q[1][u].w, kv.w, d1);
        }
#pragma unroll
        for (int off = KS; off < 8; off *= 2) {  // join the channel lanes
          d0 += __shfl_xor_sync(0xffffffffu, d0, off);
          d1 += __shfl_xor_sync(0xffffffffu, d1, off);
        }
        const bool valid = k0 + j < T_;
        s[0][i] = valid ? d0 * scale_log2 : -INFINITY;
        s[1][i] = valid ? d1 * scale_log2 : -INFINITY;
        mx[0] = fmaxf(mx[0], s[0][i]);
        mx[1] = fmaxf(mx[1], s[1][i]);
      }
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // a thread whose keys are all masked so far keeps m = -inf
        ms[r] = mx[r] == -INFINITY ? 0.f : mx[r];
        const float corr = exp2f(m[r] - ms[r]);
        m[r] = mx[r];
        l[r] *= corr;
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          acc[r][u].x *= corr;
          acc[r][u].y *= corr;
          acc[r][u].z *= corr;
          acc[r][u].w *= corr;
        }
      }
#pragma unroll
      for (int i = 0; i < kChunkf; ++i) {
        const float p0 = exp2f(s[0][i] - ms[0]), p1 = exp2f(s[1][i] - ms[1]);
        l[0] += p0;
        l[1] += p1;
        const float* vr = Vt + ((i0 + i) * KS + kl) * LD;
#pragma unroll
        for (int u = 0; u < NV; ++u) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * (cl + CS * u));
          acc[0][u].x = fmaf(p0, vv.x, acc[0][u].x);
          acc[0][u].y = fmaf(p0, vv.y, acc[0][u].y);
          acc[0][u].z = fmaf(p0, vv.z, acc[0][u].z);
          acc[0][u].w = fmaf(p0, vv.w, acc[0][u].w);
          acc[1][u].x = fmaf(p1, vv.x, acc[1][u].x);
          acc[1][u].y = fmaf(p1, vv.y, acc[1][u].y);
          acc[1][u].z = fmaf(p1, vv.z, acc[1][u].z);
          acc[1][u].w = fmaf(p1, vv.w, acc[1][u].w);
        }
      }
    }
    __syncthreads();
  }

  // merge the key-split lanes: (m, l, acc) of lane and lane ^ off
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < KS; off *= 2) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      const float ms = mn == -INFINITY ? 0.f : mn;
      const float a = exp2f(m[r] - ms), bo = exp2f(mo - ms);
      l[r] = l[r] * a + lo * bo;
      m[r] = mn;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        acc[r][u].x = acc[r][u].x * a + __shfl_xor_sync(0xffffffffu, acc[r][u].x, off) * bo;
        acc[r][u].y = acc[r][u].y * a + __shfl_xor_sync(0xffffffffu, acc[r][u].y, off) * bo;
        acc[r][u].z = acc[r][u].z * a + __shfl_xor_sync(0xffffffffu, acc[r][u].z, off) * bo;
        acc[r][u].w = acc[r][u].w * a + __shfl_xor_sync(0xffffffffu, acc[r][u].w, off) * bo;
      }
    }
    const int row = row0 + r;
    if (row < T_ && kl == 0) {
      const float inv = 1.f / l[r];
      float* o = out + ((size_t)b * T_ + row) * (H * CH) + (size_t)h * CH;
#pragma unroll
      for (int u = 0; u < NV; ++u)
        *reinterpret_cast<float4*>(o + 4 * (cl + CS * u)) =
            make_float4(acc[r][u].x * inv, acc[r][u].y * inv, acc[r][u].z * inv,
                        acc[r][u].w * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// any other head width, fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kGenRows = 16;      // query rows per block
constexpr int kGenKeys = 32;      // keys per tile
constexpr int kGenLanes = 8;      // lanes per query row
constexpr int kGenThreads = kGenRows * kGenLanes;
constexpr int kGenMaxCh = 256;

// Padded row of the shared tiles, in floats: odd, so that lanes reading one
// column of different rows hit different banks.
__host__ __device__ __forceinline__ int generic_ld(int ch) { return ch | 1; }

__host__ __forceinline__ size_t generic_smem(int ch) {
  return ((size_t)(kGenRows + 2 * kGenKeys) * generic_ld(ch) +
          kGenRows * (kGenKeys + 1)) * sizeof(float);
}

// Head width ch at run time.  A block takes 16 query rows of one (batch,
// head) pair; the 8 lanes of a row split the 32 keys of a tile for
// S = Q.K^T (keys lane, lane + 8, ...) and the channels for O += P.V
// (channels lane, lane + 8, ...; NU of them at most, NU * 8 >= ch).  Q and
// the K/V tile sit in shared memory; logits, the online softmax and the
// accumulator are fp32.
template <int NU>
__global__ void __launch_bounds__(kGenThreads)
attn_f32_any(const float* __restrict__ qkv, float* __restrict__ out, int T_, int H, int ch,
             float scale_log2) {
  extern __shared__ float gsm[];
  const int ld = generic_ld(ch);
  float* Qs = gsm;                       // [kGenRows][ld]
  float* Ks = Qs + kGenRows * ld;        // [kGenKeys][ld]
  float* Vs = Ks + kGenKeys * ld;        // [kGenKeys][ld]
  float* Ps = Vs + kGenKeys * ld;        // [kGenRows][kGenKeys + 1]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int W3 = 3 * H * ch;
  const float* base = qkv + (size_t)b * T_ * W3 + (size_t)h * 3 * ch;
  const int q0 = blockIdx.x * kGenRows;
  const int r = threadIdx.x / kGenLanes, sl = threadIdx.x % kGenLanes;

  for (int i = threadIdx.x; i < kGenRows * ch; i += kGenThreads) {
    const int rr = i / ch, c = i % ch, row = q0 + rr;
    Qs[rr * ld + c] = row < T_ ? base[(size_t)row * W3 + c] : 0.f;
  }

  float acc[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) acc[u] = 0.f;
  float m = -INFINITY, l = 0.f;
  const float* qr = Qs + r * ld;
  float* pr = Ps + r * (kGenKeys + 1);
  const int ntiles = (T_ + kGenKeys - 1) / kGenKeys;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kGenKeys;
    __syncthreads();  // the last tile is consumed (and Q is stored)
    for (int i = threadIdx.x; i < kGenKeys * ch; i += kGenThreads) {
      const int j = i / ch, c = i % ch, key = k0 + j;
      const float* src = base + (size_t)(key < T_ ? key : 0) * W3 + c;
      Ks[j * ld + c] = key < T_ ? src[ch] : 0.f;
      Vs[j * ld + c] = key < T_ ? src[2 * ch] : 0.f;
    }
    __syncthreads();

    float s[kGenKeys / kGenLanes];
#pragma unroll
    for (int i = 0; i < kGenKeys / kGenLanes; ++i) s[i] = 0.f;
    for (int c = 0; c < ch; ++c) {
      const float qv = qr[c];
#pragma unroll
      for (int i = 0; i < kGenKeys / kGenLanes; ++i)
        s[i] = fmaf(qv, Ks[(sl + kGenLanes * i) * ld + c], s[i]);
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < kGenKeys / kGenLanes; ++i) {
      s[i] = k0 + sl + kGenLanes * i < T_ ? s[i] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int off = 1; off < kGenLanes; off *= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    // every tile holds a key below T, so mx is finite; exp2f(-inf) = 0
    const float corr = exp2f(m - mx);
    m = mx;
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < kGenKeys / kGenLanes; ++i) {
      const float p = exp2f(s[i] - mx);
      psum += p;
      pr[sl + kGenLanes * i] = p;
    }
#pragma unroll
    for (int off = 1; off < kGenLanes; off *= 2)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    __syncwarp();  // the row's weights come from lanes of this warp
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[u] *= corr;
    for (int j = 0; j < kGenKeys; ++j) {
      const float p = pr[j];
      const float* vr = Vs + j * ld + sl;
#pragma unroll
      for (int u = 0; u < NU; ++u)
        if (sl + kGenLanes * u < ch) acc[u] = fmaf(p, vr[kGenLanes * u], acc[u]);
    }
  }

  const int row = q0 + r;
  if (row < T_) {
    const float inv = 1.f / l;
    float* o = out + ((size_t)b * T_ + row) * (H * ch) + (size_t)h * ch + sl;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (sl + kGenLanes * u < ch) o[kGenLanes * u] = acc[u] * inv;
  }
}

// ---------------------------------------------------------------------------
// any other head width, bf16: tensor cores on zero-padded tiles
// ---------------------------------------------------------------------------

constexpr int kPadRows = 64;   // query rows per block: 4 warps of 16
constexpr int kPadKeys = 32;   // keys per tile

__host__ __forceinline__ size_t padded_smem(int chp) {
  return (size_t)(kPadRows + 2 * kPadKeys) * (chp + 8) * sizeof(__nv_bfloat16);
}

// Head width ch padded to CHP, a multiple of 16: Q of the block's 64 rows
// and each tile of 32 keys' K and V are copied into shared memory with
// channels ch .. CHP-1 (and keys past T) set to 0, which leaves every dot
// product as it is.  Then as attn_bf16 with 16 rows per warp: Q fragments by
// ldmatrix, S = Q.K^T and O += P.V by mma.sync.m16n8k16, the online softmax
// on the fp32 fragments, the unnormalised weights rounded to bf16.
template <int CHP>
__global__ void __launch_bounds__(128)
attn_bf16_any(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
              int T_, int H, int ch, float scale_log2) {
  constexpr int LD = CHP + 8;       // padded row: 16 bytes more
  constexpr int KS = CHP / 16;      // k-steps of Q.K^T
  constexpr int NT = kPadKeys / 8;  // n-tiles of S
  constexpr int NO = CHP / 8;       // n-tiles of O
  extern __shared__ __align__(16) __nv_bfloat16 psm[];
  __nv_bfloat16* Qs = psm;                  // [kPadRows][LD]
  __nv_bfloat16* Ks = Qs + kPadRows * LD;   // [kPadKeys][LD]
  __nv_bfloat16* Vs = Ks + kPadKeys * LD;   // [kPadKeys][LD]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int W3 = 3 * H * ch;
  const __nv_bfloat16* base = qkv + (size_t)b * T_ * W3 + (size_t)h * 3 * ch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4, lr = lane % 8, lm = lane / 8;
  const int q0 = blockIdx.x * kPadRows;
  // the copies move raw 16-bit words (a select between bf16 structs went
  // through local memory)
  const uint16_t* src16 = reinterpret_cast<const uint16_t*>(base);
  uint16_t* Qs16 = reinterpret_cast<uint16_t*>(Qs);
  uint16_t* Ks16 = reinterpret_cast<uint16_t*>(Ks);
  uint16_t* Vs16 = reinterpret_cast<uint16_t*>(Vs);

  for (int i = threadIdx.x; i < kPadRows * CHP; i += blockDim.x) {
    const int r = i / CHP, c = i % CHP, row = q0 + r;
    Qs16[r * LD + c] = row < T_ && c < ch ? src16[(size_t)row * W3 + c] : uint16_t(0);
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  // lane supplies row lane % 16, channels 8 * (lane / 16) .. of an A fragment
  const __nv_bfloat16* qa_row = Qs + (warp * 16 + lane % 16) * LD + 8 * (lane / 16);
  const int ntiles = (T_ + kPadKeys - 1) / kPadKeys;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kPadKeys;
    __syncthreads();  // the last tile is consumed (and Q is stored)
    for (int i = threadIdx.x; i < kPadKeys * CHP; i += blockDim.x) {
      const int r = i / CHP, c = i % CHP, key = k0 + r;
      const bool ok = key < T_ && c < ch;
      const uint16_t* src = src16 + (size_t)(ok ? key : 0) * W3 + (ok ? c : 0);
      Ks16[r * LD + c] = ok ? src[ch] : uint16_t(0);
      Vs16[r * LD + c] = ok ? src[2 * ch] : uint16_t(0);
    }
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < KS; ++kk) {  // a loop: unrolled, ptxas spilled some CHP
      uint32_t qa[4];
      ldmatrix_x4(qa, qa_row + 16 * kk);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (8 * (j + (lm >> 1)) + lr) * LD + 16 * kk + 8 * (lm & 1));
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
      }
    }

    if (k0 + kPadKeys > T_) {  // the ragged last tile: keys at or past T drop out
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t4 + (e & 1) >= T_) s[j][e] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds a key below T, so mx0 and mx1 are finite
    const float c0f = ex2((m0 - mx0) * scale_log2), c1f = ex2((m1 - mx1) * scale_log2);
    const float sub0 = mx0 * scale_log2, sub1 = mx1 * scale_log2;
    m0 = mx0;
    m1 = mx1;
    l0 *= c0f;
    l1 *= c1f;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= c0f;
      o[n][1] *= c0f;
      o[n][2] *= c1f;
      o[n][3] *= c1f;
    }
#pragma unroll
    for (int kk = 0; kk < kPadKeys / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int j = 2 * kk + hlf;
        p[hlf][0] = ex2(fmaf(s[j][0], scale_log2, -sub0));
        p[hlf][1] = ex2(fmaf(s[j][1], scale_log2, -sub0));
        p[hlf][2] = ex2(fmaf(s[j][2], scale_log2, -sub1));
        p[hlf][3] = ex2(fmaf(s[j][3], scale_log2, -sub1));
        l0 += p[hlf][0] + p[hlf][1];
        l1 += p[hlf][2] + p[hlf][3];
      }
      uint32_t pa[4];
      pa[0] = pack_bf16(p[0][0], p[0][1]);
      pa[1] = pack_bf16(p[0][2], p[0][3]);
      pa[2] = pack_bf16(p[1][0], p[1][1]);
      pa[3] = pack_bf16(p[1][2], p[1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (16 * kk + 8 * (lm & 1) + lr) * LD + 8 * (n + (lm >> 1)));
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int ra = q0 + warp * 16 + g, C = H * ch;
  __nv_bfloat16* oa = out + ((size_t)b * T_ + ra) * C + (size_t)h * ch + 2 * t4;
  __nv_bfloat16* orb = oa + (size_t)8 * C;
  const bool ok_a = ra < T_, ok_b = ra + 8 < T_;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * n + e;
      if (c + 2 * t4 < ch) {
        if (ok_a) oa[c] = __float2bfloat16_rn(o[n][e] * i0);
        if (ok_b) orb[c] = __float2bfloat16_rn(o[n][2 + e] * i1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// head widths above 256, either type: the head width tiled through shared
// memory, the logits of a query tile in a workspace
// ---------------------------------------------------------------------------

constexpr int kWideRows = 16;     // query rows per work item
constexpr int kWideKeys = 32;     // keys per tile
constexpr int kWideCh = 64;       // channels per chunk
constexpr int kWideLanes = 8;     // lanes per query row
constexpr int kWideThreads = kWideRows * kWideLanes;

__device__ __forceinline__ float wide_load(const float* p) { return *p; }
__device__ __forceinline__ float wide_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void wide_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void wide_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// v rounded to the input type, as the plain version casts the weights
__device__ __forceinline__ float wide_round(float v, const float*) { return v; }
__device__ __forceinline__ float wide_round(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Any ch, and any number of (batch, head) pairs.  A work item is 16 query
// rows of one pair; block x takes items x, x + gridDim.x, ..., so the grid
// has no limit on pairs, and its workspace ws + x * 16 * T holds the item's
// logits.  Pass 1: for each tile of 32 keys, S = Q.K^T accumulates over
// chunks of 64 channels staged in shared memory (8 lanes per row, keys
// lane, lane + 8, ...) and goes to the workspace in the log2 domain.  Then
// each row's softmax in fp32 (max and sum by 8-lane shuffles), the weights
// rounded to the input type as the plain version rounds them.  Pass 2: for
// each chunk of 64 output channels, O = P.V over tiles of 32 keys, the V
// chunk and the weights' tile staged in shared memory.  Every product reads
// shared memory and P is read ch / 64 times: slow, and exact to fp32
// accumulation.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
attn_wide(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ ws,
          int T_, int H, int ch, long long items, int qtiles, float scale_log2) {
  __shared__ float Qs[kWideRows][kWideCh + 1];
  __shared__ float KVs[kWideKeys][kWideCh + 1];
  __shared__ float Ps[kWideRows][kWideKeys + 1];
  const int tid = threadIdx.x, r = tid / kWideLanes, sl = tid % kWideLanes;
  const size_t W3 = (size_t)3 * H * ch, C = (size_t)H * ch;
  float* P = ws + (size_t)blockIdx.x * kWideRows * T_;
  float* pr = P + (size_t)r * T_;

  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const long long bh = item / qtiles;
    const int q0 = (int)(item % qtiles) * kWideRows;
    const long long b = bh / H;
    const int h = (int)(bh % H);
    const T* base = qkv + (size_t)b * T_ * W3 + (size_t)h * 3 * ch;

    for (int k0 = 0; k0 < T_; k0 += kWideKeys) {
      float s[kWideKeys / kWideLanes];
#pragma unroll
      for (int i = 0; i < kWideKeys / kWideLanes; ++i) s[i] = 0.f;
      for (int c0 = 0; c0 < ch; c0 += kWideCh) {
        __syncthreads();  // the last chunk is consumed
        for (int i = tid; i < kWideRows * kWideCh; i += kWideThreads) {
          const int rr = i / kWideCh, cc = i % kWideCh, row = q0 + rr, c = c0 + cc;
          Qs[rr][cc] = row < T_ && c < ch ? wide_load(base + (size_t)row * W3 + c) : 0.f;
        }
        for (int i = tid; i < kWideKeys * kWideCh; i += kWideThreads) {
          const int j = i / kWideCh, cc = i % kWideCh, key = k0 + j, c = c0 + cc;
          KVs[j][cc] =
              key < T_ && c < ch ? wide_load(base + (size_t)key * W3 + ch + c) : 0.f;
        }
        __syncthreads();
        for (int cc = 0; cc < kWideCh; ++cc) {
          const float qv = Qs[r][cc];
#pragma unroll
          for (int i = 0; i < kWideKeys / kWideLanes; ++i)
            s[i] = fmaf(qv, KVs[sl + kWideLanes * i][cc], s[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kWideKeys / kWideLanes; ++i) {
        const int key = k0 + sl + kWideLanes * i;
        if (key < T_) pr[key] = s[i] * scale_log2;
      }
    }
    __syncthreads();  // each row's logits were written by its own 8 lanes

    float mx = -INFINITY;
    for (int k = sl; k < T_; k += kWideLanes) mx = fmaxf(mx, pr[k]);
#pragma unroll
    for (int off = 1; off < kWideLanes; off *= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int k = sl; k < T_; k += kWideLanes) {
      const float e = exp2f(pr[k] - mx);
      pr[k] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 1; off < kWideLanes; off *= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float inv = 1.f / sum;
    for (int k = sl; k < T_; k += kWideLanes) pr[k] = wide_round(pr[k] * inv, qkv);
    __syncthreads();

    const int row = q0 + r;
    for (int c0 = 0; c0 < ch; c0 += kWideCh) {
      float acc[kWideCh / kWideLanes];
#pragma unroll
      for (int u = 0; u < kWideCh / kWideLanes; ++u) acc[u] = 0.f;
      for (int k0 = 0; k0 < T_; k0 += kWideKeys) {
        __syncthreads();  // the last tile is consumed
        for (int i = tid; i < kWideKeys * kWideCh; i += kWideThreads) {
          const int j = i / kWideCh, cc = i % kWideCh, key = k0 + j, c = c0 + cc;
          KVs[j][cc] =
              key < T_ && c < ch ? wide_load(base + (size_t)key * W3 + 2 * ch + c) : 0.f;
        }
        for (int i = tid; i < kWideRows * kWideKeys; i += kWideThreads) {
          const int rr = i / kWideKeys, j = i % kWideKeys, key = k0 + j;
          Ps[rr][j] = key < T_ ? P[(size_t)rr * T_ + key] : 0.f;
        }
        __syncthreads();
        for (int j = 0; j < kWideKeys; ++j) {
          const float p = Ps[r][j];
#pragma unroll
          for (int u = 0; u < kWideCh / kWideLanes; ++u)
            acc[u] = fmaf(p, KVs[j][sl + kWideLanes * u], acc[u]);
        }
      }
      if (row < T_) {
        T* o = out + ((size_t)b * T_ + row) * C + (size_t)h * ch;
#pragma unroll
        for (int u = 0; u < kWideCh / kWideLanes; ++u) {
          const int c = c0 + sl + kWideLanes * u;
          if (c < ch) wide_store(o + c, acc[u]);
        }
      }
    }
    __syncthreads();  // the workspace is read before the next item writes it
  }
}

template <typename T>
cudaError_t launch_wide(const void* qkv, void* out, float* ws, int ws_blocks, int B,
                        int T_, int H, int ch, cudaStream_t st) {
  const int qtiles = (T_ + kWideRows - 1) / kWideRows;
  const long long items = (long long)B * H * qtiles;
  const int blocks = (int)(items < ws_blocks ? items : ws_blocks);
  attn_wide<T><<<blocks, kWideThreads, 0, st>>>(static_cast<const T*>(qkv),
                                                static_cast<T*>(out), ws, T_, H, ch, items,
                                                qtiles, kLog2e / sqrtf((float)ch));
  return cudaGetLastError();
}

template <typename Kernel, typename T>
cudaError_t launch_any(Kernel kernel, int rows, int threads, size_t smem, const void* qkv,
                       void* out, int B, int T_, int H, int ch, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T_ + rows - 1) / rows, B * H);
  kernel<<<grid, threads, smem, st>>>(static_cast<const T*>(qkv), static_cast<T*>(out), T_,
                                      H, ch, kLog2e / sqrtf((float)ch));
  return cudaGetLastError();
}

template <int CHP>
cudaError_t launch_bf16_any(const void* qkv, void* out, int B, int T_, int H, int ch,
                            cudaStream_t st) {
  if (ch > CHP) return launch_bf16_any<(CHP < kGenMaxCh ? CHP + 16 : CHP)>(
      qkv, out, B, T_, H, ch, st);
  return launch_any<decltype(&attn_bf16_any<CHP>), __nv_bfloat16>(
      attn_bf16_any<CHP>, kPadRows, 128, padded_smem(CHP), qkv, out, B, T_, H, ch, st);
}

cudaError_t launch_f32_any(const void* qkv, void* out, int B, int T_, int H, int ch,
                           cudaStream_t st) {
  const size_t smem = generic_smem(ch);
#define DIFFPIR_F32_ANY(NU)                                                              \
  return launch_any<decltype(&attn_f32_any<NU>), float>(attn_f32_any<NU>, kGenRows,      \
                                                        kGenThreads, smem, qkv, out, B, \
                                                        T_, H, ch, st)
  if (ch <= 32) DIFFPIR_F32_ANY(4);
  if (ch <= 64) DIFFPIR_F32_ANY(8);
  if (ch <= 128) DIFFPIR_F32_ANY(16);
  DIFFPIR_F32_ANY(32);
#undef DIFFPIR_F32_ANY
}

template <int CH>
cudaError_t launch(const void* qkv, void* out, int B, int T_, int H, int rows,
                   bool bf16, cudaStream_t st) {
  const float scale_log2 = kLog2e / sqrtf((float)CH);
  if (bf16) {
    // at ch 16 warps own 16 rows (ptxas spills the 32-row variant), so a
    // tile of 128 rows runs as two blocks of 64
    if (CH == 16 && rows > 64) rows = 64;
    const dim3 grid((T_ + rows - 1) / rows, B * H);
    const int ntiles = (T_ + kBKb - 1) / kBKb;
    const int stages = ntiles < kStagesb ? ntiles : kStagesb;
    const size_t smem = (size_t)stages * 2 * kBKb * (CH + 8) * sizeof(__nv_bfloat16);
    const auto* q = static_cast<const __nv_bfloat16*>(qkv);
    auto* o = static_cast<__nv_bfloat16*>(out);
    if constexpr (CH >= 32) {
      if (rows >= kMt2Rows) {  // 32 query rows per warp
        attn_bf16<CH, 2><<<grid, rows, smem, st>>>(q, o, T_, H, scale_log2, stages);
        return cudaGetLastError();
      }
    }
    // 16 query rows per warp
    attn_bf16<CH, 1><<<grid, 2 * rows, smem, st>>>(q, o, T_, H, scale_log2, stages);
  } else {  // 8 query rows per warp
    const dim3 grid((T_ + rows - 1) / rows, B * H);
    attn_f32<CH><<<grid, 4 * rows, 0, st>>>(static_cast<const float*>(qkv),
                                            static_cast<float*>(out), T_, H, scale_log2);
  }
  return cudaGetLastError();
}

// The kernels for widths up to 256 take (batch, head) pairs on grid y, at
// most 65535 of them: more pairs run as several launches over whole samples.
cudaError_t launch_pairs(const void* qkv, void* out, int B, int T_, int H, int ch, int rows,
                         bool bf16, cudaStream_t st) {
  const size_t esize = bf16 ? 2 : 4;
  const int per = 65535 / H;  // samples per launch
  for (int b0 = 0; b0 < B; b0 += per) {
    const int nb = B - b0 < per ? B - b0 : per;
    const void* q = static_cast<const char*>(qkv) + (size_t)b0 * T_ * 3 * H * ch * esize;
    void* o = static_cast<char*>(out) + (size_t)b0 * T_ * H * ch * esize;
    cudaError_t e;
    if (ch == 16) e = launch<16>(q, o, nb, T_, H, rows, bf16, st);
    else if (ch == 32) e = launch<32>(q, o, nb, T_, H, rows, bf16, st);
    else if (ch == 64) e = launch<64>(q, o, nb, T_, H, rows, bf16, st);
    else e = bf16 ? launch_bf16_any<16>(q, o, nb, T_, H, ch, st)
                  : launch_f32_any(q, o, nb, T_, H, ch, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Returns a cudaError_t.  ch is 16, 32 or 64: the tuned kernels with rows
// (query rows per block) 16, 32, 64 or (bf16 only) 128; any other ch up to
// 256 runs attn_bf16_any (64 rows per block) or attn_f32_any (16), whatever
// rows says; above 256 (or with more than 65535 heads) attn_wide, in
// ws_blocks blocks, each with 16 * T floats of the workspace ws.  qkv and out
// must be 16-byte aligned.
extern "C" int diffpir_legacy_qkv_attention(const void* qkv, void* out, int B,
                                            int T, int heads, int ch, int rows,
                                            int is_bf16, void* workspace,
                                            int ws_blocks, void* stream) {
  if (B <= 0 || T <= 0 || heads <= 0 || ch <= 0 ||
      (rows != 16 && rows != 32 && rows != 64 && !(is_bf16 && rows == 128)) ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ch > kGenMaxCh || heads > 65535) {
    if (workspace == nullptr || ws_blocks <= 0) return (int)cudaErrorInvalidValue;
    float* ws = static_cast<float*>(workspace);
    return (int)(is_bf16 ? launch_wide<__nv_bfloat16>(qkv, out, ws, ws_blocks, B, T, heads,
                                                      ch, st)
                         : launch_wide<float>(qkv, out, ws, ws_blocks, B, T, heads, ch, st));
  }
  return (int)launch_pairs(qkv, out, B, T, heads, ch, rows, is_bf16, st);
}
