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
// Design, fp32 (attn_f32): one TF32 product per fp32 product misses the fp32
// tolerance, and this path stays on CUDA cores (attn_f32_any below shows the
// split that keeps fp32's accuracy on tensor cores), where shared memory feeds a lane 32 floats per SM
// clock against 128 FMAs: each value read must serve several rows.  Eight
// lanes share two query rows: at ch 16 and 32 four split the keys of a tile
// and two the channels, at ch 64 two and four (16-byte chunks interleaved, dot
// products joined by shuffles).  Each thread keeps 16 q and 16 accumulator
// values per row in registers, uses every K and V value it reads for both
// rows, and keeps its own running (max, sum) per row; the key-split lanes are
// merged at the end.  K/V tiles of 32 rows are staged with a cp.async double
// buffer, padded so that the eight lanes' 16-byte reads hit distinct banks.
//
// Which kernel takes a call is decided in one place, kernels/attention.py
// attention_plan (variant, query rows, output slice), and passed to the C
// entry: "tuned" (attn_bf16, attn_f32) at ch 16, 32 and 64; "bf16_any"
// (attn_bf16_any) for every other bf16 width and head count; "f32_any"
// (attn_f32_any) for every other fp32 width up to 256, and the tuned widths
// past 65535 heads; "f32_wide" (attn_wide) beyond 256.  The tuned kernels take
// the (batch, head) pairs on grid y, at most 65535; more pairs run as several
// launches over whole samples.  attn_f32_any puts (pair, query tile) on grid
// x, attn_bf16_any and attn_wide (pair, query tile, output slice).
//
// Design, attn_bf16_any: a config with num_heads set and num_head_channels
// -1 (guided-diffusion's default) gives widths such as 96, 128, 192, 256 and,
// with one or two heads, 320 to 1024.  Bound: operations at T = 1024 (up to
// 34 GFLOP at (8, 1024, 4 x 256)), bytes at short T.  What held the mma.sync
// version back (2-byte synchronous copies, 32-key tiles with two barriers
// each, one product per fragment) is gone: a warpgroup of 64 query rows runs
// wgmma (sm_90a) on 128-byte swizzled chunks of 64 channels that TMA copies
// (one thread asks; an mbarrier reports the bytes) two steps ahead into a
// ring of up to 4 slots, while the previous step's wgmma group is in flight.
// Key tiles hold 128 keys where the registers take S and P of that many
// (slices up to 128 channels), else 64: each tile is one wgmma m64nKTk16
// chain for S over the head width and one batch of m64n64k16 products for
// P.V a V chunk, so the dependent chain, the barriers and the softmax passes
// per key are half those of 64-key tiles.  Two warpgroups share the K and V
// chunks where Q fits (widths up to 384) and the grid still fills the card,
// halving the copies from L2 per query row.  O stays in registers (NV / 2
// floats a thread); a head wider than 256, and a grid too small for the
// card, is cut into output slices, S recomputed for each.  Widths that are
// no multiple of 8 (rows off 16-byte boundaries) are copied element by
// element into the same zero-padded chunks: a correctness path.  The first
// product of a tile overwrites S through wgmma's scale-d (a store to an
// accumulator in flight made ptxas serialize every wgmma).
//
// Design, attn_f32_any (fp32, widths 1 .. 256 but the tuned ones, any head
// count).  Bound: operations, 4 T^2 ch a pair (34 GFLOP at (8, 1024, 4 x
// 256): 0.21 ms at the card's 495/3 TFLOP/s of fp32-accurate tensor-core
// products, 0.51 ms at 67 TFLOP/s on CUDA cores).  One TF32 product (10
// mantissa bits, about 5e-4 of a logit) misses the fp32 bars (atol 2e-5,
// rtol 1e-4); the split does not: hi = x rounded to TF32 and lo = x - hi (of
// which the product reads the TF32 part) give x to about 2^-22, and hi.hi +
// hi.lo + lo.hi, each product exact in fp32 and summed in fp32, leave out
// lo.lo alone, about 2^-22 of the product: fp32's accuracy at three
// mma.sync.m16n8k8 TF32 products for each (SDPA's fp32 kernel, CUTLASS's
// OpMultiplyAddFastF32, does the same).  In practice the kernel is bound by
// instruction issue: every operand value is split (Q and K per fragment as
// read from shared memory, P once per k-step from S's registers, V per
// fragment), so the split is integer work, an add and a mask and one FADD
// (cvt.rna for hi and lo made it nine instructions a value), and a warp
// holds two m-tiles of 16 query rows up to 128 channels so that each split
// K and V fragment feeds two products.  What held the CUDA-core version
// back (16 query rows a block, so K and V came from L2 T/16 times;
// synchronous 4-byte copies between two barriers; every FMA reading shared
// memory) is gone: eight warps a block, as 8, 4 or 2 row groups of 32 (16
// above 128 channels) query rows times 1, 2 or 4 warps splitting each
// tile's keys (merged at the end), picked by attention_plan as the most
// rows whose grid still gives every SM a block; where even that grid leaves
// half the SMs idle, each query tile's keys are cut into up to 8 chunks, a
// block each, whose partial sums a second launch merges in chunk order.  Q
// and K/V tiles of 16 keys a warp by 16-byte cp.async, the next tile in
// flight, one barrier a tile; S, P and O in registers; rows padded to
// ld % 8 == 4 floats at the instantiation's width (compile-time strides:
// immediate shared-memory offsets), so that each fragment load is free of
// bank conflicts.  Widths that are no multiple of 4 (rows off 16-byte
// boundaries) are copied element by element into the same zero-padded
// tiles: a correctness path.  No floating-point atomics: reruns are
// bit-identical.
//
// Design, attn_wide (fp32, heads wider than 256): CUDA cores (the split of
// attn_f32_any is not carried over to it yet); bound: operations.  Flash
// attention with no logits workspace: 64-key tiles of S in registers with an online
// softmax, the head width streamed through shared memory in chunks of 64
// channels, one a barrier, that TMA copies three chunks ahead; output slices
// of up to 512 channels (S recomputed for each; one slice where the grid
// still fills the card); register tiles so that each value read from shared
// memory serves several FMAs; and two halves of a block splitting the keys
// of each tile (merged at the end) for two warps a scheduler.
//
// attn_bf16_any lives in attention_bf16_any.cu (nvcc compiles the two files
// side by side); the helpers both use in attention_common.cuh.

#include "attention_common.cuh"

// attention_bf16_any.cu
cudaError_t diffpir_attn_bf16_any(const void* qkv, void* out, int B, int T, int heads, int ch,
                                  int rows, int slice_ch, cudaStream_t st);

namespace {

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
// any other head width up to 256, fp32: split-TF32 on tensor cores
// ---------------------------------------------------------------------------

constexpr int kAnyMaxCh = 256;
constexpr int kAnyWarpKeys = 16;     // a warp's keys of a tile: two n-tiles of S
constexpr int kMaxDynSmem = 232448;  // dynamic shared memory a block may have

// The instantiations of attn_f32_any: n-tiles of 8 channels each holds
// (exact at GENERIC widths 8, 24, 48, 80, 96, 128, 192 and 256)
constexpr int kAnyTiles[] = {1, 2, 3, 4, 6, 8, 10, 12, 16, 20, 24, 32};

// the instantiation that takes ch channels (ch <= kAnyMaxCh)
__host__ __forceinline__ int f32_any_tiles(int ch) {
  for (int n : kAnyTiles)
    if (8 * n >= ch) return n;
  return 32;
}

// m-tiles of 16 query rows a warp of attn_f32_any holds: two up to 128
// channels (each split K and V fragment then feeds two products), one
// beyond (O's registers)
__host__ __device__ constexpr int f32_any_mtiles(int no) { return no <= 16 ? 2 : 1; }

// Shared memory of attn_f32_any for ch channels, `rows` query rows and
// `splits` warps a row group: Q's rows and a double buffer of K and V tiles
// of 16 * splits keys, rows of the instantiation's width plus 4 floats;
// after the last tile the same bytes take the (m, l, O) of the key-split
// warps for the merge
__host__ __forceinline__ size_t f32_any_smem(int ch, int rows, int splits) {
  const int no = f32_any_tiles(ch);
  const size_t tiles = (size_t)(8 * no + 4) * (rows + 4 * kAnyWarpKeys * splits);
  const size_t merge = (size_t)(splits - 1) * (rows / 16) * 32 * (4 * no + 4);
  return (tiles > merge ? tiles : merge) * sizeof(float);
}

// x = hi + lo: hi is x rounded to TF32, to nearest with ties away (half a
// unit of the 13 dropped bits added, then those bits cleared: what
// cvt.rna.tf32.f32 computes, less its check for inf and NaN, which cost
// ptxas two more instructions for each of them), lo = x - hi, exact in fp32;
// the TF32 product reads lo's top 11 significant bits (its 13 low bits are
// dropped), so hi + lo stands for x to about 2^-22 of x.  Three instructions
// a value, against nine with cvt.rna for both.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, a 16 x 8 (rows g, g + 8; columns t4, t4 + 4), b 8 x 8 (rows t4,
// t4 + 4; column g), TF32 products exact in fp32, fp32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b to fp32 accuracy: the split's three products, the small ones
// first (lo.lo, about 2^-22 of the product, is left out)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Head width ch at run time, held as NO n-tiles of 8 channels (the columns
// from ch to 8 NO zero), any number of (batch, head) pairs; (pair, query
// tile, key chunk) on grid x.  A block takes `rows` query rows of one pair
// in row groups of 16 MT rows (MT m-tiles a warp), `splits` warps a row
// group (blockDim = 2 * rows * splits / MT), and the key tiles of its chunk
// (all where chunks = 1): the warps of a group share its rows and split
// each tile's 16 * splits keys, 16 each, and merge their (m, l, O) at the
// end through shared memory; with chunks > 1 the block writes (m, l, O) to
// `part` for attn_f32_any_merge.  Q and tile t_lo are copied by 16-byte
// cp.async, then each next tile into the other half of a double buffer
// while this one is used (element by element where ch % 4 != 0), one
// barrier a tile.  A warp computes S = Q K^T for its rows and keys
// (mma.sync m16n8k8 on the split operands; with one m-tile, hi.hi, hi.lo
// and lo.hi in three accumulators so that six products of a k-step are
// independent), scales it by log2(e) / sqrt(ch) (both of the reference's
// ch^-1/4 factors and the exp2 base), runs the online softmax on the
// accumulator fragments (row max by quad shuffles, ex2), and O += P V with
// P split from the same registers: the k index t4 of the A fragment stands
// for key 2 t4 and t4 + 4 for key 2 t4 + 1, which is S's accumulator
// layout, and V's B fragment reads the same keys.  O stays in registers
// (MT * NO * 4 floats a thread).  Rows of the shared tiles hold LD = 8 NO +
// 4 floats (LD % 8 == 4: every fragment load of a warp hits 32 distinct
// banks), known at compile time like the loops over channels, so that
// shared-memory addresses are immediate offsets.
template <int NO, int MT>
__global__ void __launch_bounds__(256)
attn_f32_any(const float* __restrict__ qkv, float* __restrict__ out, float* __restrict__ part,
             int T_, int H, int ch, int rows, int chunks, float scale_log2) {
  constexpr int NT = kAnyWarpKeys / 8;  // n-tiles of S, k-steps of P.V
  constexpr int NA = MT == 1 ? 3 : 1;   // accumulators of S
  constexpr int GR = 16 * MT;           // query rows of a row group
  constexpr int CW = 8 * NO, ld = CW + 4;
  extern __shared__ __align__(16) float fsm[];
  const int groups = rows / GR, splits = blockDim.x / (32 * groups);
  const int BK = kAnyWarpKeys * splits;
  float* Qs = fsm;               // [rows][ld]
  float* ring = Qs + rows * ld;  // [2][K, V][BK][ld]
  const int qtiles = (T_ + rows - 1) / rows;
  const int chunk = blockIdx.x % chunks;
  const int pair = blockIdx.x / chunks / qtiles;
  const int q0 = (blockIdx.x / chunks - pair * qtiles) * rows;
  const int b = pair / H, h = pair - b * H;
  const size_t W3 = (size_t)3 * H * ch;
  const float* base = qkv + (size_t)b * T_ * W3 + (size_t)h * 3 * ch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int wr = warp % groups, wk = warp / groups;  // row group, key split
  const bool vec = ch % 4 == 0;  // rows on 16-byte boundaries
  // this block's key tiles: chunk `chunk` of `chunks` equal shares
  const int all_tiles = (T_ + BK - 1) / BK;
  const int t_lo = chunk * all_tiles / chunks, t_hi = (chunk + 1) * all_tiles / chunks;

  // tile t of K and V into slot (t - t_lo) % 2; zeros past T (and past ch)
  auto load = [&](int t) {
    float* Kt = ring + ((t - t_lo) & 1) * 2 * BK * ld;
    float* Vt = Kt + BK * ld;
    const int k0 = t * BK;
    if (vec) {
      const int c4 = ch / 4;
      for (int i = threadIdx.x; i < BK * c4; i += blockDim.x) {
        const int r = i / c4, c = 4 * (i - r * c4), key = k0 + r;
        const bool ok = key < T_;
        const float* src = base + (size_t)(ok ? key : 0) * W3 + c;
        cp_async16(Kt + r * ld + c, src + ch, ok ? 16 : 0);
        cp_async16(Vt + r * ld + c, src + 2 * ch, ok ? 16 : 0);
      }
      cp_async_commit();
    } else {
      for (int i = threadIdx.x; i < BK * CW; i += blockDim.x) {
        const int r = i / CW, c = i % CW, key = k0 + r;
        const bool ok = key < T_ && c < ch;
        const float* src = base + (ok ? (size_t)key * W3 + c : 0);
        Kt[r * ld + c] = ok ? src[ch] : 0.f;
        Vt[r * ld + c] = ok ? src[2 * ch] : 0.f;
      }
    }
  };
  // Q (in tile t_lo's copy group), zeros past T and ch
  if (vec) {
    const int c4 = ch / 4;
    for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
      const int r = i / c4, c = 4 * (i - r * c4), row = q0 + r;
      const bool ok = row < T_;
      cp_async16(Qs + r * ld + c, base + (size_t)(ok ? row : 0) * W3 + c, ok ? 16 : 0);
    }
    // the columns from ch to CW that the copies never write
    if (CW > ch) {
      const int pad = CW - ch;
      for (int i = threadIdx.x; i < (rows + 4 * BK) * pad; i += blockDim.x)
        Qs[(i / pad) * ld + ch + i % pad] = 0.f;
    }
  } else {
    for (int i = threadIdx.x; i < rows * CW; i += blockDim.x) {
      const int r = i / CW, c = i % CW, row = q0 + r;
      Qs[r * ld + c] = row < T_ && c < ch ? base[(size_t)row * W3 + c] : 0.f;
    }
  }
  load(t_lo);

  float o[MT][NO][4];
  // running max (log2 units) and this thread's share of the sum, rows g and
  // g + 8 of each m-tile
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const float* qa = Qs + (wr * GR + g) * ld + t4;
  const int kw = wk * kAnyWarpKeys;  // this warp's first key of a tile

#pragma unroll 1
  for (int t = t_lo; t < t_hi; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + 1 < t_hi) load(t + 1);  // into tile t - 1's slot
    const float* Kt = ring + ((t - t_lo) & 1) * 2 * BK * ld + kw * ld;
    const float* Vt = Kt + BK * ld;

    // S = Q K^T: hi.hi, hi.lo and lo.hi in NA accumulators (three where a
    // warp has one m-tile, so that a k-step's products are independent)
    float sa[NA][MT][NT][4];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sa[a][mt][j][e] = 0.f;
    const float* kb = Kt + g * ld + t4;
#pragma unroll 4
    for (int kk = 0; kk < NO; ++kk) {
      const int c = 8 * kk;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* q = qa + 16 * mt * ld + c;
        split_tf32(q[0], ah[mt][0], al[mt][0]);
        split_tf32(q[8 * ld], ah[mt][1], al[mt][1]);
        split_tf32(q[4], ah[mt][2], al[mt][2]);
        split_tf32(q[8 * ld + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kb[8 * j * ld + c], bh0, bl0);
        split_tf32(kb[8 * j * ld + c + 4], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(sa[NA - 1][mt][j], al[mt], bh0, bh1);
          mma_tf32(sa[NA == 3 ? 1 : 0][mt][j], ah[mt], bl0, bl1);
          mma_tf32(sa[0][mt][j], ah[mt], bh0, bh1);
        }
      }
    }

    const int k0 = t * BK + kw;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // online softmax on the fragments: s[j][0..1] row g, [2..3] row g + 8,
      // keys kw + 8j + 2t4 (+1) of the tile
      // (log2 units: times log2(e) / sqrt(ch))
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = (NA == 3 ? sa[0][mt][j][e] + (sa[1][mt][j][e] + sa[NA - 1][mt][j][e])
                             : sa[0][mt][j][e]) * scale_log2;
      if (k0 + kAnyWarpKeys > T_) {  // the ragged last tile: keys at or past T drop out
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t4 + (e & 1) >= T_) s[j][e] = -INFINITY;
      }
      float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // a warp whose keys so far all lie past T keeps m = -inf and zero
      // weights; ex2(-inf) = 0
      const float ms0 = mx0 == -INFINITY ? 0.f : mx0, ms1 = mx1 == -INFINITY ? 0.f : mx1;
      const float c0 = ex2(m[mt][0] - ms0), c1 = ex2(m[mt][1] - ms1);
      m[mt][0] = mx0;
      m[mt][1] = mx1;
      l[mt][0] *= c0;
      l[mt][1] *= c1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[mt][n][0] *= c0;
        o[mt][n][1] *= c0;
        o[mt][n][2] *= c1;
        o[mt][n][3] *= c1;
      }
      // P, split, back into sa's registers: rows g, g + 8 of keys 2t4, 2t4 + 1
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float p0 = ex2(s[j][0] - ms0), p1 = ex2(s[j][1] - ms0);
        const float p2 = ex2(s[j][2] - ms1), p3 = ex2(s[j][3] - ms1);
        l[mt][0] += p0 + p1;
        l[mt][1] += p2 + p3;
        sa[0][mt][j][0] = p0;
        sa[0][mt][j][1] = p2;
        sa[0][mt][j][2] = p1;
        sa[0][mt][j][3] = p3;
      }
    }

    // O += P V: the A fragment's k index t4 stands for key 2t4, t4 + 4 for
    // key 2t4 + 1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(sa[0][mt][j][e], ah[mt][e], al[mt][e]);
      const float* v0 = Vt + (8 * j + 2 * t4) * ld + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[8 * n], bh0, bl0);
        split_tf32(v0[ld + 8 * n], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32(o[mt][n], ah[mt], al[mt], bh0, bh1, bl0, bl1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
  if (splits > 1) {
    // the key-split warps hand (m, l, O) to the group's first warp, lane by
    // lane: slot [(wk - 1) * groups + wr][MT][4 + 4 NO][32]
    constexpr int part = 32 * (4 + 4 * NO), slot = MT * part;
    __syncthreads();  // every warp is done with the tiles
    if (wk > 0) {
      float* x0 = fsm + (size_t)((wk - 1) * groups + wr) * slot + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* x = x0 + mt * part;
        x[0] = m[mt][0];
        x[32] = m[mt][1];
        x[64] = l[mt][0];
        x[96] = l[mt][1];
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[32 * (4 + 4 * n + e)] = o[mt][n][e];
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int k = 1; k < splits; ++k) {
      const float* x0 = fsm + (size_t)((k - 1) * groups + wr) * slot + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* x = x0 + mt * part;
        // the first warp's keys of the block's first tile lie below T, so
        // its maxima are finite
        const float n0 = fmaxf(m[mt][0], x[0]), n1 = fmaxf(m[mt][1], x[32]);
        const float a0 = ex2(m[mt][0] - n0), b0 = ex2(x[0] - n0);
        const float a1 = ex2(m[mt][1] - n1), b1 = ex2(x[32] - n1);
        m[mt][0] = n0;
        m[mt][1] = n1;
        l[mt][0] = l[mt][0] * a0 + x[64] * b0;
        l[mt][1] = l[mt][1] * a1 + x[96] * b1;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[mt][n][0] = o[mt][n][0] * a0 + x[32 * (4 + 4 * n)] * b0;
          o[mt][n][1] = o[mt][n][1] * a0 + x[32 * (5 + 4 * n)] * b0;
          o[mt][n][2] = o[mt][n][2] * a1 + x[32 * (6 + 4 * n)] * b1;
          o[mt][n][3] = o[mt][n][3] * a1 + x[32 * (7 + 4 * n)] * b1;
        }
      }
    }
  }
  if (chunks > 1) {
    // a share of the keys: O unnormalised and (m, l) of each row, for
    // attn_f32_any_merge: part holds O as [pair][row][chunk][ch], then
    // (m, l) as [pair][row][chunk][2]
    const size_t entries = (size_t)(gridDim.x / (chunks * qtiles)) * T_ * chunks;
    float* pml = part + entries * ch;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int ra = q0 + wr * GR + 16 * mt + g, rb = ra + 8;
      const size_t ea = ((size_t)pair * T_ + ra) * chunks + chunk, eb = ea + 8 * (size_t)chunks;
      if (t4 == 0 && ra < T_) {
        pml[2 * ea] = m[mt][0];
        pml[2 * ea + 1] = l[mt][0];
      }
      if (t4 == 0 && rb < T_) {
        pml[2 * eb] = m[mt][1];
        pml[2 * eb + 1] = l[mt][1];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = 8 * n + 2 * t4;
        if (c < ch && ra < T_) part[ea * ch + c] = o[mt][n][0];
        if (c + 1 < ch && ra < T_) part[ea * ch + c + 1] = o[mt][n][1];
        if (c < ch && rb < T_) part[eb * ch + c] = o[mt][n][2];
        if (c + 1 < ch && rb < T_) part[eb * ch + c + 1] = o[mt][n][3];
      }
    }
    return;
  }
  const size_t C = (size_t)H * ch;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float i0 = 1.f / l[mt][0], i1 = 1.f / l[mt][1];
    const int ra = q0 + wr * GR + 16 * mt + g, rb = ra + 8;
    float* oa = out + ((size_t)b * T_ + ra) * C + (size_t)h * ch;
    float* obr = oa + 8 * C;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * t4;
      if (c < ch && ra < T_) oa[c] = o[mt][n][0] * i0;
      if (c + 1 < ch && ra < T_) oa[c + 1] = o[mt][n][1] * i0;
      if (c < ch && rb < T_) obr[c] = o[mt][n][2] * i1;
      if (c + 1 < ch && rb < T_) obr[c + 1] = o[mt][n][3] * i1;
    }
  }
}

// The output of attn_f32_any from the partial sums of its key chunks: a
// block a (pair, row), its threads over the channels, each merging the
// chunks in chunk order, so reruns are bit-identical.  Only small grids are
// chunked, so every index fits an int.
__global__ void __launch_bounds__(128)
attn_f32_any_merge(const float* __restrict__ part, float* __restrict__ out, int pairs, int T_,
                   int H, int ch, int chunks) {
  const int pr = blockIdx.x, e0 = pr * chunks;  // pair * T + row; its first chunk
  const float* pml = part + pairs * T_ * chunks * ch;
  // every chunk holds a key below T for every row, so each m is finite
  float mx = pml[2 * e0];
  for (int k = 1; k < chunks; ++k) mx = fmaxf(mx, pml[2 * (e0 + k)]);
  float sum = 0.f;
  for (int k = 0; k < chunks; ++k) sum += ex2(pml[2 * (e0 + k)] - mx) * pml[2 * (e0 + k) + 1];
  const float inv = 1.f / sum;
  const int pair = pr / T_, row = pr - pair * T_, b = pair / H, h = pair - b * H;
  float* o = out + ((size_t)(b * T_ + row) * H + h) * ch;
  for (int c = threadIdx.x; c < ch; c += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < chunks; ++k)
      acc += ex2(pml[2 * (e0 + k)] - mx) * part[(size_t)(e0 + k) * ch + c];
    o[c] = acc * inv;
  }
}

// ---------------------------------------------------------------------------
// fp32, heads wider than 256 (and more than 65535 heads): CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWideRows = 16;     // query rows per block
constexpr int kWideKeys = 64;     // keys per tile: 32 for each half of the block
constexpr int kWideRing = 4;      // chunk slots
constexpr int kWideThreads = 256;
// a slot: a Q chunk (16 rows) and a K chunk (64 rows) of 64 channels, or a
// V chunk; each chunk two halves of 32 channels, rows of 128 bytes
constexpr int kWideSlot = (kWideRows + kWideKeys) * 256;

__host__ __forceinline__ size_t wide_smem() {
  return 1024 + (size_t)kWideRing * kWideSlot + kWideKeys * kWideRows * sizeof(float) +
         8 * kWideRing;
}

// Byte offset of float4 c4 (channels 4c4 .. 4c4+3) of row r in a chunk of
// nr rows: two halves of 32 channels, each nr rows of 128 bytes whose 16-byte
// pieces are permuted by r % 8 (the 128-byte swizzle TMA writes)
__device__ __forceinline__ uint32_t wide_off(int r, int c4, int nr) {
  return (uint32_t)((c4 >> 3) * nr * 128 + r * 128 + (((c4 & 7) ^ (r & 7)) << 4));
}

// Rows r0 .. r0+nr-1 of a matrix at src (row stride ld floats; rows at or
// past nrows read as 0), channels c0 .. c0+63 (at or past ncols: 0), into
// the chunk at dst, element by element (the path for ch % 4 != 0).
__device__ __forceinline__ void f32_chunk(uint8_t* dst, const float* src, size_t ld, int r0,
                                          int nr, int nrows, int c0, int ncols) {
  for (int i = threadIdx.x; i < nr * 64; i += kWideThreads) {
    const int r = i >> 6, c = i & 63, row = r0 + r, cc = c0 + c;
    *reinterpret_cast<float*>(dst + wide_off(r, c >> 2, nr) + 4 * (c & 3)) =
        row < nrows && cc < ncols ? src[(size_t)row * ld + cc] : 0.f;
  }
}

// Any ch and any number of (batch, head) pairs, flash attention without a
// workspace.  A block takes 16 query rows of one pair and a slice of sw
// output channels (a multiple of 64, at most 64 * NV; ch / sw slices,
// rounded up; the logits are recomputed for each).  Chunks of 64 channels
// pass through a ring of kWideRing slots, one barrier a chunk: for each tile
// of 64 keys the Q and K chunks of the whole head width, then the slice's V
// chunks, copied three chunks ahead by TMA (16-row boxes of 32 channels,
// 128-byte swizzle, an mbarrier a slot; element by element when ch % 4 !=
// 0).  The block's two halves run an online softmax each over their 32 keys
// of every tile (two warps a scheduler), merged at the end.  Thread (tr, tl)
// = (t / 16, t % 16) of a half holds the logits of rows 2tr, 2tr+1 and keys
// tl, tl + 16, summed over the K chunks with each float4 of Q and K read
// from shared memory serving 8 FMAs, and O of the same rows and channels
// 64v + 4tl .. +3 of V chunk v (8 NV floats); the weights pass through
// shared memory ([key][row]) between the two.  Softmax in fp32 (row max by
// 16-lane shuffles, exp2f).
template <int NV>
__global__ void __launch_bounds__(kWideThreads)
attn_wide(const __grid_constant__ CUtensorMap tmap, const float* __restrict__ qkv,
          float* __restrict__ out, int T_, int H, int ch, int slices, int sw,
          float scale_log2) {
  extern __shared__ __align__(16) uint8_t wide_raw[];
  const uint32_t raw = smem_u32(wide_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* sm = wide_raw + pad;
  const uint32_t sb = raw + pad;
  float* Ps = reinterpret_cast<float*>(sm + kWideRing * kWideSlot);  // [kWideKeys][kWideRows]
  const uint32_t bars = sb + kWideRing * kWideSlot + kWideKeys * kWideRows * 4;
  const int half = threadIdx.x / 128, t = threadIdx.x % 128, tr = t >> 4, tl = t & 15;
  const int kb = 32 * half;  // the half's first key of a tile
  const int qtiles = (T_ + kWideRows - 1) / kWideRows;
  long long blk = blockIdx.x;
  const int slice = (int)(blk % slices);
  blk /= slices;
  const int q0 = (int)(blk % qtiles) * kWideRows;
  const long long bh = blk / qtiles, b = bh / H;
  const int h = (int)(bh % H);
  const size_t W3 = (size_t)3 * H * ch;
  const float* base = qkv + (size_t)b * T_ * W3 + (size_t)h * 3 * ch;
  const int s0 = slice * sw;
  const int nq = (ch + 63) / 64;
  const int nv = (min(sw, ch - s0) + 63) / 64;
  const bool vec = ch % 4 == 0;  // rows on 16-byte boundaries: TMA
  const int L = nq + nv;
  const int total = ((T_ + kWideKeys - 1) / kWideKeys) * L;
  constexpr int ahead = kWideRing - 1;

  // chunk n: key tile n / L; i = n % L < nq is Q chunk i (at the slot's
  // start) and K chunk i (after it), else the slice's V chunk i - nq
  auto issue = [&](int n) {  // one thread, by TMA
    const int j = n / L, i = n - j * L;
    const uint32_t slot = sb + (uint32_t)(n % kWideRing) * kWideSlot;
    const uint32_t bar = bars + 8 * (n % kWideRing);
    if (i < nq) {
      mbar_expect(bar, kWideSlot);
      for (int hc = 0; hc < 2; ++hc) {
        tma_chunk(slot + hc * kWideRows * 128, &tmap, bar, 64 * i + 32 * hc, 0, h, q0, (int)b);
        for (int r = 0; r < kWideKeys; r += 16)
          tma_chunk(slot + kWideRows * 256 + hc * kWideKeys * 128 + r * 128, &tmap, bar,
                    64 * i + 32 * hc, 1, h, kWideKeys * j + r, (int)b);
      }
    } else {
      mbar_expect(bar, kWideKeys * 256);
      for (int hc = 0; hc < 2; ++hc)
        for (int r = 0; r < kWideKeys; r += 16)
          tma_chunk(slot + hc * kWideKeys * 128 + r * 128, &tmap, bar,
                    s0 + 64 * (i - nq) + 32 * hc, 2, h, kWideKeys * j + r, (int)b);
    }
  };
  auto load = [&](int n) {  // every thread, element by element
    const int j = n / L, i = n - j * L;
    uint8_t* slot = sm + (n % kWideRing) * kWideSlot;
    if (i < nq) {
      f32_chunk(slot, base, W3, q0, kWideRows, T_, 64 * i, ch);
      f32_chunk(slot + kWideRows * 256, base + ch, W3, kWideKeys * j, kWideKeys, T_, 64 * i, ch);
    } else {
      f32_chunk(slot, base + 2 * ch, W3, kWideKeys * j, kWideKeys, T_, s0 + 64 * (i - nq), ch);
    }
  };
  if (vec && threadIdx.x == 0) {
    for (int i = 0; i < kWideRing; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int n = 0; n < ahead && n < total; ++n) issue(n);
  }
  __syncthreads();  // the mbarriers are initialised

  float o[NV][2][4];  // [V chunk][row 2tr + r][channel 4tl + e]
  float s[2][2];      // [row 2tr + r][key kb + tl + 16u]
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[v][r][e] = 0.f;
  }

#pragma unroll 1
  for (int n = 0; n < total; ++n) {
    if (vec) {
      mbar_wait(bars + 8 * (n % kWideRing), (uint32_t)(n / kWideRing) & 1u);  // chunk n landed
      __syncthreads();  // and every thread is done with chunk n - 1, whose slot is refilled
      if (threadIdx.x == 0 && n + ahead < total) issue(n + ahead);
    } else {
      __syncthreads();  // every thread is done with chunk n - 1
      load(n);
      __syncthreads();
    }
    const int j = n / L, i = n - j * L;
    const uint8_t* slot = sm + (n % kWideRing) * kWideSlot;
    if (i < nq) {
      if (i == 0) s[0][0] = s[0][1] = s[1][0] = s[1][1] = 0.f;
      const uint8_t* kc = slot + kWideRows * 256;
#pragma unroll
      for (int c4 = 0; c4 < 16; ++c4) {
        float4 qv[2], kv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          qv[r] = *reinterpret_cast<const float4*>(slot + wide_off(2 * tr + r, c4, kWideRows));
#pragma unroll
        for (int u = 0; u < 2; ++u)
          kv[u] = *reinterpret_cast<const float4*>(kc + wide_off(kb + tl + 16 * u, c4, kWideKeys));
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            s[r][u] = fmaf(qv[r].x, kv[u].x, s[r][u]);
            s[r][u] = fmaf(qv[r].y, kv[u].y, s[r][u]);
            s[r][u] = fmaf(qv[r].z, kv[u].z, s[r][u]);
            s[r][u] = fmaf(qv[r].w, kv[u].w, s[r][u]);
          }
      }
      if (i < nq - 1) continue;
      // the tile's logits are whole: online softmax, the weights to Ps
      // (read from the next chunk on, after its barrier)
      const int k0 = j * kWideKeys + kb;
      float p[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          s[r][u] = k0 + tl + 16 * u < T_ ? s[r][u] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[r][u]);
        }
#pragma unroll
        for (int off = 1; off < 16; off *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        // a half whose keys so far are all past T keeps m = -inf (and 0 weights)
        const float ms = mx == -INFINITY ? 0.f : mx;
        const float corr = exp2f(m[r] - ms);
        m[r] = mx;
        l[r] *= corr;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[v][r][e] *= corr;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          p[r][u] = exp2f(s[r][u] - ms);
          l[r] += p[r][u];
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        *reinterpret_cast<float2*>(Ps + (kb + tl + 16 * u) * kWideRows + 2 * tr) =
            make_float2(p[0][u], p[1][u]);
    } else {
      const int v = i - nq;
      const float* pr = Ps + kb * kWideRows + 2 * tr;
#pragma unroll
      for (int vv = 0; vv < NV; ++vv) {
        if (vv != v) continue;
#pragma unroll 8
        for (int k = 0; k < kWideKeys / 2; ++k) {
          const float2 pk = *reinterpret_cast<const float2*>(pr + k * kWideRows);
          const float4 x = *reinterpret_cast<const float4*>(slot + wide_off(kb + k, tl, kWideKeys));
          o[vv][0][0] = fmaf(pk.x, x.x, o[vv][0][0]);
          o[vv][0][1] = fmaf(pk.x, x.y, o[vv][0][1]);
          o[vv][0][2] = fmaf(pk.x, x.z, o[vv][0][2]);
          o[vv][0][3] = fmaf(pk.x, x.w, o[vv][0][3]);
          o[vv][1][0] = fmaf(pk.y, x.x, o[vv][1][0]);
          o[vv][1][1] = fmaf(pk.y, x.y, o[vv][1][1]);
          o[vv][1][2] = fmaf(pk.y, x.z, o[vv][1][2]);
          o[vv][1][3] = fmaf(pk.y, x.w, o[vv][1][3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 16; off *= 2) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);

  // merge the halves: the second hands (m, l, O) to the first through the ring
  __syncthreads();
  float* xo = reinterpret_cast<float*>(sm);  // [8 NV][128]: O of the second half
  float* xm = xo + 8 * NV * 128;             // [kWideRows]
  float* xl = xm + kWideRows;                // [kWideRows]
  if (half == 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) xo[((v * 2 + r) * 4 + e) * 128 + t] = o[v][r][e];
    if (tl == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xm[2 * tr + r] = m[r];
        xl[2 * tr + r] = l[r];
      }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the first half's keys start at 0 < T, so mn is finite
    const float mb = xm[2 * tr + r], mn = fmaxf(m[r], mb);
    const float ca = exp2f(m[r] - mn), cb = exp2f(mb - mn);
    const float inv = 1.f / (l[r] * ca + xl[2 * tr + r] * cb);
    const int row = q0 + 2 * tr + r;
    float* orow = out + ((size_t)b * T_ + row) * ((size_t)H * ch) + (size_t)h * ch;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = s0 + 64 * v + 4 * tl;
      if (row >= T_ || c >= ch || 64 * v >= sw) continue;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        y[e] = (o[v][r][e] * ca + xo[((v * 2 + r) * 4 + e) * 128 + t] * cb) * inv;
      if (vec) {
        *reinterpret_cast<float4*>(orow + c) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < ch) orow[c + e] = y[e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int NV>
cudaError_t launch_wide(const void* qkv, void* out, int B, int T_, int H, int ch, int sw,
                        cudaStream_t st) {
  const int slices = (ch + sw - 1) / sw;
  unsigned blocks;
  cudaError_t e = sliced_grid(B, T_, H, kWideRows, slices, &blocks);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(attn_wide<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wide_smem());
  if (e != cudaSuccess) return e;
  CUtensorMap map = {};
  if (ch % 4 == 0) {
    e = qkv_tensor_map(&map, qkv, false, B, T_, H, ch, 16);
    if (e != cudaSuccess) return e;
  }
  attn_wide<NV><<<blocks, kWideThreads, wide_smem(), st>>>(
      map, static_cast<const float*>(qkv), static_cast<float*>(out), T_, H, ch, slices, sw,
      kLog2e / sqrtf((float)ch));
  return cudaGetLastError();
}

template <int NO>
cudaError_t launch_f32_any_n(const void* qkv, void* out, void* part, int B, int T_, int H,
                             int ch, int rows, int splits, int chunks, cudaStream_t st) {
  constexpr int MT = f32_any_mtiles(NO);
  const auto kernel = attn_f32_any<NO, MT>;
  const size_t smem = f32_any_smem(ch, rows, splits);
  unsigned blocks;
  cudaError_t e = sliced_grid(B, T_, H, rows, chunks, &blocks);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<blocks, 2 * rows * splits / MT, smem, st>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<float*>(part), T_,
      H, ch, rows, chunks, kLog2e / sqrtf((float)ch));
  if (chunks == 1) return cudaGetLastError();
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_f32_any_merge<<<B * H * T_, 128, 0, st>>>(static_cast<const float*>(part),
                                                  static_cast<float*>(out), B * H, T_, H, ch,
                                                  chunks);
  return cudaGetLastError();
}

cudaError_t launch_f32_any(const void* qkv, void* out, void* part, int B, int T_, int H, int ch,
                           int rows, int splits, int chunks, cudaStream_t st) {
  switch (f32_any_tiles(ch)) {
#define DIFFPIR_F32_ANY(NO) \
  case NO:                  \
    return launch_f32_any_n<NO>(qkv, out, part, B, T_, H, ch, rows, splits, chunks, st)
    DIFFPIR_F32_ANY(1);
    DIFFPIR_F32_ANY(2);
    DIFFPIR_F32_ANY(3);
    DIFFPIR_F32_ANY(4);
    DIFFPIR_F32_ANY(6);
    DIFFPIR_F32_ANY(8);
    DIFFPIR_F32_ANY(10);
    DIFFPIR_F32_ANY(12);
    DIFFPIR_F32_ANY(16);
    DIFFPIR_F32_ANY(20);
    DIFFPIR_F32_ANY(24);
    DIFFPIR_F32_ANY(32);
#undef DIFFPIR_F32_ANY
    default:
      return cudaErrorInvalidValue;
  }
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

// The tuned kernels take (batch, head) pairs on grid y, at most 65535 of
// them: more pairs run as several launches over whole samples.
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
    else e = launch<64>(q, o, nb, T_, H, rows, bf16, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// Returns a cudaError_t.  variant, as kernels/attention.py's attention_plan
// names it: 0 tuned (ch 16, 32 or 64, at most 65535 heads; rows, the query
// rows per block, 16, 32, 64 or, in bf16, 128), 1 attn_bf16_any (bf16, any
// ch and heads; rows 64 or 128, one or two warpgroups; slice_ch output
// channels per block, 32, 64, 96, 128, 192 or 256), 2 attn_f32_any (fp32,
// ch up to 256, any heads; rows a multiple of a row group, 32 query rows
// up to 128 channels and 16 beyond, key_splits warps a row group, at most 8
// warps; kv_chunks blocks a query tile, each a share of the key tiles, their
// partial sums in workspace, B * heads * T * kv_chunks * (ch + 2) floats,
// where kv_chunks > 1), 3 attn_wide (fp32, any ch and heads;
// slice_ch a multiple of 64 up to 512).  qkv and out must be 16-byte
// aligned.
extern "C" int diffpir_legacy_qkv_attention(const void* qkv, void* out, void* workspace, int B,
                                            int T, int heads, int ch, int variant, int rows,
                                            int slice_ch, int key_splits, int kv_chunks,
                                            int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || heads <= 0 || ch <= 0 ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      if ((ch != 16 && ch != 32 && ch != 64) || heads > 65535 ||
          (rows != 16 && rows != 32 && rows != 64 && !(is_bf16 && rows == 128)))
        return (int)cudaErrorInvalidValue;
      return (int)launch_pairs(qkv, out, B, T, heads, ch, rows, is_bf16, st);
    case 1:
      if (!is_bf16 || (rows != 64 && rows != 128)) return (int)cudaErrorInvalidValue;
      return (int)diffpir_attn_bf16_any(qkv, out, B, T, heads, ch, rows, slice_ch, st);
    case 2:
      if (is_bf16 || ch > kAnyMaxCh || kv_chunks <= 0 ||
          (kv_chunks > 1 && (workspace == nullptr ||
                             (long long)B * heads * T * kv_chunks * (ch + 2) > 0x7fffffffLL)))
        return (int)cudaErrorInvalidValue;
      if (const int mt = f32_any_mtiles(f32_any_tiles(ch));
          rows <= 0 || rows % (16 * mt) || key_splits <= 0 || rows * key_splits > 128 * mt ||
          f32_any_smem(ch, rows, key_splits) > kMaxDynSmem ||
          kv_chunks > (T + kAnyWarpKeys * key_splits - 1) / (kAnyWarpKeys * key_splits))
        return (int)cudaErrorInvalidValue;
      return (int)launch_f32_any(qkv, out, workspace, B, T, heads, ch, rows, key_splits,
                                 kv_chunks, st);
    case 3:
      if (is_bf16 || slice_ch <= 0 || slice_ch % 64 || slice_ch > 512)
        return (int)cudaErrorInvalidValue;
      return (int)(slice_ch <= 256 ? launch_wide<4>(qkv, out, B, T, heads, ch, slice_ch, st)
                                   : launch_wide<8>(qkv, out, B, T, heads, ch, slice_ch, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
