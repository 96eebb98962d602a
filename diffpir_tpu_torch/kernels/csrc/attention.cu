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
// Which kernel takes a call is decided in one place, kernels/attention.py
// attention_plan (variant, query rows, output slice), and passed to the C
// entry: "tuned" (attn_bf16, attn_f32) at ch 16, 32 and 64; "bf16_any"
// (attn_bf16_any) for every other bf16 width and head count; "f32_any"
// (attn_f32_any) for fp32 widths up to 256; "f32_wide" (attn_wide) beyond,
// and for more than 65535 heads in fp32.  The tuned kernels and
// attn_f32_any take the (batch, head) pairs on grid y, at most 65535; more
// pairs run as several launches over whole samples.  attn_bf16_any and
// attn_wide put (pair, query tile, output slice) on grid x.
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
// Design, attn_f32_any (fp32, widths 1 .. 256 but the tuned ones): a simple
// kernel on CUDA cores that takes ch at run time: 16 rows per block, 8
// lanes per row, Q and a 32-key K/V tile in shared memory (up to 82 KB at ch
// 256); every product reads shared memory, so it is slow.
//
// Design, attn_wide (fp32, heads wider than 256): the fp32 bars rule out
// TF32, so it runs on CUDA cores; bound: operations.  Flash attention with
// no logits workspace: 64-key tiles of S in registers with an online
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

template <typename Kernel>
cudaError_t launch_any(Kernel kernel, int rows, int threads, size_t smem, const void* qkv,
                       void* out, int B, int T_, int H, int ch, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((T_ + rows - 1) / rows, B * H);
  kernel<<<grid, threads, smem, st>>>(static_cast<const float*>(qkv), static_cast<float*>(out),
                                      T_, H, ch, kLog2e / sqrtf((float)ch));
  return cudaGetLastError();
}

cudaError_t launch_f32_any(const void* qkv, void* out, int B, int T_, int H, int ch,
                           cudaStream_t st) {
  const size_t smem = generic_smem(ch);
#define DIFFPIR_F32_ANY(NU) \
  return launch_any(attn_f32_any<NU>, kGenRows, kGenThreads, smem, qkv, out, B, T_, H, ch, st)
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

// The tuned kernels and attn_f32_any take (batch, head) pairs on grid y, at
// most 65535 of them: more pairs run as several launches over whole samples.
cudaError_t launch_pairs(const void* qkv, void* out, int B, int T_, int H, int ch, int rows,
                         bool bf16, bool tuned, cudaStream_t st) {
  const size_t esize = bf16 ? 2 : 4;
  const int per = 65535 / H;  // samples per launch
  for (int b0 = 0; b0 < B; b0 += per) {
    const int nb = B - b0 < per ? B - b0 : per;
    const void* q = static_cast<const char*>(qkv) + (size_t)b0 * T_ * 3 * H * ch * esize;
    void* o = static_cast<char*>(out) + (size_t)b0 * T_ * H * ch * esize;
    cudaError_t e;
    if (!tuned) e = launch_f32_any(q, o, nb, T_, H, ch, st);
    else if (ch == 16) e = launch<16>(q, o, nb, T_, H, rows, bf16, st);
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
// ch up to 256, at most 65535 heads), 3 attn_wide (fp32, any ch and heads;
// slice_ch a multiple of 64 up to 512).  qkv and out must be 16-byte
// aligned.
extern "C" int diffpir_legacy_qkv_attention(const void* qkv, void* out, int B, int T,
                                            int heads, int ch, int variant, int rows,
                                            int slice_ch, int is_bf16, void* stream) {
  if (B <= 0 || T <= 0 || heads <= 0 || ch <= 0 ||
      (reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      if ((ch != 16 && ch != 32 && ch != 64) || heads > 65535 ||
          (rows != 16 && rows != 32 && rows != 64 && !(is_bf16 && rows == 128)))
        return (int)cudaErrorInvalidValue;
      return (int)launch_pairs(qkv, out, B, T, heads, ch, rows, is_bf16, true, st);
    case 1:
      if (!is_bf16 || (rows != 64 && rows != 128)) return (int)cudaErrorInvalidValue;
      return (int)diffpir_attn_bf16_any(qkv, out, B, T, heads, ch, rows, slice_ch, st);
    case 2:
      if (is_bf16 || ch > kGenMaxCh || heads > 65535) return (int)cudaErrorInvalidValue;
      return (int)launch_pairs(qkv, out, B, T, heads, ch, rows, false, false, st);
    case 3:
      if (is_bf16 || slice_ch <= 0 || slice_ch % 64 || slice_ch > 512)
        return (int)cudaErrorInvalidValue;
      return (int)(slice_ch <= 256 ? launch_wide<4>(qkv, out, B, T, heads, ch, slice_ch, st)
                                   : launch_wide<8>(qkv, out, B, T, heads, ch, slice_ch, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
