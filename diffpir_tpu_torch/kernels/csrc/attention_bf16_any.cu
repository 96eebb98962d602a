// attn_bf16_any: the legacy-QKV attention kernel for every bf16 head width
// but the tuned ones (16, 32, 64) and any number of heads, on wgmma fed by
// TMA.  Replaces, with the kernels of attention.cu, the TPU kernel
// diffpir_tpu/pallas/attention.py::legacy_qkv_attention; the design notes
// for all the attention kernels, and the C entry, are in attention.cu.  A
// file of its own, so that nvcc compiles it beside attention.cu.

#include "attention_common.cuh"

namespace {

constexpr int kChunk = 64 * 128;  // bytes of a chunk: 64 rows of 64 bf16
constexpr int kPartBytes = 32768; // bytes of K chunks a step consumes at most
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have
constexpr int kBars = 5;          // mbarriers: 4 slots and Q

// Key tile of attn_bf16_any: 128 keys where the registers hold S and P of
// that many beside O (NV <= 128), else 64
__host__ __device__ constexpr int bf16_any_keys(int nv) { return nv <= 128 ? 128 : 64; }

// Shared memory of attn_bf16_any for a head of nq chunks of 64 channels,
// key tiles of kt rows, a slice of nvc V chunks and wgs warpgroups: 1 KB to
// align the chunks to the swizzle's 1024-byte period, Q's nq * wgs chunks
// (64 rows each) where they fit beside 4 slots (else Q's chunks travel in
// the slots beside K's, and 3 slots), the slots, each of the largest part a
// step consumes (pcs chunks of kt rows), and the mbarriers.
struct WgLayout {
  bool qres;            // Q resident
  int part;             // K chunks of a part
  int pcs;              // chunks of kt rows a slot holds
  int slots;            // slots of the ring
  uint32_t slot_bytes;  // bytes of a slot
  uint32_t ring;        // offset of the ring (after Q)
};
__host__ __device__ __forceinline__ WgLayout wg_layout(int nq, int kt, int nvc, int wgs) {
  WgLayout l;
  const int kv = kt * 128;  // bytes of a K or V chunk
  l.part = kPartBytes / kv;
  l.pcs = nq < l.part ? nq : l.part;
  if (nvc > l.pcs) l.pcs = nvc;
  l.qres = 1024LL + 8 * kBars + (long long)nq * wgs * kChunk + 4LL * l.pcs * kv <= kMaxSmem;
  l.slot_bytes = (uint32_t)(l.pcs * kv + (l.qres ? 0 : l.part * wgs * kChunk));
  l.slots = l.qres ? 4 : (int)((kMaxSmem - 1024 - 8 * kBars) / l.slot_bytes);
  if (l.slots > 4) l.slots = 4;
  l.ring = l.qres ? (uint32_t)(nq * wgs) * kChunk : 0u;
  return l;
}

__host__ __forceinline__ size_t bf16_any_smem(const WgLayout& l) {
  return 1024 + (size_t)l.ring + (size_t)l.slots * l.slot_bytes + 8 * kBars;
}

// Byte offset of 16-byte piece p of row r in a chunk: rows of 128 bytes
// whose pieces are permuted by r % 8, the 128-byte swizzle wgmma reads.
__device__ __forceinline__ uint32_t swz(int r, int p) {
  return (uint32_t)(r * 128 + ((p ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0+63 of a matrix at src (row stride ld elements; rows at or
// past nrows read as 0), channels c0 .. c0+8*pieces-1 (at or past ncols: 0),
// into the chunk at shared address dst (generic address dstp).  With vec
// (rows on 16-byte boundaries, ncols a multiple of 8) by 16-byte cp.async,
// else element by element, each 16-byte piece stored at once.  The kernel
// takes the second branch alone (TMA copies where rows are aligned), but
// without the first and the cp.async waits ptxas reported its wgmma
// products serialized (C7515), and the kernel ran 20 % slower.
__device__ __forceinline__ void bf16_chunk(uint8_t* dstp, uint32_t dst, const uint16_t* src,
                                           size_t ld, int r0, int nrows, int c0, int ncols,
                                           int pieces, bool vec) {
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < 64 * 8; i += blockDim.x) {
      const int r = i >> 3, p = i & 7;
      if (p >= pieces) continue;
      const int row = r0 + r, c = c0 + 8 * p;
      const bool ok = row < nrows && c < ncols;
      cp_async16_s(dst + swz(r, p), src + (ok ? (size_t)row * ld + c : 0), ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < 64 * 8; i += blockDim.x) {
      const int r = i >> 3, p = i & 7, row = r0 + r, c = c0 + 8 * p;
      if (p >= pieces) continue;
      uint16_t x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = row < nrows && c + e < ncols ? src[(size_t)row * ld + c + e] : uint16_t(0);
      *reinterpret_cast<uint4*>(dstp + swz(r, p)) =
          make_uint4(x[0] | (uint32_t)x[1] << 16, x[2] | (uint32_t)x[3] << 16,
                     x[4] | (uint32_t)x[5] << 16, x[6] | (uint32_t)x[7] << 16);
    }
  }
}

// wgmma shared-memory descriptor of a 128-byte swizzled tile at addr: 8-row
// groups 1024 bytes apart (the leading offset is unused by this layout)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
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
// keeps the compiler from moving accesses to r across a wgmma wait
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define DIFFPIR_F8(a)                                                                 \
  "+f"(d[a]), "+f"(d[a + 1]), "+f"(d[a + 2]), "+f"(d[a + 3]), "+f"(d[a + 4]),          \
      "+f"(d[a + 5]), "+f"(d[a + 6]), "+f"(d[a + 7])

// d[64 x 64] = A[64 x 16] B[64 x 16]^T (+ d with acc), A and B K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : DIFFPIR_F8(0), DIFFPIR_F8(8), DIFFPIR_F8(16), DIFFPIR_F8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 128] = A[64 x 16] B[128 x 16]^T (+ d with acc), as wgmma_ss_n64
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : DIFFPIR_F8(0), DIFFPIR_F8(8), DIFFPIR_F8(16), DIFFPIR_F8(24), DIFFPIR_F8(32),
        DIFFPIR_F8(40), DIFFPIR_F8(48), DIFFPIR_F8(56)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared
// memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : DIFFPIR_F8(0), DIFFPIR_F8(8), DIFFPIR_F8(16), DIFFPIR_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], as wgmma_rs_n64
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : DIFFPIR_F8(0), DIFFPIR_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef DIFFPIR_F8

// Any head width ch and any number of (batch, head) pairs.  A block is one
// or two warpgroups (blockDim.x / 128), each of 64 query rows of one pair,
// and takes a slice of NV output channels (NV a multiple of 32 up to 256;
// ch / NV slices, rounded up), kept in registers as wgmma accumulators (NV / 2
// floats a thread).  The warpgroups share the K and V chunks, so two of them
// halve the copies from L2 for each query row.  Keys go in tiles of KT (128
// where the registers hold S and P of that many, else 64).  Shared memory
// holds chunks of 64 channels (128-byte rows, 128-byte swizzle), zero past T
// and past ch: Q's (64 rows a warpgroup; resident where they fit, else
// streamed beside K's) and a ring of slots through which each key tile
// passes in parts, one barrier and one wgmma group a part: its K chunks (KT
// rows; up to 32 KB a part), then the slice's V chunks (the last of 32
// channels when NV % 64 = 32), copied two parts ahead (one with Q streamed)
// by TMA (the tensor map tmap, completion on an mbarrier a slot), or, when
// ch % 8 != 0 leaves rows off 16-byte boundaries, element by element.  A
// part's wgmma group stays in flight while the next part's barrier and
// copies are issued; its slot is refilled two parts later.  S = Q.K^T by
// wgmma m64nKTk16 (both K-major), summed over the K chunks; the online
// softmax on the accumulator fragments (fp32, exp2); the unnormalised
// weights rounded to bf16 as the register A operand of O += P.V (wgmma
// m64n64k16 / m64n32k16 a V chunk, V MN-major); the row sums divide O at
// the end.
template <int NV>
__global__ void __launch_bounds__(256, 1)
attn_bf16_any(const __grid_constant__ CUtensorMap tmap, const __nv_bfloat16* __restrict__ qkv,
              __nv_bfloat16* __restrict__ out, int T_, int H, int ch, int slices,
              float scale_log2) {
  constexpr int KT = bf16_any_keys(NV);  // keys of a tile
  constexpr int KV = KT * 128;           // bytes of a K or V chunk
  constexpr int NVC = (NV + 63) / 64;    // V chunks of the slice
  constexpr bool kHalf = NV % 64 != 0;   // the last V chunk holds 32 channels
  constexpr int NS = KT / 2;             // S values a thread
  constexpr int KS = KT / 16;            // k-steps of P.V
  extern __shared__ __align__(16) uint8_t wg_raw[];
  const uint32_t raw = smem_u32(wg_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* sm = wg_raw + pad;
  const uint32_t sb = raw + pad;

  const int wgs = blockDim.x / 128, wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int qtiles = (T_ + 64 * wgs - 1) / (64 * wgs);
  long long blk = blockIdx.x;
  const int slice = (int)(blk % slices);
  blk /= slices;
  const int q0 = (int)(blk % qtiles) * 64 * wgs;
  const long long bh = blk / qtiles, b = bh / H;
  const int h = (int)(bh % H);
  const size_t W3 = (size_t)3 * H * ch;
  const uint16_t* base =
      reinterpret_cast<const uint16_t*>(qkv) + (size_t)b * T_ * W3 + (size_t)h * 3 * ch;
  const int s0 = slice * NV;
  const int nq = (ch + 63) / 64;  // K chunks of a key tile
  const WgLayout lay = wg_layout(nq, KT, NVC, wgs);
  const int kp = (nq + lay.part - 1) / lay.part;  // K parts of a key tile
  const bool vec = ch % 8 == 0;  // rows on 16-byte boundaries: TMA
  const int ahead = lay.slots - 2;  // parts copied ahead of the one consumed
  const int L = kp + 1;             // parts of a key tile
  const int total = ((T_ + KT - 1) / KT) * L;
  // an mbarrier for each slot, and Q's
  const uint32_t bars = sb + lay.ring + (uint32_t)lay.slots * lay.slot_bytes;
  const uint32_t qbar = bars + 8 * (kBars - 1);

  // part n: key tile n / L; p = n % L < kp holds K chunks part * p .. (beside
  // Q's chunks when Q is streamed: chunk (k, w) after the K chunks), p = kp
  // the slice's V chunks.  With vec one thread asks TMA for them (issue),
  // else every thread copies (load).  A chunk of KT rows is KT / 64 boxes.
  auto issue = [&](int n) {
    const int j = n / L, p = n - j * L;
    const uint32_t off = sb + lay.ring + (uint32_t)(n % lay.slots) * lay.slot_bytes;
    const uint32_t bar = bars + 8 * (n % lay.slots);
    if (p < kp) {
      const int cnt = min(lay.part, nq - lay.part * p);
      mbar_expect(bar, (uint32_t)cnt * (KV + (lay.qres ? 0 : wgs * kChunk)));
      for (int k = 0; k < cnt; ++k) {
        const int c = lay.part * p + k;
        for (int r = 0; r < KT; r += 64)
          tma_chunk(off + k * KV + r * 128, &tmap, bar, 64 * c, 1, h, KT * j + r, (int)b);
        if (!lay.qres)
          for (int w = 0; w < wgs; ++w)
            tma_chunk(off + lay.pcs * KV + (k * wgs + w) * kChunk, &tmap, bar, 64 * c, 0, h,
                      q0 + 64 * w, (int)b);
      }
    } else {
      mbar_expect(bar, NVC * KV);
      for (int v = 0; v < NVC; ++v)
        for (int r = 0; r < KT; r += 64)
          tma_chunk(off + v * KV + r * 128, &tmap, bar, s0 + 64 * v, 2, h, KT * j + r, (int)b);
    }
  };
  auto load = [&](int n) {
    const int j = n / L, p = n - j * L;
    const uint32_t off = lay.ring + (uint32_t)(n % lay.slots) * lay.slot_bytes;
    if (p < kp) {
      const int cnt = min(lay.part, nq - lay.part * p);
      for (int k = 0; k < cnt; ++k) {
        const int c = lay.part * p + k;
        for (int r = 0; r < KT; r += 64)
          bf16_chunk(sm + off + k * KV + r * 128, sb + off + k * KV + r * 128, base + ch, W3,
                     KT * j + r, T_, 64 * c, ch, 8, vec);
        if (!lay.qres)
          for (int w = 0; w < wgs; ++w) {
            const uint32_t qo = off + lay.pcs * KV + (k * wgs + w) * kChunk;
            bf16_chunk(sm + qo, sb + qo, base, W3, q0 + 64 * w, T_, 64 * c, ch, 8, vec);
          }
      }
    } else {
#pragma unroll
      for (int v = 0; v < NVC; ++v)
        for (int r = 0; r < KT; r += 64)
          bf16_chunk(sm + off + v * KV + r * 128, sb + off + v * KV + r * 128, base + 2 * ch, W3,
                     KT * j + r, T_, s0 + 64 * v, ch, kHalf && v == NVC - 1 ? 4 : 8, vec);
    }
  };
  // Q chunk (c, w) at (c * wgs + w) * kChunk when resident
  if (vec) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kBars; ++i) mbar_init(bars + 8 * i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (lay.qres) {
        mbar_expect(qbar, (uint32_t)(nq * wgs) * kChunk);
        for (int c = 0; c < nq * wgs; ++c)
          tma_chunk(sb + c * kChunk, &tmap, qbar, 64 * (c / wgs), 0, h, q0 + 64 * (c % wgs),
                    (int)b);
      }
      for (int n = 0; n < ahead && n < total; ++n) issue(n);
    }
    __syncthreads();  // the mbarriers are initialised
    if (lay.qres) mbar_wait(qbar, 0);
  } else {
    if (lay.qres)
      for (int c = 0; c < nq * wgs; ++c)
        bf16_chunk(sm + c * kChunk, sb + c * kChunk, base, W3, q0 + 64 * (c % wgs), T_,
                   64 * (c / wgs), ch, 8, vec);
#pragma unroll 1
    for (int n = 0; n < ahead; ++n) {  // Q joins the first group
      if (n < total) load(n);
      cp_async_commit();
    }
  }

  // accumulators: S of a key tile (n-tile jt of 8 keys: s[4jt + e], e = 0, 1
  // row g, keys 8jt + 2t4 + e; e = 2, 3 row g + 8) and O in the same layout
  // (V chunk v at o[32v ..])
  float o[NV / 2], s[NS];
  uint32_t pa[KS][4];  // P of the key tile as A fragments, 16 keys each
#pragma unroll
  for (int e = 0; e < NV / 2; ++e) o[e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

#pragma unroll 1
  for (int n = 0; n < total; ++n) {
    if (vec) {
      mbar_wait(bars + 8 * (n % lay.slots), (uint32_t)(n / lay.slots) & 1u);  // part n landed
    } else {
      if (ahead == 2) cp_async_wait<1>();  // part n has landed (this thread's copies)
      else cp_async_wait<0>();
      fence_proxy_async();
    }
    __syncthreads();  // ... for every thread; and part n - 2's wgmma group is done
    if (vec) {
      if (threadIdx.x == 0 && n + ahead < total) issue(n + ahead);
    } else {
      if (n + ahead < total) load(n + ahead);
      cp_async_commit();
    }
    const int j = n / L, p = n - j * L;
    const uint32_t slot = sb + lay.ring + (uint32_t)(n % lay.slots) * lay.slot_bytes;
    if (p < kp) {
      const int cnt = min(lay.part, nq - lay.part * p);
      wg_fence();
#pragma unroll
      for (int k = 0; k < kPartBytes / KV; ++k) {
        if (k >= cnt) break;
        const int c = lay.part * p + k;
        const uint32_t qa = lay.qres ? sb + (uint32_t)(c * wgs + wg) * kChunk
                                     : slot + lay.pcs * KV + (uint32_t)(k * wgs + wg) * kChunk;
        const uint32_t ka = slot + (uint32_t)k * KV;
        const int ks = min(4, (ch - 64 * c + 15) >> 4);  // k-steps of 16 channels
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk >= ks) break;
          // the tile's first product overwrites S (no store may touch it
          // while products are in flight)
          const uint64_t da = sw128_desc(qa + 32 * kk), db = sw128_desc(ka + 32 * kk);
          if (KT == 128) wgmma_ss_n128(s, da, db, c + kk > 0);
          else wgmma_ss_n64(s, da, db, c + kk > 0);
        }
      }
      wg_commit();
      if (p < kp - 1) {
        wg_wait<1>();
        continue;
      }
      wg_wait<0>();
      reg_fence<NS>(s);
      reg_fence<NV / 2>(o);

      // online softmax of the tile's logits
      const int k0 = j * KT;
      if (k0 + KT > T_) {  // the ragged last tile: keys at or past T drop out
#pragma unroll
        for (int jt = 0; jt < KT / 8; ++jt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * jt + 2 * t4 + (e & 1) >= T_) s[4 * jt + e] = -INFINITY;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jt = 0; jt < KT / 8; ++jt) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * jt], s[4 * jt + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * jt + 2], s[4 * jt + 3]));
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
      for (int e = 0; e < NV / 2; e += 4) {
        o[e] *= c0f;
        o[e + 1] *= c0f;
        o[e + 2] *= c1f;
        o[e + 3] *= c1f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        float pr[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          pr[e] = ex2(fmaf(s[8 * kk + e], scale_log2, (e & 2) ? -sub1 : -sub0));
        l0 += pr[0] + pr[1] + pr[4] + pr[5];
        l1 += pr[2] + pr[3] + pr[6] + pr[7];
        pa[kk][0] = pack_bf16(pr[0], pr[1]);
        pa[kk][1] = pack_bf16(pr[2], pr[3]);
        pa[kk][2] = pack_bf16(pr[4], pr[5]);
        pa[kk][3] = pack_bf16(pr[6], pr[7]);
      }
    } else {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {  // 16 keys: 16 rows of 128 bytes
#pragma unroll
        for (int vv = 0; vv < NVC; ++vv) {
          const uint64_t db = sw128_desc(slot + vv * KV + 2048 * kk);
          if (kHalf && vv == NVC - 1) wgmma_rs_n32(o + 32 * vv, pa[kk], db);
          else wgmma_rs_n64(o + 32 * vv, pa[kk], db);
        }
      }
      wg_commit();
      wg_wait<1>();
    }
  }
  wg_wait<0>();
  reg_fence<NV / 2>(o);
  if (!vec) cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv[2] = {1.f / l0, 1.f / l1};
  const int ra = q0 + 64 * wg + 16 * warp + g;
  const size_t C = (size_t)H * ch;
  __nv_bfloat16* ob = out + (size_t)b * T_ * C + (size_t)h * ch;
#pragma unroll
  for (int vv = 0; vv < NVC; ++vv) {
#pragma unroll
    for (int nt = 0; nt < (kHalf && vv == NVC - 1 ? 4 : 8); ++nt) {
      const int c = s0 + 64 * vv + 8 * nt + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = ra + 8 * r;
        if (row >= T_ || c >= ch) continue;
        const float x0 = o[32 * vv + 4 * nt + 2 * r] * inv[r];
        const float x1 = o[32 * vv + 4 * nt + 2 * r + 1] * inv[r];
        __nv_bfloat16* dst = ob + (size_t)row * C + c;
        if (ch % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
        } else {
          dst[0] = __float2bfloat16_rn(x0);
          if (c + 1 < ch) dst[1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

template <int NV>
cudaError_t launch_bf16_any(const void* qkv, void* out, int B, int T_, int H, int ch, int rows,
                            cudaStream_t st) {
  const int slices = (ch + NV - 1) / NV, wgs = rows / 64;
  unsigned blocks;
  cudaError_t e = sliced_grid(B, T_, H, rows, slices, &blocks);
  if (e != cudaSuccess) return e;
  const WgLayout lay = wg_layout((ch + 63) / 64, bf16_any_keys(NV), (NV + 63) / 64, wgs);
  if (lay.slots < 3) return cudaErrorInvalidValue;  // Q streamed for two warpgroups
  const size_t smem = bf16_any_smem(lay);
  e = cudaFuncSetAttribute(attn_bf16_any<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  CUtensorMap map = {};
  if (ch % 8 == 0) {
    e = qkv_tensor_map(&map, qkv, true, B, T_, H, ch, 64);
    if (e != cudaSuccess) return e;
  }
  attn_bf16_any<NV><<<blocks, 128 * wgs, smem, st>>>(map, static_cast<const __nv_bfloat16*>(qkv),
                                                static_cast<__nv_bfloat16*>(out), T_, H, ch,
                                                slices, kLog2e / sqrtf((float)ch));
  return cudaGetLastError();
}

}  // namespace

// attn_bf16_any for the C entry in attention.cu: slice_ch (the plan's
// output channels a block) picks the instantiation, rows (64 or 128) the
// warpgroups
cudaError_t diffpir_attn_bf16_any(const void* qkv, void* out, int B, int T, int heads, int ch,
                                  int rows, int slice_ch, cudaStream_t st) {
  switch (slice_ch) {
    case 32: return launch_bf16_any<32>(qkv, out, B, T, heads, ch, rows, st);
    case 64: return launch_bf16_any<64>(qkv, out, B, T, heads, ch, rows, st);
    case 96: return launch_bf16_any<96>(qkv, out, B, T, heads, ch, rows, st);
    case 128: return launch_bf16_any<128>(qkv, out, B, T, heads, ch, rows, st);
    case 192: return launch_bf16_any<192>(qkv, out, B, T, heads, ch, rows, st);
    case 256: return launch_bf16_any<256>(qkv, out, B, T, heads, ch, rows, st);
    default: return cudaErrorInvalidValue;
  }
}
