// Exact attention forward (flash schedule) on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel of atomo_tpu/ops/attention_kernels.py:
//   flash_attention_forward <- flash_attention / _flash_forward (_fa_kernel)
//
// What it computes: for q, k, v of shape (B, H, S, D), float32 or bfloat16,
//   o[b, h, i] = sum_j softmax_j(scale * q[b, h, i] . k[b, h, j]) v[b, h, j]
// over j <= i when causal, with an online-softmax accumulator (m, l, acc) in
// float32 across key tiles, and o written in the input type. Keys past S are
// masked inside the kernel, so any S runs here (the TPU kernel needed S to
// divide by its blocks and otherwise fell back to the blockwise oracle, which
// gives the same numbers). The -inf guards are _fa_kernel's: a row whose every
// key so far is masked keeps m = -inf, contributes p = 0 and alpha = 0, and the
// final division is by max(l, FLT_MIN).
//
// Layout: q, k and v are read through their own (batch, head, row) element
// strides with unit stride along D, so the head views that a transformer
// takes of its fused qkv projection need no copy (the wrapper checks that
// every base address and stride is a multiple of 16 bytes, as the 16-byte
// asynchronous copies need); o is contiguous (B, H, S, D).
//
// Bound. At the LM recipe (B 16, H 4, S 1024, D 64, causal) one launch does
// 8.6 GFLOP of products (2 S*S*D for q.k^T and as many for p.v, halved by the
// mask) on 67 MB of q, k, v and o. Float32 accuracy on the tensor cores costs
// three TF32 products per product (below): 3 x 8.6 GFLOP at 495 TFLOP/s is
// 0.052 ms, against 0.020 ms of memory traffic at 3.35 TB/s, so it is bound
// by operations; bfloat16 inputs take one product at 989 TFLOP/s (0.009 ms).
// What the design does about it:
//   * both products run on the tensor cores as wgmma. A CTA holds NWG
//     warpgroups of 128 threads; warpgroup w owns 64 query rows and all of
//     them share each K/V tile. S = Q K^T reads both operands from shared
//     memory (m64nBKk8 TF32, m64nBKk16 bf16); O += P V takes P from
//     registers (m64nDk8, m64nDk16);
//   * float32 keeps float32 accuracy by 3xTF32 (CUTLASS's
//     OpMultiplyAddFastF32): every operand x is split into hi = tf32_rn(x)
//     and lo = x - hi, and lo.hi + hi.lo + hi.hi accumulate in float32. One
//     TF32 product keeps about three decimal digits; three keep the float32
//     result within a few 1e-7. bfloat16 inputs take one bf16 product each,
//     with P rounded to bf16;
//   * operands lie in shared memory in wgmma's K-major core-matrix layout
//     without swizzle: a core matrix is 8 rows of 16 bytes (128 contiguous
//     bytes), core matrices along K lie 128 bytes apart (the descriptor's
//     leading byte offset) and 8-row groups K-extent * 8 * element bytes apart
//     (its stride byte offset). The split pass writes one whole core matrix
//     with each 8 threads, so neither it nor wgmma meets a bank conflict;
//   * TF32 wgmma has no transposed B, so V is staged transposed (V^T: rows d,
//     K = key). Its key order inside each 8-key step is permuted, slot t <-
//     key 2t and slot t + 4 <- key 2t + 1, which makes the score
//     accumulator's registers P's A fragment as they lie: the probabilities
//     never touch shared memory (bf16's fragments line up without it);
//   * a pipeline over the key tiles: while tile j's S = Q K^T runs on the
//     tensor cores, the threads split and transpose tile j + 1 (already in
//     the raw stage) into the other of two operand stages, then start the
//     16-byte cp.async copies of tile j + 2; the products of tile j + 1 can
//     start as soon as tile j's are done;
//   * the online softmax runs on the accumulator fragments in registers: a
//     row's scores sit in the four threads of a quad, so row max and sum are
//     two shuffles; exp is ex2.approx of log2-scaled scores;
//   * one CTA walks its key tiles in a loop (the TPU kernel's sequential grid
//     axis); causal tiles above the CTA's diagonal are never loaded; the
//     heaviest causal query tiles are issued first. No branch parts the
//     warpgroups while a wgmma is in flight (ptxas would serialize them), so
//     the first warpgroup also multiplies the CTA's last causal tile, which
//     its mask zeroes.
// Shared memory per CTA (float32; bf16 halves it): Q hi/lo, two stages of
// K hi/lo and V^T hi/lo, one raw stage of K and V (which stages Q first):
//   D = 32:  2 warpgroups, 64-key tiles: 32 + 2 x 32 + 18 = 114 KB;
//   D = 64:  2 warpgroups, 64-key tiles: 64 + 2 x 64 + 34 = 226 KB;
//   D = 128: the same at 2 warpgroups would not fit, so one warpgroup (64
//            query rows) with 32-key tiles: 64 + 2 x 64 + 33 = 225 KB.
// The plain PyTorch twin (atomo_tpu_torch/ops/attention_kernels.py
// flash_attention_plain) runs the same recurrence with torch ops in float32;
// the two agree within 2e-5 (float32) and 2e-2 (bf16 inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// shared-memory writes of this thread become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous region
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x, flushing results below 2^-126 to 0 (they are far below p's float32
// resolution next to the row's largest term, which is 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float tf32_rn(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset 128 (next core matrix along K), stride byte offset `sbo` (next
// 8-row group), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const uint8_t* p, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// wgmma with the accumulator d (NREG = N / 2 floats a thread) and scale-d 1.
#define FA_ACC16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FA_ACC32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_ACC64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FA_OUT8(d, b)                                                                 \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define FA_OUT16(d) FA_OUT8(d, 0), FA_OUT8(d, 8)
#define FA_OUT32(d) FA_OUT16(d), FA_OUT8(d, 16), FA_OUT8(d, 24)
#define FA_OUT64(d) FA_OUT32(d), FA_OUT8(d, 32), FA_OUT8(d, 40), FA_OUT8(d, 48), FA_OUT8(d, 56)
// operand numbers after the accumulator: a-desc, b-desc, scale (SS);
// a0..a3, b-desc, scale (RS)
#define FA_SS_ARGS16 "%16, %17, p"
#define FA_SS_PRED16 "%18"
#define FA_SS_ARGS32 "%32, %33, p"
#define FA_SS_PRED32 "%34"
#define FA_RS_ARGS16 "{%16, %17, %18, %19}, %20, p"
#define FA_RS_PRED16 "%21"
#define FA_RS_ARGS32 "{%32, %33, %34, %35}, %36, p"
#define FA_RS_PRED32 "%37"
#define FA_RS_ARGS64 "{%64, %65, %66, %67}, %68, p"
#define FA_RS_PRED64 "%69"

#define FA_WGMMA_SS(NAME, NREG, INSTR, TAIL)                                          \
  __device__ __forceinline__ void NAME(float (&d)[NREG], uint64_t a, uint64_t b) {    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " FA_SS_PRED##NREG ", 0;\n" INSTR   \
                 " " FA_ACC##NREG ", " FA_SS_ARGS##NREG ", 1, 1" TAIL ";\n}\n"        \
                 : FA_OUT##NREG(d)                                                    \
                 : "l"(a), "l"(b), "r"(1)                                             \
                 : "memory");                                                         \
  }
#define FA_WGMMA_RS(NAME, NREG, INSTR, TAIL)                                          \
  __device__ __forceinline__ void NAME(float (&d)[NREG], const uint32_t (&a)[4],      \
                                       uint64_t b) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " FA_RS_PRED##NREG ", 0;\n" INSTR   \
                 " " FA_ACC##NREG ", " FA_RS_ARGS##NREG ", 1, 1" TAIL ";\n}\n"        \
                 : FA_OUT##NREG(d)                                                    \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1)         \
                 : "memory");                                                         \
  }

#define FA_MMA "wgmma.mma_async.sync.aligned."
FA_WGMMA_SS(ss_tf32_n32, 16, FA_MMA "m64n32k8.f32.tf32.tf32", "")
FA_WGMMA_SS(ss_tf32_n64, 32, FA_MMA "m64n64k8.f32.tf32.tf32", "")
FA_WGMMA_SS(ss_bf16_n32, 16, FA_MMA "m64n32k16.f32.bf16.bf16", ", 0, 0")
FA_WGMMA_SS(ss_bf16_n64, 32, FA_MMA "m64n64k16.f32.bf16.bf16", ", 0, 0")
FA_WGMMA_RS(rs_tf32_n32, 16, FA_MMA "m64n32k8.f32.tf32.tf32", "")
FA_WGMMA_RS(rs_tf32_n64, 32, FA_MMA "m64n64k8.f32.tf32.tf32", "")
FA_WGMMA_RS(rs_tf32_n128, 64, FA_MMA "m64n128k8.f32.tf32.tf32", "")
FA_WGMMA_RS(rs_bf16_n32, 16, FA_MMA "m64n32k16.f32.bf16.bf16", ", 0")
FA_WGMMA_RS(rs_bf16_n64, 32, FA_MMA "m64n64k16.f32.bf16.bf16", ", 0")
FA_WGMMA_RS(rs_bf16_n128, 64, FA_MMA "m64n128k16.f32.bf16.bf16", ", 0")

// d (64 x N) += A (64 x k-step) B^T (N x k-step), both from shared memory
template <typename T, int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 32) ss_tf32_n32(d, a, b); else ss_tf32_n64(d, a, b);
  } else {
    if constexpr (N == 32) ss_bf16_n32(d, a, b); else ss_bf16_n64(d, a, b);
  }
}
// d (64 x N) += A (64 x k-step, registers) B^T (N x k-step, shared memory)
template <typename T, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (N == 32) rs_tf32_n32(d, a, b);
    else if constexpr (N == 64) rs_tf32_n64(d, a, b);
    else rs_tf32_n128(d, a, b);
  } else {
    if constexpr (N == 32) rs_bf16_n32(d, a, b);
    else if constexpr (N == 64) rs_bf16_n64(d, a, b);
    else rs_bf16_n128(d, a, b);
  }
}

// ------------------------------------------------------ tiles and operands

// float32 is read as TF32 hi and lo parts, bf16 as itself.
template <typename T>
constexpr int kParts = std::is_same<T, float>::value ? 2 : 1;
template <typename T>
constexpr int kChunk = 16 / (int)sizeof(T);  // elements in a core-matrix row
template <typename T>
constexpr int kKStep = 32 / (int)sizeof(T);  // the K extent of one wgmma

// Split one 16-byte chunk into the operand parts at byte `off` of each part.
__device__ __forceinline__ void write_parts(float*, uint8_t* ops, int part_bytes, int off,
                                            uint4 raw) {
  const float x[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y),
                      __uint_as_float(raw.z), __uint_as_float(raw.w)};
  float hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rn(x[i]);
    lo[i] = x[i] - hi[i];
  }
  *reinterpret_cast<float4*>(ops + off) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<float4*>(ops + part_bytes + off) = make_float4(lo[0], lo[1], lo[2], lo[3]);
}
__device__ __forceinline__ void write_parts(__nv_bfloat16*, uint8_t* ops, int, int off,
                                            uint4 raw) {
  *reinterpret_cast<uint4*>(ops + off) = raw;
}

// The loops below give every thread the same trip count, fixed at compile
// time: a loop the compiler must take for divergent would make it serialize
// the wgmma in flight around it.

// Issue the 16-byte copies of rows [r0, r0 + ROWS) of one (b, h) slice into
// a raw (ROWS, D + chunk) tile; rows past S are zero-filled.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(T* raw, const T* src, long long row_stride, int r0,
                                          int S, int tid) {
  constexpr int kCpr = D / kChunk<T>, kPitch = D + kChunk<T>;
  static_assert(ROWS * kCpr % NT == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kCpr / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i / kCpr, c = i - r * kCpr;
    const int row = r0 + r;
    const bool ok = row < S;
    cp_async16(raw + r * kPitch + c * kChunk<T>,
               src + (long long)(ok ? row : 0) * row_stride + c * kChunk<T>, ok);
  }
}

// raw (ROWS, D) -> operand (ROWS x K = D) in the core-matrix layout. Chunk i
// of the operand lies at byte 16 i: 8 consecutive i fill one core matrix.
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void split_rows(uint8_t* ops, int part_bytes, const T* raw, int tid) {
  constexpr int kCpr = D / kChunk<T>, kPitch = D + kChunk<T>;
  static_assert(ROWS * kCpr % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * kCpr / NT; ++it) {
    const int i = tid + it * NT;
    const int q = i >> 3;
    const int c = q % kCpr, row = (q / kCpr) * 8 + (i & 7);
    const uint4 x = *reinterpret_cast<const uint4*>(raw + row * kPitch + c * kChunk<T>);
    write_parts((T*)nullptr, ops, part_bytes, i << 4, x);
  }
}

// The key that slot j of chunk c of V^T holds: TF32 permutes each 8-key
// step (slot t <- key 2t, slot t + 4 <- key 2t + 1); bf16 keeps the order.
template <typename T>
__device__ __forceinline__ int vt_key(int c, int j) {
  if constexpr (std::is_same<T, float>::value) return 8 * (c >> 1) + 2 * j + (c & 1);
  else return c * kChunk<T> + j;
}

// raw V (BK, D) -> operand V^T (D rows x K = BK keys), core-matrix layout.
template <typename T, int D, int BK, int NT>
__device__ __forceinline__ void split_vt(uint8_t* ops, int part_bytes, const T* raw, int tid) {
  constexpr int kCpr = BK / kChunk<T>, kPitch = D + kChunk<T>;
  static_assert(D * kCpr % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < D * kCpr / NT; ++it) {
    const int i = tid + it * NT;
    const int q = i >> 3;
    const int c = q % kCpr, d = (q / kCpr) * 8 + (i & 7);
    using Bits = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;
    const Bits* src = reinterpret_cast<const Bits*>(raw);
    union {
      uint4 u;
      Bits v[kChunk<T>];
    } x;
#pragma unroll
    for (int j = 0; j < kChunk<T>; ++j) x.v[j] = src[vt_key<T>(c, j) * kPitch + d];
    write_parts((T*)nullptr, ops, part_bytes, i << 4, x.u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Issue s (64 x BK) = Q (64 x D) K^T on the tensor cores, Q and K operands
// in shared memory; s is valid after wgmma_wait0() and fence_regs(s).
template <typename T, int D, int BK>
__device__ __forceinline__ void issue_scores(float (&s)[BK / 2], const uint8_t* qa, int q_part,
                                             const uint8_t* kb, int k_part) {
  constexpr uint32_t kSbo = D * sizeof(T) * 8;  // 8 rows of D elements
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / kKStep<T>; ++ks) {
    // a k-step spans two core matrices along K (32 bytes of each row), so
    // step ks starts 2 * 128 bytes after step ks - 1
    const uint64_t ah = make_desc(qa + ks * 256, kSbo), bh = make_desc(kb + ks * 256, kSbo);
    if constexpr (kParts<T> == 2) {
      const uint64_t al = make_desc(qa + q_part + ks * 256, kSbo);
      const uint64_t bl = make_desc(kb + k_part + ks * 256, kSbo);
      mma_ss<T, BK>(s, al, bh);
      mma_ss<T, BK>(s, ah, bl);
    }
    mma_ss<T, BK>(s, ah, bh);
  }
  wgmma_commit();
}

// o (64 x D) += P (64 x BK, the score registers) V, V^T in shared memory.
template <typename T, int D, int BK>
__device__ __forceinline__ void add_pv(float (&o)[D / 2], const float (&p)[BK / 2],
                                       const uint8_t* vb, int v_part) {
  constexpr int kSteps = BK / kKStep<T>;
  constexpr uint32_t kSbo = BK * sizeof(T) * 8;
  uint32_t ah[kSteps][4], al[kSteps][4];
#pragma unroll
  for (int m = 0; m < kSteps; ++m) {
    if constexpr (kParts<T> == 2) {
      // A fragment (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4): with V^T's
      // permuted slots these are the accumulator's 4m, 4m + 2, 4m + 1, 4m + 3
      const float x[4] = {p[4 * m], p[4 * m + 2], p[4 * m + 1], p[4 * m + 3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float hi = tf32_rn(x[i]);
        ah[m][i] = __float_as_uint(hi);
        al[m][i] = __float_as_uint(x[i] - hi);
      }
    } else {
      // bf16 A fragment: rows g, g + 8 of keys 2t, 2t + 1 and 2t + 8, 2t + 9
#pragma unroll
      for (int i = 0; i < 4; ++i) ah[m][i] = pack_bf16(p[8 * m + 2 * i], p[8 * m + 2 * i + 1]);
    }
  }
  fence_regs(o);
  fence_regs(ah);
  if constexpr (kParts<T> == 2) fence_regs(al);
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < kSteps; ++m) {
    const uint64_t bh = make_desc(vb + m * 256, kSbo);
    if constexpr (kParts<T> == 2) {
      const uint64_t bl = make_desc(vb + v_part + m * 256, kSbo);
      mma_rs<T, D>(o, al[m], bh);
      mma_rs<T, D>(o, ah[m], bl);
    }
    mma_rs<T, D>(o, ah[m], bh);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(o);
  fence_regs(ah);
  if constexpr (kParts<T> == 2) fence_regs(al);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Q's operand parts, two stages of K and V^T operand parts, one raw stage.
template <typename T, int D, int NWG, int BK>
struct Smem {
  static constexpr int kQPart = 64 * NWG * D * sizeof(T);
  static constexpr int kKPart = BK * D * sizeof(T);
  static constexpr int kVPart = D * BK * sizeof(T);
  static constexpr int kOps = kParts<T> * (kKPart + kVPart);  // one tile's operands
  static constexpr int kPitch = D + kChunk<T>;
  static constexpr int kRaw = 2 * BK * kPitch;  // raw K then V rows (or Q), elements
  static constexpr size_t kBytes =
      (size_t)kParts<T> * kQPart + 2 * kOps + (size_t)kRaw * sizeof(T);
  static_assert(kBytes <= 232448, "more shared memory than a Hopper CTA has");
};

template <typename T, int D, int NWG, int BK>
__global__ void __launch_bounds__(128 * NWG, 1)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int H, int S, long long qsb, long long qsh,
                     long long qss, long long ksb, long long ksh, long long kss, long long vsb,
                     long long vsh, long long vss, int causal, float scale_log2) {
  using L = Smem<T, D, NWG, BK>;
  constexpr int kThreads = 128 * NWG, BQ = 64 * NWG;
  static_assert(2 * BK >= BQ, "the Q tile is staged in the raw stage");
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* q_ops = smem;
  uint8_t* ops = q_ops + kParts<T> * L::kQPart;  // stage s at ops + s * L::kOps
  T* raw = reinterpret_cast<T*>(ops + 2 * L::kOps);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // heaviest causal query tiles (the last ones) are issued first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int qw0 = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = qw0 + 16 * warp + g, row1 = row0 + 8;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;

  // causal: key tiles starting past this query tile's last row are skipped
  const int k_end = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (k_end + BK - 1) / BK;

  auto load_kv = [&](int k0) {
    load_rows<T, D, BK, kThreads>(raw, kp, kss, k0, S, tid);
    load_rows<T, D, BK, kThreads>(raw + BK * L::kPitch, vp, vss, k0, S, tid);
    cp_async_commit();
  };
  auto split_kv = [&](uint8_t* stage) {
    split_rows<T, D, BK, kThreads>(stage, L::kKPart, raw, tid);
    split_vt<T, D, BK, kThreads>(stage + kParts<T> * L::kKPart, L::kVPart,
                                 raw + BK * L::kPitch, tid);
    fence_async_smem();
  };

  // Q, then tile 0, through the raw stage; tile 1 is in flight at the loop
  load_rows<T, D, BQ, kThreads>(raw, qp, qss, q0, S, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  split_rows<T, D, BQ, kThreads>(q_ops, L::kQPart, raw, tid);
  __syncthreads();
  load_kv(0);
  cp_async_wait_all();
  __syncthreads();
  split_kv(ops);
  __syncthreads();
  if (n_tiles > 1) load_kv(BK);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint8_t* qa = q_ops + wg * 64 * D * (int)sizeof(T);

  // Every warpgroup multiplies every tile, also one wholly above its rows'
  // diagonal or past S: the mask then leaves p = 0 and alpha = 1, so the
  // tile adds nothing, and no branch divides the warpgroups around wgmma.
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    const uint8_t* kb = ops + (j & 1) * L::kOps;
    float s[BK / 2];
    issue_scores<T, D, BK>(s, qa, L::kQPart, kb, L::kKPart);
    if (j + 1 < n_tiles) {
      // split tile j + 1 into the other stage while the scores are on the
      // tensor cores; every thread passing the first barrier has finished
      // tile j - 1, the last reader of that stage
      cp_async_wait_all();
      __syncthreads();  // tile j + 1 has landed in the raw stage
      split_kv(ops + ((j + 1) & 1) * L::kOps);
      __syncthreads();  // its operands are complete, the raw stage is free
      if (j + 2 < n_tiles) load_kv(k0 + 2 * BK);
    }
    wgmma_wait0();
    fence_regs(s);
    // s[4c + e] is (row0, key k0 + 8c + 2t + e), s[4c + 2 + e] row1's
    float mc0 = -INFINITY, mc1 = -INFINITY;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * c + 2 * t + e;
        const bool in = key < S;
        s[4 * c + e] = in && (!causal || key <= row0) ? s[4 * c + e] * scale_log2 : -INFINITY;
        s[4 * c + 2 + e] =
            in && (!causal || key <= row1) ? s[4 * c + 2 + e] * scale_log2 : -INFINITY;
        mc0 = fmaxf(mc0, s[4 * c + e]);
        mc1 = fmaxf(mc1, s[4 * c + 2 + e]);
      }
    }
    mc0 = quad_max(mc0);
    mc1 = quad_max(mc1);
    const float n0 = fmaxf(m0, mc0), n1 = fmaxf(m1, mc1);
    const float z0 = isfinite(n0) ? n0 : 0.f, z1 = isfinite(n1) ? n1 : 0.f;
    const float a0 = isfinite(m0) ? exp2_ftz(m0 - z0) : 0.f;
    const float a1 = isfinite(m1) ? exp2_ftz(m1 - z1) : 0.f;
    float r0 = 0.f, r1 = 0.f;  // this thread's part of the row sums
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& p0 = s[4 * c + e];
        float& p1 = s[4 * c + 2 + e];
        // z is finite, so a masked -inf score gives 2^-inf = 0
        p0 = exp2_ftz(p0 - z0);
        p1 = exp2_ftz(p1 - z1);
        r0 += p0;
        r1 += p1;
      }
    }
    m0 = n0;
    m1 = n1;
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      acc[4 * c] *= a0;
      acc[4 * c + 1] *= a0;
      acc[4 * c + 2] *= a1;
      acc[4 * c + 3] *= a1;
    }
    add_pv<T, D, BK>(acc, s, kb + kParts<T> * L::kKPart, L::kVPart);
  }

  // the quad's partial row sums (alpha was the same in all four threads)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.0f / fmaxf(l0, FLT_MIN), inv1 = 1.0f / fmaxf(l1, FLT_MIN);
  T* op = o + (long long)bh * S * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = 8 * c + 2 * t;
    if (row0 < S) store2(op + (long long)row0 * D + col, acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
    if (row1 < S)
      store2(op + (long long)row1 * D + col, acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
  }
}

template <typename T, int D, int NWG, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
           const long long* st, int causal, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = Smem<T, D, NWG, BK>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_forward_kernel<T, D, NWG, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(B * H, (S + 64 * NWG - 1) / (64 * NWG));
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  flash_forward_kernel<T, D, NWG, BK><<<grid, 128 * NWG, kSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, S, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], causal, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int smem_bytes(int D) {
  switch (D) {
    case 32: return (int)Smem<T, 32, 2, 64>::kBytes;
    case 64: return (int)Smem<T, 64, 2, 64>::kBytes;
    case 128: return (int)Smem<T, 128, 1, 32>::kBytes;
    default: return -1;
  }
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
               int D, const long long* st, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, 2, 64>(q, k, v, o, B, H, S, st, causal, scale, stream);
    case 64: return launch<T, 64, 2, 64>(q, k, v, o, B, H, S, st, causal, scale, stream);
    case 128: return launch<T, 128, 1, 32>(q, k, v, o, B, H, S, st, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v: (B, H, S, D) with element strides strides[0..2] (q), [3..5] (k),
// [6..8] (v) for batch, head and row, unit stride along D; o contiguous.
// Every base address and stride is a multiple of 16 bytes (the wrapper
// checks). dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() of
// the launch.
int flash_attention_forward(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int S, int D, const long long* strides, int dtype, int causal,
                            float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(q, k, v, o, B, H, S, D, strides, causal, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, S, D, strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA at head dim D (-1: not supported).
int flash_attention_smem_bytes(int D, int dtype) {
  return dtype == 0 ? smem_bytes<float>(D) : smem_bytes<__nv_bfloat16>(D);
}

}  // extern "C"
