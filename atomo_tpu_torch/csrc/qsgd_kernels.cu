// QSGD / TernGrad encode and decode kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of atomo_tpu/ops/qsgd_kernels.py:
//   qsgd_quantize_pack     <- pallas_quantize_pack (_quantize_pack_kernel,
//                             _quantize_pack_kernel_ext, _finish_quantize)
//   qsgd_unpack_dequantize <- pallas_unpack_dequantize (_unpack_dequantize_kernel)
//   qsgd_pack_codes        <- pallas_pack_bucketed (_pack_codes_kernel)
//   qsgd_unpack_codes      <- pallas_unpack_bucketed (_unpack_codes_kernel)
//
// Wire format (shared with the JAX package, byte for byte): a leaf of n
// float32 values is cut into nb = ceil(n / bs) buckets; each bucket is padded
// to bucket_p = ceil(bs / vpw) * vpw values, vpw = 32 / (bits + 1), and packed
// into nw = bucket_p / vpw uint32 words. Bucket position p = j * nw + w lies in
// word w at bit j * (bits + 1) (the planar layout). A code is
// (sign << bits) | level, level in [0, 2^bits - 1].
//
// One launch encodes a whole gradient tree: the leaves ride in the kernel's
// arguments as a table (pointer to the leaf's contiguous JAX-layout values,
// n, its first bucket row, its Philox seed, optionally its uniforms), passed
// by value (CUDA 12.1+ takes 32 KB of parameters on Hopper), so the launch
// needs no copy to the device and no host sync. The words (rows, nw) and
// scales (rows) of all leaves go to one flat buffer each; row g belongs to
// the leaf l with row0[l] <= g < row0[l + 1], and positions past bs and
// values past the leaf's n code as 0. The (L, n) stack of equal leaves is the
// same kernel over L table entries. The decode kernels still take an (L, n)
// stack of one shape: x (L * nb, nw) words -> (L, n).
//
// Bound. Every kernel here is bound by device-memory bytes: the encode reads
// 4 bytes per value (plus 4 per value when uniforms are given) and writes about
// (bits + 1) / 8 bytes per value; it does some ten float operations and a
// handful of integer ones per value, far below the card's ~20 operations per
// byte. At ResNet-18 widths (11.2 M values, bits 4) the encode moves ~52 MB:
// ~16 us at 3.35 TB/s. What the design does about it:
//   * one launch over all 62 leaves of a ResNet-18 step (it took 17 launches,
//     one per shape group, each behind a blocking copy of its seeds);
//   * one warp per bucket: lane l owns words l, l + 32, ...; the scale's
//     reduction keeps the order of the earlier 2^k-thread block (see
//     quantize_pack_kernel) with registers and shuffles, no __syncthreads;
//     the second read of the bucket's 2 KB hits L1;
//   * uniforms come from a counter-based Philox4x32-10 generator in registers
//     (keyed on leaf seed, bucket, word, quad), so the hot path moves no
//     random bytes, the analogue of the TPU's on-core PRNG;
//   * for a fixed field j, neighbouring lanes read and write neighbouring
//     addresses (p = j * nw + w), so every access is coalesced.
// The arithmetic uses the _rn intrinsics so that nvcc contracts nothing into an
// FMA: the plain PyTorch twins in atomo_tpu_torch/ops/qsgd_kernels.py repeat
// each rounding, including the order of the scale reduction, and the kernels
// are held against them bit for bit.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Values of bucket row g that lie inside its leaf (the rest pad with zeros).
__device__ __forceinline__ int bucket_valid(long long n, int lb, int bs) {
  const long long left = n - (long long)lb * bs;
  return left < bs ? (int)left : bs;
}

// The leaves of one quantize_pack launch, passed by value.
constexpr int kMaxLeaves = 256;  // 9 KB of parameters
struct LeafTable {
  const float* x[kMaxLeaves];  // the leaf's n values, contiguous
  const float* u[kMaxLeaves];  // its uniforms (nb, bs), or null: Philox
  unsigned long long seed[kMaxLeaves];
  long long n[kMaxLeaves];
  int row0[kMaxLeaves + 1];  // first bucket row of each leaf; [n_leaves] = rows
  int n_leaves;
};

constexpr int kQpWarps = 8;  // buckets per block

// One warp per bucket row g. The scale's reduction is that of a block of nt
// "threads" (nt = block_threads(nw), a power of two in [32, 1024]): thread t
// sums words t, t + nt, ... field by field, then red[t] = red[t] + red[t + h]
// for h = nt/2 .. 1. Lane l plays threads l + 32 i: the steps h >= 32 add its
// own partials, the steps h < 32 are shuffles.
template <int BITS>
__global__ void __launch_bounds__(32 * kQpWarps)
quantize_pack_kernel(const __grid_constant__ LeafTable table, uint32_t* __restrict__ words,
                     float* __restrict__ scales, int bs, int nw, int nt, int terngrad) {
  constexpr int kBpv = BITS + 1;
  constexpr int kVpw = 32 / kBpv;
  constexpr int kLevels = (1 << BITS) - 1;

  const int g = blockIdx.x * kQpWarps + (threadIdx.x >> 5);
  if (g >= table.row0[table.n_leaves]) return;
  const int lane = threadIdx.x & 31;
  int leaf = 0, top = table.n_leaves - 1;  // the last leaf with row0 <= g
  while (leaf < top) {
    const int mid = (leaf + top + 1) >> 1;
    if (table.row0[mid] <= g) leaf = mid; else top = mid - 1;
  }
  const int lb = g - table.row0[leaf];
  const int valid = bucket_valid(table.n[leaf], lb, bs);
  const float* xb = table.x[leaf] + (long long)lb * bs;

  const int nv = nt >> 5;  // threads a lane plays
  float part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < nv) {
      float acc = 0.f;
      for (int w = lane + 32 * i; w < nw; w += nt) {
#pragma unroll
        for (int j = 0; j < kVpw; ++j) {
          const int p = j * nw + w;
          const float v = p < valid ? xb[p] : 0.f;
          acc = terngrad ? fmaxf(acc, fabsf(v)) : __fadd_rn(acc, __fmul_rn(v, v));
        }
      }
      part[i] = acc;
    }
  }
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {  // tree steps nt/2 .. 32: h = step / 32
    if (2 * h <= nv) {
#pragma unroll
      for (int i = 0; i < h; ++i)
        part[i] = terngrad ? fmaxf(part[i], part[i + h]) : __fadd_rn(part[i], part[i + h]);
    }
  }
  float tot = part[0];
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const float other = __shfl_down_sync(0xffffffffu, tot, h);
    tot = terngrad ? fmaxf(tot, other) : __fadd_rn(tot, other);
  }
  tot = __shfl_sync(0xffffffffu, tot, 0);
  const float scale = terngrad ? tot : __fsqrt_rn(tot);
  const float safe = fmaxf(scale, FLT_MIN);
  if (lane == 0) scales[g] = scale;

  const unsigned long long s = table.seed[leaf];
  const uint2 key = make_uint2((uint32_t)s, (uint32_t)(s >> 32));
  const float* ub = table.u[leaf] != nullptr ? table.u[leaf] + (long long)lb * bs : nullptr;

  for (int w = lane; w < nw; w += 32) {
    uint32_t word = 0u;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < kVpw; ++j) {
      const int p = j * nw + w;
      const float v = p < valid ? xb[p] : 0.f;
      float uj;
      if (ub != nullptr) {
        uj = p < bs ? ub[p] : 0.f;
      } else {
        if ((j & 3) == 0) {
          r = philox4x32_10(make_uint4((uint32_t)w, (uint32_t)(j >> 2), (uint32_t)lb, 0u), key);
        }
        const uint32_t rb = (j & 3) == 0 ? r.x : (j & 3) == 1 ? r.y : (j & 3) == 2 ? r.z : r.w;
        // top 24 bits -> [0, 1), exact in float32 (qsgd_kernels.py:167)
        uj = __fmul_rn((float)(rb >> 8), 1.0f / 16777216.0f);
      }
      const float y = __fmul_rn(__fdiv_rn(fabsf(v), safe), (float)kLevels);
      const float lo = floorf(y);
      const float frac = __fsub_rn(y, lo);
      const float lf = fminf(fmaxf(__fadd_rn(lo, uj < frac ? 1.f : 0.f), 0.f), (float)kLevels);
      const uint32_t code = ((v < 0.f ? 1u : 0u) << BITS) | (uint32_t)lf;
      word |= code << (j * kBpv);
    }
    words[(long long)g * nw + w] = word;
  }
}

// One thread per word.
template <int BITS>
__global__ void unpack_dequantize_kernel(const uint32_t* __restrict__ words,
                                         const float* __restrict__ scales,
                                         float* __restrict__ out, long long n,
                                         int nb, int bs, int nw,
                                         long long total_words) {
  constexpr int kBpv = BITS + 1;
  constexpr int kVpw = 32 / kBpv;
  constexpr int kLevels = (1 << BITS) - 1;
  constexpr uint32_t kMask = (1u << kBpv) - 1u;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_words) return;
  const int g = (int)(i / nw);
  const int w = (int)(i - (long long)g * nw);
  const int leaf = g / nb;
  const int lb = g - leaf * nb;
  const int valid = bucket_valid(n, lb, bs);
  float* ob = out + (long long)leaf * n + (long long)lb * bs;
  const uint32_t word = words[i];
  // (sign * level) * (scale / levels): the association XLA gives the JAX
  // reference, which hoists the constant product out of the field loop
  const float step = __fmul_rn(1.0f / (float)kLevels, scales[g]);
#pragma unroll
  for (int j = 0; j < kVpw; ++j) {
    const int p = j * nw + w;
    if (p < valid) {
      const uint32_t code = (word >> (j * kBpv)) & kMask;
      const float level = (float)(code & (uint32_t)kLevels);
      const float sign = 1.f - 2.f * (float)((code >> BITS) & 1u);
      ob[p] = __fmul_rn(__fmul_rn(sign, level), step);
    }
  }
}

// codes (rows, nw * vpw) int32 -> words (rows, nw); one thread per word.
template <int BITS>
__global__ void pack_codes_kernel(const int32_t* __restrict__ codes,
                                  uint32_t* __restrict__ words, int nw,
                                  long long total_words) {
  constexpr int kBpv = BITS + 1;
  constexpr int kVpw = 32 / kBpv;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_words) return;
  const long long g = i / nw;
  const int w = (int)(i - g * nw);
  const int32_t* cb = codes + g * nw * kVpw;
  uint32_t word = 0u;
#pragma unroll
  for (int j = 0; j < kVpw; ++j) word |= (uint32_t)cb[j * nw + w] << (j * kBpv);
  words[i] = word;
}

// words (rows, nw) -> codes (rows, nw * vpw) int32; one thread per word.
template <int BITS>
__global__ void unpack_codes_kernel(const uint32_t* __restrict__ words,
                                    int32_t* __restrict__ codes, int nw,
                                    long long total_words) {
  constexpr int kBpv = BITS + 1;
  constexpr int kVpw = 32 / kBpv;
  constexpr uint32_t kMask = (1u << kBpv) - 1u;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total_words) return;
  const long long g = i / nw;
  const int w = (int)(i - g * nw);
  int32_t* cb = codes + g * nw * kVpw;
  const uint32_t word = words[i];
#pragma unroll
  for (int j = 0; j < kVpw; ++j) cb[j * nw + w] = (int32_t)((word >> (j * kBpv)) & kMask);
}

constexpr int kThreads = 256;

inline unsigned grid_for(long long items) {
  return (unsigned)((items + kThreads - 1) / kThreads);
}

#define QSGD_DISPATCH_BITS(bits, CALL) \
  switch (bits) {                      \
    case 1: CALL(1); break;            \
    case 2: CALL(2); break;            \
    case 3: CALL(3); break;            \
    case 4: CALL(4); break;            \
    case 5: CALL(5); break;            \
    case 6: CALL(6); break;            \
    case 7: CALL(7); break;            \
    case 8: CALL(8); break;            \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError() after
// the launch (0 on success). Shapes and types are checked by the Python
// wrapper before the call.
extern "C" {

// Encode n_leaves leaves in ceil(n_leaves / 256) launches (one for any
// model up to 256 leaves): leaf l's n[l] values at x[l], its uniforms at u[l]
// (null: Philox keyed on seeds[l]; seeds may be null when every u[l] is
// given), its buckets at rows row0[l] .. row0[l + 1] - 1 of words (rows, nw)
// and scales (rows). threads = block_threads(nw), the reduction's width.
int qsgd_quantize_pack(const float* const* x, const float* const* u,
                       const unsigned long long* seeds, const long long* n,
                       const int* row0, int n_leaves, uint32_t* words, float* scales,
                       int bs, int nw, int bits, int terngrad, int threads,
                       void* stream) {
  if (n_leaves <= 0) return 0;
  if (threads < 32 || threads > 1024 || (threads & (threads - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  for (int c0 = 0; c0 < n_leaves; c0 += kMaxLeaves) {
    const int m = n_leaves - c0 < kMaxLeaves ? n_leaves - c0 : kMaxLeaves;
    LeafTable t;
    for (int l = 0; l < m; ++l) {
      t.x[l] = x[c0 + l];
      t.u[l] = u[c0 + l];
      t.seed[l] = seeds != nullptr ? seeds[c0 + l] : 0ull;
      t.n[l] = n[c0 + l];
      t.row0[l] = row0[c0 + l] - row0[c0];
    }
    t.row0[m] = row0[c0 + m] - row0[c0];
    t.n_leaves = m;
    const int rows = t.row0[m];
    if (rows <= 0) continue;
    const unsigned grid = (unsigned)((rows + kQpWarps - 1) / kQpWarps);
    uint32_t* w = words + (long long)row0[c0] * nw;
    float* sc = scales + row0[c0];
#define QSGD_QP(B) \
  quantize_pack_kernel<B><<<grid, 32 * kQpWarps, 0, s>>>(t, w, sc, bs, nw, threads, terngrad)
    QSGD_DISPATCH_BITS(bits, QSGD_QP)
#undef QSGD_QP
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int qsgd_unpack_dequantize(const uint32_t* words, const float* scales,
                           float* out, long long n, int n_leaves, int nb,
                           int bs, int nw, int bits, void* stream) {
  const long long total = (long long)n_leaves * nb * nw;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define QSGD_UD(B)                                                          \
  unpack_dequantize_kernel<B><<<grid_for(total), kThreads, 0, s>>>(          \
      words, scales, out, n, nb, bs, nw, total)
  QSGD_DISPATCH_BITS(bits, QSGD_UD)
#undef QSGD_UD
  return (int)cudaGetLastError();
}

int qsgd_pack_codes(const int32_t* codes, uint32_t* words, long long rows,
                    int nw, int bits, void* stream) {
  const long long total = rows * nw;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define QSGD_PC(B) \
  pack_codes_kernel<B><<<grid_for(total), kThreads, 0, s>>>(codes, words, nw, total)
  QSGD_DISPATCH_BITS(bits, QSGD_PC)
#undef QSGD_PC
  return (int)cudaGetLastError();
}

int qsgd_unpack_codes(const uint32_t* words, int32_t* codes, long long rows,
                      int nw, int bits, void* stream) {
  const long long total = rows * nw;
  if (total <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define QSGD_UC(B) \
  unpack_codes_kernel<B><<<grid_for(total), kThreads, 0, s>>>(words, codes, nw, total)
  QSGD_DISPATCH_BITS(bits, QSGD_UC)
#undef QSGD_UC
  return (int)cudaGetLastError();
}

}  // extern "C"
