// QSGD / TernGrad encode and decode kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of atomo_tpu/ops/qsgd_kernels.py:
//   qsgd_quantize_pack          <- pallas_quantize_pack (_quantize_pack_kernel,
//                                  _quantize_pack_kernel_ext, _finish_quantize)
//   qsgd_unpack_dequantize_tree <- pallas_unpack_dequantize (_unpack_dequantize_kernel)
//   qsgd_pack_codes_tree        <- pallas_pack_bucketed (_pack_codes_kernel)
//   qsgd_unpack_codes_tree      <- pallas_unpack_bucketed (_unpack_codes_kernel)
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
// same kernel over L table entries. The decode side mirrors it: one launch
// of unpack_dequantize_tree_kernel decodes every leaf of a tree (optionally
// the mean over a leading replica axis) straight into the port's layout
// (conv OIHW, linear (out, in)), and one launch of unpack_codes_tree_kernel
// unpacks every leaf's words into one codes buffer. The bare bit-pack of the
// torch-quantizer path is one launch of pack_codes_tree_kernel over the
// codes of every leaf in one buffer.
//
// Bound. Every kernel here is bound by device-memory bytes: the encode reads
// 4 bytes per value (plus 4 per value when uniforms are given) and writes about
// (bits + 1) / 8 bytes per value; it does some ten float operations and a
// handful of integer ones per value, far below the card's ~20 operations per
// byte. At ResNet-18 widths (11.2 M values, bits 4) the encode moves ~52 MB:
// ~16 us at 3.35 TB/s; the decode reads ~7.5 MB and writes 44.7 MB, the
// same ~16 us. What the design does about it:
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
//     addresses (p = j * nw + w), so every access is coalesced;
//   * the decode turns the JAX layout into the port's through a tile in
//     shared memory (see unpack_dequantize_tree_kernel): coalesced word
//     reads on one side, stores along the port's rows on the other, so the
//     layout change costs no pass of its own over device memory.
//   * the bit-pack walks tiles of whole rows on a persistent grid, no
//     thread dividing (see pack_codes_tree_kernel).
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

// The last leaf whose first row (or block) is <= item, by bisection.
__device__ __forceinline__ int last_leaf_at(const int* first, int n_leaves, int item) {
  int leaf = 0, top = n_leaves - 1;  // the last leaf whose first item is <= item
  while (leaf < top) {
    const int mid = (leaf + top + 1) >> 1;
    if (first[mid] <= item) leaf = mid; else top = mid - 1;
  }
  return leaf;
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
  const int leaf = last_leaf_at(table.row0, table.n_leaves, g);
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

// The leaves of one unpack_dequantize_tree launch, passed by value. A leaf's
// payload is n_replicas (nb, nw) word blocks and (nb,) scale rows, replica r's
// at words[l] + r * wstride[l] and scales[l] + r * sstride[l]: nb * nw and nb
// when the replicas lie one after another, the packed buffer's length (in
// 4-byte elements) when they are the rows of a gathered (N, bytes) buffer,
// which the kernel so reads in place; its output lies in the port's layout
// at out[l]. dims[l] = (A, B, C) says the
// JAX layout (A, B, C) becomes the port's (C, B, A): a conv HWIO kernel is
// (H*W, I, O) -> OIHW, a linear (in, out) kernel is (1, in, out) ->
// (out, in); A = 0 marks a leaf that lies alike in both (vectors, embedding
// tables). tile0[l] is the first block of leaf l.
struct DecodeTable {
  const uint32_t* words[kMaxLeaves];
  const float* scales[kMaxLeaves];
  long long wstride[kMaxLeaves];  // words between replicas
  long long sstride[kMaxLeaves];  // scales between replicas
  float* out[kMaxLeaves];
  int n[kMaxLeaves];
  int dims[kMaxLeaves][3];
  int tile0[kMaxLeaves + 1];
  int n_leaves;
};

constexpr int kDecWarps = 8;   // 256 threads; a flat tile is 8 buckets, a warp each
constexpr int kDecTileC = 32;  // a transposed tile: 32 output rows (one per lane) ...
constexpr int kDecTileK = 64;  // ... of 64 values along the port's contiguous axis

// (sign * level) * (scale / levels): the association XLA gives the JAX
// reference, which hoists the constant product out of the field loop.
template <int BITS>
__device__ __forceinline__ float dequantize(uint32_t field, float step) {
  constexpr uint32_t kLevels = (1u << BITS) - 1u;
  const float level = (float)(field & kLevels);
  const float sign = 1.f - 2.f * (float)((field >> BITS) & 1u);
  return __fmul_rn(__fmul_rn(sign, level), step);
}

// One launch decodes a whole tree. A block finds its leaf by a search over
// tile0 and its tile within the leaf:
//   * flat leaves: 8 buckets, a warp each; lane l decodes words l, l + 32, ...
//     and writes each field j at p = j * nw + w, so a warp's writes of one
//     field are coalesced (the mapping of the stacked kernel before it);
//   * transposed leaves: a tile of 32 output rows c (port layout, one per
//     lane) by 64 values k along the row. The JAX position of (c, k = b*A+a)
//     is (a*B + b)*C + c, so a warp reads one k for 32 consecutive c: 32
//     consecutive positions, coalesced words. The values go to shared memory
//     at column k ^ lane (conflict-free both ways), and the block writes each
//     row's 64 values along the row, as 16-byte stores where the row length
//     and the leaf's address allow, else as coalesced 4-byte stores.
// kPow2: bs = 2^bs_shift <= 65536, so a position splits into bucket and
// offset by a shift and a mask, and nw_magic = floor(2^32 / nw) + 1 divides
// an offset by nw exactly (offset * nw < 2^32); else both are divisions.
template <int BITS, bool kPow2>
__global__ void __launch_bounds__(32 * kDecWarps, 4)
unpack_dequantize_tree_kernel(const __grid_constant__ DecodeTable table, int bs, int bs_shift,
                              int nw, unsigned nw_magic, int n_replicas) {
  constexpr int kBpv = BITS + 1;
  constexpr int kVpw = 32 / kBpv;
  constexpr uint32_t kMask = (1u << kBpv) - 1u;
  constexpr float kInvLevels = 1.0f / (float)((1 << BITS) - 1);
  __shared__ __align__(16) float tile[kDecTileC * kDecTileK];

  const int leaf = last_leaf_at(table.tile0, table.n_leaves, blockIdx.x);
  const int t = blockIdx.x - table.tile0[leaf];
  const int n = table.n[leaf];
  // a select on bs_shift, not on kPow2: the same value, and the decode ran
  // faster so on an H100
  const int nb = bs_shift >= 0 ? (n + bs - 1) >> bs_shift : (n + bs - 1) / bs;
  const uint32_t* __restrict__ words = table.words[leaf];
  const float* __restrict__ scales = table.scales[leaf];
  float* __restrict__ out = table.out[leaf];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int A = table.dims[leaf][0];

  if (A == 0) {
    const int lb = t * kDecWarps + warp;
    if (lb >= nb) return;
    const int valid = bucket_valid(n, lb, bs);
    const long long wstride = table.wstride[leaf], sstride = table.sstride[leaf];
    float* ob = out + (long long)lb * bs;
    for (int w = lane; w < nw; w += 32) {
      const long long at = (long long)lb * nw + w;
      float acc[kVpw];
      uint32_t word = words[at];
      float step = __fmul_rn(kInvLevels, scales[lb]);
#pragma unroll
      for (int j = 0; j < kVpw; ++j) acc[j] = dequantize<BITS>((word >> (j * kBpv)) & kMask, step);
      for (int r = 1; r < n_replicas; ++r) {
        word = words[r * wstride + at];
        step = __fmul_rn(kInvLevels, scales[r * sstride + lb]);
#pragma unroll
        for (int j = 0; j < kVpw; ++j) {
          acc[j] = __fadd_rn(acc[j], dequantize<BITS>((word >> (j * kBpv)) & kMask, step));
        }
      }
#pragma unroll
      for (int j = 0; j < kVpw; ++j) {
        const int p = j * nw + w;
        if (p < valid) ob[p] = n_replicas == 1 ? acc[j] : __fdiv_rn(acc[j], (float)n_replicas);
      }
    }
    return;
  }

  const int B = table.dims[leaf][1], C = table.dims[leaf][2];
  const int K = A * B;
  const int tiles_k = (K + kDecTileK - 1) / kDecTileK;
  const int c0 = (t / tiles_k) * kDecTileC, k0 = (t - (t / tiles_k) * tiles_k) * kDecTileK;
  const bool lane_in = c0 + lane < C;
  // a warp takes 8 consecutive k of the tile and issues their 8 loads
  // before it uses any, so that they are in flight together
  constexpr int kPer = kDecTileK / kDecWarps;
  const int kw = k0 + warp * kPer;
  // word index, bucket and field shift of the value (c0 + lane, k = b*A + a)
  auto position = [&](int a, int b, int& at, int& lb, int& shift) {
    const int p = (a * B + b) * C + c0 + lane;  // < n < 2^31
    if constexpr (kPow2) {  // bs a power of two up to 65536: a shift, a mask, a product
      lb = p >> bs_shift;
      const int o = p & (bs - 1);
      const int j = (int)__umulhi((unsigned)o, nw_magic);
      at = lb * nw + o - j * nw;  // < nb * nw <= n
      shift = j * kBpv;
    } else {
      lb = p / bs;
      const int o = p - lb * bs;
      const int j = o / nw;
      at = lb * nw + o - j * nw;
      shift = j * kBpv;
    }
  };
  uint32_t wv[kPer];
  float sc[kPer];
  int sh[kPer];
  unsigned ok = 0u;
  {
    int b = kw / A, a = kw - b * A;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      wv[i] = 0u;
      sc[i] = 0.f;
      sh[i] = 0;
      if (kw + i < K && lane_in) {
        int at, lb;
        position(a, b, at, lb, sh[i]);
        wv[i] = words[at];
        sc[i] = scales[lb];
        ok |= 1u << i;
      }
      if (++a == A) {
        a = 0;
        ++b;
      }
    }
  }
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    acc[i] = (ok >> i) & 1u ? dequantize<BITS>(wv[i] >> sh[i], __fmul_rn(kInvLevels, sc[i]))
                            : 0.f;
  }
  if (n_replicas > 1) {  // the mean over replicas, summed in order
    const long long wstride = table.wstride[leaf], sstride = table.sstride[leaf];
    int b = kw / A, a = kw - b * A;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if ((ok >> i) & 1u) {
        int at, lb, shift;
        position(a, b, at, lb, shift);
        for (int r = 1; r < n_replicas; ++r) {
          const float step = __fmul_rn(kInvLevels, scales[r * sstride + lb]);
          acc[i] = __fadd_rn(acc[i], dequantize<BITS>(words[r * wstride + at] >> shift, step));
        }
      }
      if (++a == A) {
        a = 0;
        ++b;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int kk = warp * kPer + i;
    tile[lane * kDecTileK + (kk ^ lane)] =
        n_replicas == 1 ? acc[i] : __fdiv_rn(acc[i], (float)n_replicas);
  }
  __syncthreads();

  if ((K & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    constexpr int kQuads = kDecTileK / 4;
#pragma unroll
    for (int i = threadIdx.x; i < kDecTileC * kQuads; i += 32 * kDecWarps) {
      const int row = i / kQuads, q = i - row * kQuads;
      const int c = c0 + row, k = k0 + 4 * q;
      if (c < C && k < K) {
        // logical column 4q + e lies at (4q + e) ^ row = ((4q) ^ (row & ~3)) + (e ^ (row & 3))
        float4 v = *reinterpret_cast<const float4*>(&tile[row * kDecTileK + ((4 * q) ^ (row & ~3))]);
        if (row & 1) {
          const float x = v.x, z = v.z;
          v.x = v.y; v.y = x; v.z = v.w; v.w = z;
        }
        if (row & 2) {
          const float x = v.x, y = v.y;
          v.x = v.z; v.y = v.w; v.z = x; v.w = y;
        }
        *reinterpret_cast<float4*>(out + (long long)c * K + k) = v;
      }
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < kDecTileC * kDecTileK; i += 32 * kDecWarps) {
      const int row = i / kDecTileK, kk = i - row * kDecTileK;
      const int c = c0 + row, k = k0 + kk;
      if (c < C && k < K) out[(long long)c * K + k] = tile[row * kDecTileK + (kk ^ row)];
    }
  }
}

// ---------------------------------------------------------------- bit-pack
//
// codes (rows, bucket_p) int32 -> words (rows, nw) uint32, bucket_p = nw * vpw,
// over every row of a tree in one launch: the codes of all leaves lie in one
// buffer, rows one after another, so the kernel needs no leaf table and the
// leaf split is the wrapper's views of one words buffer. Bound by bytes: it
// reads 4 bytes a code and writes 4 / vpw; a ResNet-18 step at 4 bits is
// 45.1 MB read and 7.5 MB written, 15.7 us at 3.35 TB/s.
//
// A tile is tile_rows whole rows, about kPackTileInts codes. A persistent
// grid of as many blocks as the SMs hold walks the tiles: block b takes
// tiles b, b + grid, .... Thread i forms words i, i + 256, ... of the tile,
// its (row, word) stepped on without a division; field j of 32 neighbouring
// words is 32 neighbouring codes (p = j * nw + w), so every load and the
// stores of the words are coalesced. The codes are read where they lie: a
// form that staged tiles in shared memory by 1-D bulk copies or cp.async,
// two tiles ahead, measured no faster (PERF.md).

constexpr int kPackThreads = 256;
constexpr int kPackTileInts = 4096;  // codes per tile, about 16 KB

template <int BITS>
__global__ void __launch_bounds__(kPackThreads)
pack_codes_tree_kernel(const int32_t* __restrict__ codes, uint32_t* __restrict__ words,
                       int rows, int nw, int tile_rows, int n_tiles) {
  constexpr int kBpv = BITS + 1;
  constexpr int kVpw = 32 / kBpv;
  const int bucket_p = nw * kVpw;
  const int step_r = kPackThreads / nw, step_w = kPackThreads - step_r * nw;
  const int r0 = threadIdx.x / nw, w0 = threadIdx.x - r0 * nw;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int32_t* src = codes + (long long)t * tile_rows * bucket_p;
    uint32_t* out = words + (long long)t * tile_rows * nw;
    const int n = min(tile_rows, rows - t * tile_rows);
    for (int r = r0, w = w0; r < n;) {
      const int32_t* c = src + r * bucket_p + w;
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < kVpw; ++j) word |= (uint32_t)c[j * nw] << (j * kBpv);
      out[r * nw + w] = word;
      r += step_r;
      w += step_w;
      if (w >= nw) {
        w -= nw;
        ++r;
      }
    }
  }
}

// Blocks of pack_codes_tree_kernel<BITS> that fill the card, queried on the
// first launch of a process and kept (the kernel takes no dynamic shared
// memory, so the answer does not change); 0 if the query failed. The cache
// is the process's, not the device's: the port runs one device per process,
// which atomo_tpu_torch/parallel/launch.py asserts when it binds the device.
template <int BITS>
int pack_grid() {
  static const int fill = [] {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pack_codes_tree_kernel<BITS>,
                                                      kPackThreads, 0) != cudaSuccess) {
      return 0;
    }
    return (per_sm > 0 ? per_sm : 1) * sms;
  }();
  return fill;
}

template <int BITS>
int launch_pack_codes(const int32_t* codes, uint32_t* words, int rows, int nw, int tile_rows,
                      int n_tiles, cudaStream_t s) {
  const int fill = pack_grid<BITS>();
  if (fill <= 0) {
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorUnknown);
  }
  const unsigned grid = (unsigned)(n_tiles < fill ? n_tiles : fill);
  pack_codes_tree_kernel<BITS><<<grid, kPackThreads, 0, s>>>(codes, words, rows, nw,
                                                              tile_rows, n_tiles);
  return (int)cudaGetLastError();
}

// The leaves of one unpack_codes_tree launch: leaf l's words go to rows
// row0[l] .. row0[l + 1] - 1 of the codes, replica after replica: its rows
// are replicas of nb[l] rows (nw words each), replica r's at words[l] +
// r * stride[l] (nb[l] * nw when the replicas lie one after another, the
// packed buffer's length when they are rows of a gathered buffer).
struct CodesTable {
  const uint32_t* words[kMaxLeaves];
  long long stride[kMaxLeaves];
  int nb[kMaxLeaves];
  int row0[kMaxLeaves + 1];
  int n_leaves;
};

constexpr int kThreadsUc = 256;

// words -> codes (rows, nw * vpw) int32 for a whole tree. Thread i takes
// word q = i mod nw of row g = i / nw and writes its field j at j * nw + q,
// so a warp's loads and its writes of one field are contiguous. A block
// finds the leaf of its first row by bisection; a thread steps on from
// there to its own row's, and splits the leaf's row into replica and row
// (no division for a leaf of one replica).
template <int BITS>
__global__ void __launch_bounds__(kThreadsUc)
unpack_codes_tree_kernel(const __grid_constant__ CodesTable table, int32_t* __restrict__ codes,
                         int nw, int items) {
  constexpr int kBpv = BITS + 1;
  constexpr int kVpw = 32 / kBpv;
  constexpr uint32_t kMask = (1u << kBpv) - 1u;
  const int first = blockIdx.x * kThreadsUc;
  const int i = first + threadIdx.x;
  if (i >= items) return;
  const int g = i / nw, q = i - g * nw;
  int leaf = last_leaf_at(table.row0, table.n_leaves, first / nw);
  while (g >= table.row0[leaf + 1]) ++leaf;
  int lb = g - table.row0[leaf];
  const int nb = table.nb[leaf];
  long long at = 0;
  if (lb >= nb) {
    const int r = lb / nb;
    lb -= r * nb;
    at = r * table.stride[leaf];
  }
  const uint32_t w = table.words[leaf][at + (long long)lb * nw + q];
  int32_t* row = codes + (long long)g * nw * kVpw + q;
#pragma unroll
  for (int j = 0; j < kVpw; ++j) row[j * nw] = (int32_t)((w >> (j * kBpv)) & kMask);
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

// Decode n_leaves leaves in ceil(n_leaves / 256) launches (one for any model
// up to 256 leaves): leaf l's n_replicas payloads, replica r's (nb, nw) words
// at words[l] + r * wstride[l] and (nb,) scales at scales[l] + r *
// sstride[l], nb = ceil(n[l] / bs), are decoded, averaged over the replicas
// (summed in order, then divided) and written to out + out_off[l] in the
// layout dims[3 l .. 3 l + 2] (see DecodeTable).
int qsgd_unpack_dequantize_tree(const uint32_t* const* words, const float* const* scales,
                                const long long* wstride, const long long* sstride,
                                float* out, const long long* out_off, const int* n,
                                const int* dims, int n_leaves, int bs, int nw, int bits,
                                int n_replicas, void* stream) {
  if (n_leaves <= 0) return 0;
  if (bs <= 0 || nw <= 0 || n_replicas <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int bs_shift = -1;
  for (int e = 0; e <= 16; ++e) {
    if (bs == (1 << e)) bs_shift = e;
  }
  const bool pow2 = bs_shift >= 0 && nw >= 2;
  const unsigned magic = pow2 ? (unsigned)((1ull << 32) / (unsigned)nw + 1ull) : 0u;
  for (int c0 = 0; c0 < n_leaves; c0 += kMaxLeaves) {
    const int m = n_leaves - c0 < kMaxLeaves ? n_leaves - c0 : kMaxLeaves;
    DecodeTable t;
    long long tiles = 0;
    for (int l = 0; l < m; ++l) {
      const int i = c0 + l;
      t.words[l] = words[i];
      t.scales[l] = scales[i];
      t.wstride[l] = wstride[i];
      t.sstride[l] = sstride[i];
      t.out[l] = out + out_off[i];
      t.n[l] = n[i];
      for (int d = 0; d < 3; ++d) t.dims[l][d] = dims[3 * i + d];
      t.tile0[l] = (int)tiles;
      const int nb = (n[i] + bs - 1) / bs;
      if (dims[3 * i] == 0) {
        tiles += (nb + kDecWarps - 1) / kDecWarps;
      } else {
        const long long k = (long long)dims[3 * i] * dims[3 * i + 1];
        tiles += (long long)((dims[3 * i + 2] + kDecTileC - 1) / kDecTileC) *
                 ((k + kDecTileK - 1) / kDecTileK);
      }
    }
    if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    t.tile0[m] = (int)tiles;
    t.n_leaves = m;
    if (tiles == 0) continue;
#define QSGD_UD(B)                                                                    \
  if (pow2) {                                                                           \
    unpack_dequantize_tree_kernel<B, true><<<(unsigned)tiles, 32 * kDecWarps, 0, s>>>(  \
        t, bs, bs_shift, nw, magic, n_replicas);                                        \
  } else {                                                                              \
    unpack_dequantize_tree_kernel<B, false><<<(unsigned)tiles, 32 * kDecWarps, 0, s>>>( \
        t, bs, bs_shift, nw, magic, n_replicas);                                        \
  }
    QSGD_DISPATCH_BITS(bits, QSGD_UD)
#undef QSGD_UD
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Pack rows x bucket_p codes (bucket_p = nw * vpw, the rows of every leaf
// of a tree one after another) into rows x nw words in one launch.
int qsgd_pack_codes_tree(const int32_t* codes, uint32_t* words, int rows, int nw, int bits,
                         void* stream) {
  if (rows <= 0) return 0;
  if (bits < 1 || bits > 8 || nw <= 0) return (int)cudaErrorInvalidValue;
  const long long bucket_p = (long long)nw * (32 / (bits + 1));
  const long long tile_rows = bucket_p >= kPackTileInts ? 1 : kPackTileInts / bucket_p;
  if (tile_rows * bucket_p >= (1ll << 30)) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)((rows + tile_rows - 1) / tile_rows);
  const int tr = (int)tile_rows;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
#define QSGD_PC(B) rc = launch_pack_codes<B>(codes, words, rows, nw, tr, n_tiles, s)
  QSGD_DISPATCH_BITS(bits, QSGD_PC)
#undef QSGD_PC
  return rc;
}

// Unpack n_leaves leaves' words in ceil(n_leaves / 256) launches: leaf l's
// rows row0[l] .. row0[l + 1] - 1 of codes (rows, nw * vpw) int32 come from
// its replicas of nb[l] rows, replica r's at words[l] + stride[l] * r.
int qsgd_unpack_codes_tree(const uint32_t* const* words, const long long* stride,
                           const int* nb, const int* row0, int n_leaves, int32_t* codes,
                           int nw, int bits, void* stream) {
  if (n_leaves <= 0) return 0;
  if (bits < 1 || bits > 8 || nw <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  for (int c0 = 0; c0 < n_leaves; c0 += kMaxLeaves) {
    const int m = n_leaves - c0 < kMaxLeaves ? n_leaves - c0 : kMaxLeaves;
    CodesTable t;
    for (int l = 0; l < m; ++l) {
      t.words[l] = words[c0 + l];
      t.stride[l] = stride[c0 + l];
      t.nb[l] = nb[c0 + l] > 0 ? nb[c0 + l] : 1;
      t.row0[l] = row0[c0 + l] - row0[c0];
    }
    t.row0[m] = row0[c0 + m] - row0[c0];
    t.n_leaves = m;
    const long long items = (long long)t.row0[m] * nw;
    if (items <= 0) continue;
    if (items >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((items + kThreadsUc - 1) / kThreadsUc);
    const int it = (int)items;
    int32_t* c = codes + (long long)row0[c0] * nw * (32 / (bits + 1));
#define QSGD_UC(B) unpack_codes_tree_kernel<B><<<grid, kThreadsUc, 0, s>>>(t, c, nw, it)
    QSGD_DISPATCH_BITS(bits, QSGD_UC)
#undef QSGD_UC
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
