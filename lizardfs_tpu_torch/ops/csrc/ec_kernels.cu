// Hand-written Hopper (sm_90a) kernels for the erasure-coding data plane.
//
// Built by lizardfs_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface (bottom of this file) and bound with ctypes by
// lizardfs_tpu_torch/ops/cuda_ec.py. Every launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Two device-side building blocks carry all four kernel functions:
//
//  * GF(2) matrix apply through split-nibble tables. An (8w, 8r) bit-plane
//    matrix over GF(2) (lizardfs_tpu_torch/ops/bitplane.py) is turned, at
//    block start, into one 32-byte table per (output row i, input row j):
//    lo[n] / hi[n] = XOR of the matrix columns selected by the low / high
//    nibble n. An output byte is XOR_j lo[x_j & 15] ^ hi[x_j >> 4]: the
//    same GF(2)-linear map the TPU computes as a bit-plane matmul on the
//    MXU, and the scheme of the repo's C++ SIMD backend. All lanes of a
//    warp read the same 32-byte table (8 words in 8 distinct banks), so the
//    lookups are free of bank conflicts.
//
//  * CRC32 of contiguous spans combined by GF(2) shift matrices. Each
//    thread computes the raw register (init 0, no final XOR) of its span
//    with a slicing-by-8 table in shared memory; registers of adjacent
//    spans combine as R(A||B) = S^|B| R(A) ^ R(B), where S^n (shift by n
//    zero bytes, lizardfs_tpu_torch/ops/crc32.py:shift_matrix) is passed as
//    32 uint32 column words. A log tree in shared memory folds a block's
//    spans; crc = R ^ K with K = crc32 of block_size zero bytes. This is
//    the affine decomposition of ops/crc32.py.
//
// Kernels and the TPU kernels they replace (lizardfs_tpu/ops/pallas_ec.py):
//
//  gf_apply_kernel          replaces `encode` (:91-118, pallas_call :108).
//    Bound on the H100 by bytes: r input rows read once, w output rows
//    written once; the bit-plane formulation's int8 work (2*64*w*r ops
//    per column) is below the memory time at EC shapes. Design: threads
//    take consecutive 16-byte column vectors (coalesced 512-byte warp
//    accesses per row); any N is taken (a byte-wise instantiation covers
//    lengths that are not a multiple of 16). Output rows are produced in
//    register groups of four; inputs are re-read per group from L1/L2.
//
//  block_crc_kernel         replaces `block_crcs` (:146-190, pallas_call
//    :166 plus the XLA log-tree fold). Bound by bytes: each block is read
//    once. Design: one CTA per block, one contiguous span per thread, the
//    tree fold in shared memory, no HBM round trip of partial registers.
//
//  fused_encode_crc_kernel  replaces `fused_encode_crc` (:438-581,
//  + crc_fold_kernel         pallas_call :527, finalize :567-579) and,
//    driven by a recovery matrix with crc_inputs=0 and an expected-CRC
//    array, `fused_decode_verify` (:590-615). Bound by bytes (data in
//    once, parity out once) at the memory rate; counted as int8 bit-plane
//    operations it is bound by those instead. Design: a 64 KiB block is
//    split over `splits` CTAs (a 64 MiB ec(8,4) chunk has only 128 blocks,
//    fewer than the 132 SMs), each CTA reads its slab of all k data rows
//    once, writes the slab's parity once, and folds the raw CRC registers
//    of all k+m rows of its slab in shared memory. crc_fold_kernel then
//    folds the per-CTA registers of each (row, block) by Horner's rule
//    with S^slab (the Pallas `comb` matrix), XORs K, and optionally
//    compares with the stored CRCs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kCrcPoly = 0xEDB88320u;
constexpr int kMaxLevels = 8;  // log2 of the largest CTA (256 threads)

// ---------------------------------------------------------------------------
// Device function 1: GF(2) matrix apply through split-nibble tables.
// ---------------------------------------------------------------------------

// tab[((i * r + j) * 32) + n] for n < 16: XOR of the column bytes of input
// bits 0..3 of part j selected by n; tab[... + 16 + n]: the same for bits
// 4..7. A column byte packs the 8 rows of output byte i of one matrix
// column. Called by every thread of the block; the caller synchronises.
__device__ void build_nibble_tables(const int8_t* __restrict__ bigm, int w,
                                    int r, uint8_t* tab) {
  const int total = w * r * 32;
  const int cols = 8 * r;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int n = e & 15;
    const int half = (e >> 4) & 1;
    const int ij = e >> 5;
    const int i = ij / r;
    const int j = ij - i * r;
    uint32_t v = 0;
    for (int b = 0; b < 4; ++b) {
      if (!((n >> b) & 1)) continue;
      const int c = 8 * j + 4 * half + b;
      uint32_t colbyte = 0;
      for (int rr = 0; rr < 8; ++rr)
        colbyte |= static_cast<uint32_t>(bigm[(8 * i + rr) * cols + c] & 1) << rr;
      v ^= colbyte;
    }
    tab[e] = static_cast<uint8_t>(v);
  }
}

__device__ __forceinline__ uint32_t gf_byte(const uint8_t* t, uint32_t b) {
  return t[b & 15u] ^ t[16u + (b >> 4)];
}

__device__ __forceinline__ uint32_t gf_word(const uint8_t* t, uint32_t x) {
  uint32_t out = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    out |= gf_byte(t, (x >> (8 * p)) & 0xffu) << (8 * p);
  return out;
}

__device__ __forceinline__ void xor_gf_vec(uint4& acc, const uint8_t* t,
                                           const uint4 x) {
  acc.x ^= gf_word(t, x.x);
  acc.y ^= gf_word(t, x.y);
  acc.z ^= gf_word(t, x.z);
  acc.w ^= gf_word(t, x.w);
}

// ---------------------------------------------------------------------------
// Device function 2: raw CRC32 registers and their GF(2) shift combine.
// ---------------------------------------------------------------------------

// Slicing-by-8 tables: t[0] is the reflected byte table, t[s][i] =
// (t[s-1][i] >> 8) ^ t[0][t[s-1][i] & 0xff]. Called by every thread; ends
// synchronised.
__device__ void build_crc_tables(uint32_t (*t)[256]) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int b = 0; b < 8; ++b) c = (c & 1u) ? (kCrcPoly ^ (c >> 1)) : (c >> 1);
    t[0][i] = c;
  }
  __syncthreads();
  for (int s = 1; s < 8; ++s) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) {
      const uint32_t c = t[s - 1][i];
      t[s][i] = (c >> 8) ^ t[0][c & 0xffu];
    }
    __syncthreads();
  }
}

// Raw register update over 8 bytes: lo holds bytes 0..3, hi bytes 4..7
// (little-endian loads).
__device__ __forceinline__ uint32_t crc_raw8(const uint32_t (*t)[256],
                                             uint32_t crc, uint32_t lo,
                                             uint32_t hi) {
  lo ^= crc;
  return t[7][lo & 0xffu] ^ t[6][(lo >> 8) & 0xffu] ^ t[5][(lo >> 16) & 0xffu] ^
         t[4][lo >> 24] ^ t[3][hi & 0xffu] ^ t[2][(hi >> 8) & 0xffu] ^
         t[1][(hi >> 16) & 0xffu] ^ t[0][hi >> 24];
}

__device__ __forceinline__ uint32_t crc_raw16(const uint32_t (*t)[256],
                                              uint32_t crc, const uint4 v) {
  return crc_raw8(t, crc_raw8(t, crc, v.x, v.y), v.z, v.w);
}

// v -> M v over GF(2), M given by its 32 column words.
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* cols, uint32_t v) {
  uint32_t out = 0;
#pragma unroll
  for (int c = 0; c < 32; ++c) out ^= cols[c] & (0u - ((v >> c) & 1u));
  return out;
}

// regs holds `rows` rows of T raw registers, one per consecutive span of
// equal length; level_cols[l] shifts by the length of 2^l spans. On return
// regs[row * T] is the register of the whole row. Entry and exit are
// synchronised.
__device__ void crc_tree(uint32_t* regs, int rows, int T,
                         const uint32_t* level_cols, int levels) {
  for (int l = 0; l < levels; ++l) {
    const int h = 1 << l;
    const int pairs = T >> (l + 1);
    for (int e = threadIdx.x; e < rows * pairs; e += blockDim.x) {
      const int row = e / pairs;
      uint32_t* left = regs + row * T + (e - row * pairs) * 2 * h;
      left[0] = gf2_apply(level_cols + 32 * l, left[0]) ^ left[h];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Kernels.
// ---------------------------------------------------------------------------

// out (w, n) = bigm (8w, 8r) applied to data (r, n). kVec16: n % 16 == 0
// and 16-byte aligned rows; otherwise one byte per thread step.
template <bool kVec16>
__global__ void gf_apply_kernel(const int8_t* __restrict__ bigm,
                                const uint8_t* __restrict__ data,
                                uint8_t* __restrict__ out, int w, int r,
                                long long n) {
  extern __shared__ uint8_t nib[];
  build_nibble_tables(bigm, w, r, nib);
  __syncthreads();
  const long long units = kVec16 ? n / 16 : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       u < units; u += stride) {
    for (int i0 = 0; i0 < w; i0 += 4) {
      if constexpr (kVec16) {
        uint4 acc[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g] = make_uint4(0, 0, 0, 0);
        for (int j = 0; j < r; ++j) {
          const uint4 x = *reinterpret_cast<const uint4*>(data + j * n + u * 16);
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (i0 + g < w) xor_gf_vec(acc[g], nib + ((i0 + g) * r + j) * 32, x);
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (i0 + g < w)
            *reinterpret_cast<uint4*>(out + (i0 + g) * n + u * 16) = acc[g];
      } else {
        uint32_t acc[4] = {0, 0, 0, 0};
        for (int j = 0; j < r; ++j) {
          const uint32_t b = data[j * n + u];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            if (i0 + g < w) acc[g] ^= gf_byte(nib + ((i0 + g) * r + j) * 32, b);
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (i0 + g < w) out[(i0 + g) * n + u] = static_cast<uint8_t>(acc[g]);
      }
    }
  }
}

// out[b] = crc32 of blocks[b, 0:bs]. blockDim.x = T threads, each over a
// contiguous span of bs / T bytes (a multiple of 16); level_cols (levels,
// 32) shifts by span * 2^l bytes.
__global__ void block_crc_kernel(const uint8_t* __restrict__ blocks,
                                 long long nblocks, int bs,
                                 const uint32_t* __restrict__ level_cols,
                                 int levels, uint32_t k_const,
                                 uint32_t* __restrict__ out) {
  __shared__ uint32_t tabs[8][256];
  __shared__ uint32_t cols[kMaxLevels * 32];
  __shared__ uint32_t regs[256];
  for (int e = threadIdx.x; e < levels * 32; e += blockDim.x) cols[e] = level_cols[e];
  build_crc_tables(tabs);
  const int T = blockDim.x;
  const int vecs = bs / T / 16;
  for (long long blk = blockIdx.x; blk < nblocks; blk += gridDim.x) {
    const uint4* p = reinterpret_cast<const uint4*>(
        blocks + blk * bs + static_cast<long long>(threadIdx.x) * (bs / T));
    uint32_t crc = 0;
    for (int o = 0; o < vecs; ++o) crc = crc_raw16(tabs, crc, p[o]);
    regs[threadIdx.x] = crc;
    __syncthreads();
    crc_tree(regs, 1, T, cols, levels);
    if (threadIdx.x == 0) out[blk] = regs[0] ^ k_const;
    __syncthreads();
  }
}

// One CTA per (block, split): columns [blk*bs + s*T*16, +T*16) of the k
// data rows. Writes the slab's parity and regs_out[(row, blk, s)] = raw
// CRC register of the slab of each row (rows 0..k-1 data, k..k+m-1 parity;
// data rows only when crc_inputs). level_cols (levels, 32) shifts by
// 16 * 2^l bytes.
__global__ void fused_encode_crc_kernel(
    const int8_t* __restrict__ bigm, const uint8_t* __restrict__ data, int k,
    int m, long long n, int bs, int splits,
    const uint32_t* __restrict__ level_cols, int levels,
    uint8_t* __restrict__ parity, uint32_t* __restrict__ regs_out,
    int crc_inputs) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t(*tabs)[256] = reinterpret_cast<uint32_t(*)[256]>(smem);
  uint32_t* cols = reinterpret_cast<uint32_t*>(smem + 8 * 256 * 4);
  uint32_t* regs = cols + kMaxLevels * 32;
  const int T = blockDim.x;
  const int rows = k + m;
  uint8_t* nib = reinterpret_cast<uint8_t*>(regs + rows * T);
  build_nibble_tables(bigm, m, k, nib);
  for (int e = threadIdx.x; e < levels * 32; e += blockDim.x) cols[e] = level_cols[e];
  build_crc_tables(tabs);  // ends synchronised: nib and cols are visible
  const int row0 = crc_inputs ? 0 : k;
  const long long nb = n / bs;
  for (long long cta = blockIdx.x; cta < nb * splits; cta += gridDim.x) {
    const long long blk = cta / splits;
    const int s = static_cast<int>(cta - blk * splits);
    const long long col = blk * bs + static_cast<long long>(s) * T * 16 + threadIdx.x * 16;
    for (int i0 = 0; i0 < m; i0 += 4) {
      uint4 acc[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] = make_uint4(0, 0, 0, 0);
      for (int j = 0; j < k; ++j) {
        const uint4 x = *reinterpret_cast<const uint4*>(data + j * n + col);
        if (i0 == 0 && crc_inputs) regs[j * T + threadIdx.x] = crc_raw16(tabs, 0u, x);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (i0 + g < m) xor_gf_vec(acc[g], nib + ((i0 + g) * k + j) * 32, x);
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (i0 + g < m) {
          *reinterpret_cast<uint4*>(parity + (i0 + g) * n + col) = acc[g];
          regs[(k + i0 + g) * T + threadIdx.x] = crc_raw16(tabs, 0u, acc[g]);
        }
      }
    }
    __syncthreads();
    crc_tree(regs + row0 * T, rows - row0, T, cols, levels);
    for (int row = row0 + threadIdx.x; row < rows; row += T)
      regs_out[(row * nb + blk) * splits + s] = regs[row * T];
    __syncthreads();
  }
}

// out[e] = K ^ fold of regs[e, 0:splits] (slab registers, first slab
// first) with slab_cols = S^slab; ok[e] = out[e] == expected[e] when ok is
// given.
__global__ void crc_fold_kernel(const uint32_t* __restrict__ regs,
                                long long count, int splits,
                                const uint32_t* __restrict__ slab_cols,
                                uint32_t k_const, uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ expected,
                                uint8_t* __restrict__ ok) {
  __shared__ uint32_t cols[32];
  if (threadIdx.x < 32) cols[threadIdx.x] = slab_cols[threadIdx.x];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < count; e += stride) {
    uint32_t reg = 0;
    for (int s = 0; s < splits; ++s) reg = gf2_apply(cols, reg) ^ regs[e * splits + s];
    const uint32_t crc = reg ^ k_const;
    out[e] = crc;
    if (ok != nullptr) ok[e] = crc == expected[e];
  }
}

long long grid_for(long long units, int threads, long long cap) {
  long long g = (units + threads - 1) / threads;
  return g < 1 ? 1 : (g > cap ? cap : g);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (ctypes): pointers and the stream as void*.
// ---------------------------------------------------------------------------

extern "C" {

int lz_gf_apply(const void* bigm, const void* data, void* out, int w, int r,
                long long n, int vec16, void* stream) {
  const int threads = 256;
  const size_t smem = static_cast<size_t>(w) * r * 32;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* mat = static_cast<const int8_t*>(bigm);
  const auto* in = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  if (vec16) {
    const long long grid = grid_for(n / 16, threads, 4096);
    gf_apply_kernel<true><<<static_cast<unsigned>(grid), threads, smem, s>>>(mat, in, o, w, r, n);
  } else {
    const long long grid = grid_for(n, threads, 4096);
    gf_apply_kernel<false><<<static_cast<unsigned>(grid), threads, smem, s>>>(mat, in, o, w, r, n);
  }
  return static_cast<int>(cudaGetLastError());
}

int lz_block_crcs(const void* blocks, long long nblocks, int bs, int threads,
                  const void* level_cols, int levels, unsigned int k_const,
                  void* out, void* stream) {
  const long long grid = nblocks < 65536 ? nblocks : 65536;
  block_crc_kernel<<<static_cast<unsigned>(grid), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks), nblocks, bs,
      static_cast<const uint32_t*>(level_cols), levels, k_const,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

int lz_fused_encode_crc(const void* bigm, const void* data, int k, int m,
                        long long n, int bs, int threads, int splits,
                        const void* level_cols, int levels, void* parity,
                        void* regs, int crc_inputs, void* stream) {
  const size_t smem = 8 * 256 * 4 + kMaxLevels * 32 * 4 +
                      static_cast<size_t>(k + m) * threads * 4 +
                      static_cast<size_t>(m) * k * 32;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_encode_crc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long ctas = (n / bs) * splits;
  const long long grid = ctas < 65536 ? ctas : 65536;
  fused_encode_crc_kernel<<<static_cast<unsigned>(grid), threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(bigm), static_cast<const uint8_t*>(data), k,
      m, n, bs, splits, static_cast<const uint32_t*>(level_cols), levels,
      static_cast<uint8_t*>(parity), static_cast<uint32_t*>(regs), crc_inputs);
  return static_cast<int>(cudaGetLastError());
}

int lz_crc_fold(const void* regs, long long count, int splits,
                const void* slab_cols, unsigned int k_const, void* out,
                const void* expected, void* ok, void* stream) {
  const int threads = 256;
  const long long grid = grid_for(count, threads, 65536);
  crc_fold_kernel<<<static_cast<unsigned>(grid), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(regs), count, splits,
      static_cast<const uint32_t*>(slab_cols), k_const,
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(expected),
      static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
