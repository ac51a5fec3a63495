// Hand-written Hopper (sm_90a) kernels for the erasure-coding data plane.
//
// Built by lizardfs_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface (bottom of this file) and bound with ctypes by
// lizardfs_tpu_torch/ops/cuda_ec.py. Every launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Two device-side building blocks carry all four kernel functions; the
// fused kernel has its own forms of both (device function 3, below):
//
//  * GF(2) matrix apply through split-nibble tables. An (8w, 8r) bit-plane
//    matrix over GF(2) (lizardfs_tpu_torch/ops/bitplane.py) is turned by
//    gf_apply_kernel, at block start, into one 32-byte table per (output
//    row i, input row j):
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
//    once, parity out once, 100.7 MB for an ec(8,4) 64 MiB chunk) at
//    the memory rate. Layout: a 64 KiB block is split over `splits`
//    slabs of 16 bytes a thread (a 64 MiB ec(8,4) chunk has only 128
//    blocks, fewer than the 132 SMs); a CTA reads its slab of all k data
//    rows once, writes the slab's parity once, and folds the raw CRC
//    registers of all k+m rows of its slab in shared memory.
//    crc_fold_kernel then folds the slab registers of each (row, block)
//    by Horner's rule with S^slab (the Pallas `comb` matrix), XORs K,
//    and optionally compares with the stored CRCs.
//    What held the first design back was shared-memory issue work, not
//    bytes: two byte loads per input byte per output row from
//    per-(row, row) tables, a 32-step GF(2) column walk per CRC combine,
//    and tables rebuilt by every CTA from the bit-plane matrix. This
//    design reads only tables built on the host
//    (lizardfs_tpu_torch/ops/kernel_tables.py), copied into shared
//    memory with 16-byte loads and one barrier by each of a grid sized
//    to the resident CTAs, which then walk the slabs:
//     - one pair of 32-bit lookups per input byte serves four parity
//       rows: table word byte g is output row 4q+g's product, the 16
//       lo and 16 hi words of a row sit in one aligned run of 32 (16
//       banks per lookup, no conflicts); 16 packed accumulators per
//       thread are transposed into the four rows' bytes with __byte_perm
//       only at the end;
//     - a CRC combine is the XOR of 8 lookups in nibble tables of the
//       shift (N[q][x] = S^n (x << 4q)) instead of 32 column steps;
//       the registers of a row sit one word apart with one pad word per
//       32, so the tree's strided pairs hit distinct banks.
//    What bounds this design on the H100 is integer issue: each lookup
//    spends about three integer instructions on its nibble's offset and
//    its table's address (the `sass` lines of chip_smoke.py; PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kCrcPoly = 0xEDB88320u;
constexpr int kMaxLevels = 8;  // log2 of the largest CTA (256 threads)
constexpr int kCrcTableWords = 8 * 256;  // slicing-by-8 tables
constexpr int kShiftWords = 8 * 16;      // one shift as 8 nibble tables
constexpr int kGfRowWords = 32;          // 16 lo + 16 hi packed words

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
// Device function 3 (fused kernel): host-built tables, packed GF lookups
// and table-driven CRC shifts.
// ---------------------------------------------------------------------------

// dst[0:words] = src[0:words] with 16-byte loads; words % 4 == 0 and both
// pointers 16-byte aligned. The caller synchronises.
__device__ __forceinline__ void copy_table(uint32_t* dst,
                                           const uint32_t* __restrict__ src,
                                           int words) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) d[i] = s[i];
}

// acc[4 * w + p] ^= the packed products of byte p of word w of x: t[0:16]
// are the lo-nibble words, t[16:32] the hi-nibble words of one input row.
__device__ __forceinline__ void xor_packed(uint32_t (&acc)[16],
                                           const uint32_t* t, const uint4 x) {
  const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t b = words[w] >> (8 * p);
      acc[4 * w + p] ^= t[b & 15u] ^ t[16u + ((b >> 4) & 15u)];
    }
  }
}

// 4x4 byte transpose: byte p of o[g] = byte g of a[p].
__device__ __forceinline__ void transpose4(const uint32_t* a, uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140);  // a0.b0 a1.b0 a0.b1 a1.b1
  const uint32_t t1 = __byte_perm(a[2], a[3], 0x5140);  // a2.b0 a3.b0 a2.b1 a3.b1
  const uint32_t t2 = __byte_perm(a[0], a[1], 0x7362);  // a0.b2 a1.b2 a0.b3 a1.b3
  const uint32_t t3 = __byte_perm(a[2], a[3], 0x7362);  // a2.b2 a3.b2 a2.b3 a3.b3
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// S v for a shift S given as 8 nibble tables: t[16 q + x] = S (x << 4q).
__device__ __forceinline__ uint32_t shift_nibbles(const uint32_t* t, uint32_t v) {
  uint32_t out = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) out ^= t[16 * q + ((v >> (4 * q)) & 15u)];
  return out;
}

// Word offset of span register t in a row: one pad word per 32, so that
// the tree's pairs at strides of 2..32 words fall in distinct banks.
__host__ __device__ inline int span_slot(int t) { return t + (t >> 5); }

// crc_tree with the shifts as nibble tables (level_tabs + kShiftWords * l
// shifts by the length of 2^l spans) and rows `stride` words apart in the
// span_slot layout; T = 2^levels spans a row. On return regs[row *
// stride] is the register of the whole row. Entry and exit are
// synchronised.
__device__ void crc_tree_nibbles(uint32_t* regs, int rows, int stride,
                                 int levels, const uint32_t* level_tabs) {
  for (int l = 0; l < levels; ++l) {
    const int lp = levels - 1 - l;  // log2 of the pairs in a row
    const uint32_t* tab = level_tabs + kShiftWords * l;
    for (int e = threadIdx.x; e < (rows << lp); e += blockDim.x) {
      const int row = e >> lp;
      const int left = (e - (row << lp)) << (l + 1);
      uint32_t* r = regs + row * stride;
      r[span_slot(left)] =
          shift_nibbles(tab, r[span_slot(left)]) ^ r[span_slot(left + (1 << l))];
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

// Slab c of the grid-stride walk covers columns [blk*bs + s*T*16, +T*16)
// of the k data rows, c = blk * splits + s. Writes the slab's parity and
// regs_out[(row, blk, s)] = raw CRC register of the slab of each row
// (rows 0..k-1 data, k..k+m-1 parity; data rows only when crc_inputs).
// gf_tabs (ceil(m/4), k, 32), crc_tabs (8, 256) and level_tabs (levels,
// 8, 16) are the host-built tables of kernel_tables.py; level l shifts by
// 16 * 2^l bytes.
__global__ void __launch_bounds__(256) fused_encode_crc_kernel(
    const uint32_t* __restrict__ gf_tabs, const uint8_t* __restrict__ data,
    int k, int m, long long n, int bs, int splits,
    const uint32_t* __restrict__ crc_tabs,
    const uint32_t* __restrict__ level_tabs, int levels,
    uint8_t* __restrict__ parity, uint32_t* __restrict__ regs_out,
    int crc_inputs) {
  extern __shared__ uint4 smem[];
  uint32_t* const sm = reinterpret_cast<uint32_t*>(smem);
  const int groups = (m + 3) / 4;
  uint32_t* const lvl = sm + kCrcTableWords;
  uint32_t* const gf = lvl + levels * kShiftWords;
  uint32_t* const regs = gf + groups * k * kGfRowWords;
  copy_table(sm, crc_tabs, kCrcTableWords);
  copy_table(lvl, level_tabs, levels * kShiftWords);
  copy_table(gf, gf_tabs, groups * k * kGfRowWords);
  __syncthreads();
  const uint32_t(*tabs)[256] = reinterpret_cast<const uint32_t(*)[256]>(sm);
  const int T = blockDim.x;
  const int stride = span_slot(T);
  const int slot = span_slot(threadIdx.x);
  const int rows = k + m;
  const int row0 = crc_inputs ? 0 : k;
  const long long nb = n / bs;
  for (long long c = blockIdx.x; c < nb * splits; c += gridDim.x) {
    const long long blk = c / splits;
    const int s = static_cast<int>(c - blk * splits);
    const long long col = blk * bs + static_cast<long long>(s) * T * 16 + threadIdx.x * 16;
    for (int q = 0; q < groups; ++q) {
      uint32_t acc[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) acc[b] = 0;
      for (int j = 0; j < k; ++j) {
        const uint4 x = *reinterpret_cast<const uint4*>(data + j * n + col);
        if (q == 0 && crc_inputs) regs[j * stride + slot] = crc_raw16(tabs, 0u, x);
        xor_packed(acc, gf + (q * k + j) * kGfRowWords, x);
      }
      uint32_t out[4][4];  // [word of the 16 bytes][output row of the group]
#pragma unroll
      for (int w = 0; w < 4; ++w) transpose4(acc + 4 * w, out[w]);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int row = 4 * q + g;
        if (row < m) {
          const uint4 v = make_uint4(out[0][g], out[1][g], out[2][g], out[3][g]);
          *reinterpret_cast<uint4*>(parity + row * n + col) = v;
          regs[(k + row) * stride + slot] = crc_raw16(tabs, 0u, v);
        }
      }
    }
    __syncthreads();
    crc_tree_nibbles(regs + row0 * stride, rows - row0, stride, levels, lvl);
    for (int row = row0 + threadIdx.x; row < rows; row += T)
      regs_out[(row * nb + blk) * splits + s] = regs[row * stride];
    __syncthreads();
  }
}

// out[e] = K ^ fold of regs[e, 0:splits] (slab registers, first slab
// first) with slab_tab = S^slab as nibble tables (8, 16); ok[e] = out[e]
// == expected[e] when ok is given. blockDim.x >= kShiftWords.
__global__ void crc_fold_kernel(const uint32_t* __restrict__ regs,
                                long long count, int splits,
                                const uint32_t* __restrict__ slab_tab,
                                uint32_t k_const, uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ expected,
                                uint8_t* __restrict__ ok) {
  __shared__ uint32_t tab[kShiftWords];
  if (threadIdx.x < kShiftWords) tab[threadIdx.x] = slab_tab[threadIdx.x];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < count; e += stride) {
    uint32_t reg = 0;
    for (int s = 0; s < splits; ++s) reg = shift_nibbles(tab, reg) ^ regs[e * splits + s];
    const uint32_t crc = reg ^ k_const;
    out[e] = crc;
    if (ok != nullptr) ok[e] = crc == expected[e];
  }
}

long long grid_for(long long units, int threads, long long cap) {
  long long g = (units + threads - 1) / threads;
  return g < 1 ? 1 : (g > cap ? cap : g);
}

// Shared memory of fused_encode_crc_kernel in bytes: the CRC tables, the
// tree's shift tables, the packed GF tables, then k + m rows of span
// registers in the span_slot layout.
size_t fused_smem_bytes(int k, int m, int threads, int levels) {
  const size_t groups = (m + 3) / 4;
  return 4 * (kCrcTableWords + static_cast<size_t>(levels) * kShiftWords +
              groups * k * kGfRowWords +
              static_cast<size_t>(k + m) * span_slot(threads));
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

// CTAs of fused_encode_crc_kernel that fit on the current device at once
// for this shape (at least 1), or minus the CUDA error. Also lets the
// kernel take the device's opt-in shared memory. The wrapper calls it
// once per shape and device and passes the count to every launch.
int lz_fused_resident(int k, int m, int threads, int levels) {
  const size_t smem = fused_smem_bytes(k, m, threads, levels);
  int device = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fused_encode_crc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_encode_crc_kernel, threads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// The fused pass over a grid of at most `resident` CTAs
// (lz_fused_resident), each copying the tables once and walking slabs,
// then the fold of the registers of the rows whose CRCs are returned: all
// k + m rows, or with `expected` (a rebuild) the m output rows, compared
// into `ok`. crc_out is (rows, n / bs) or (m, n / bs).
int lz_fused_encode_crc(const void* gf_tabs, const void* data, int k, int m,
                        long long n, int bs, int threads, int splits,
                        const void* crc_tabs, const void* level_tabs, int levels,
                        const void* slab_tab, unsigned int k_const, int resident,
                        void* parity, void* regs, void* crc_out,
                        const void* expected, void* ok, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int crc_inputs = expected == nullptr;
  const size_t smem = fused_smem_bytes(k, m, threads, levels);
  const long long nb = n / bs;
  const long long ctas = nb * splits;
  const long long grid = ctas < resident ? ctas : resident;
  auto* r = static_cast<uint32_t*>(regs);
  fused_encode_crc_kernel<<<static_cast<unsigned>(grid), threads, smem, s>>>(
      static_cast<const uint32_t*>(gf_tabs), static_cast<const uint8_t*>(data),
      k, m, n, bs, splits, static_cast<const uint32_t*>(crc_tabs),
      static_cast<const uint32_t*>(level_tabs), levels,
      static_cast<uint8_t*>(parity), r, crc_inputs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row0 = crc_inputs ? 0 : k;
  const long long count = (k + m - row0) * nb;
  const int fold_threads = 256;  // >= kShiftWords
  const long long fold_grid = grid_for(count, fold_threads, 65536);
  crc_fold_kernel<<<static_cast<unsigned>(fold_grid), fold_threads, 0, s>>>(
      r + row0 * nb * splits, count, splits, static_cast<const uint32_t*>(slab_tab),
      k_const, static_cast<uint32_t*>(crc_out), static_cast<const uint32_t*>(expected),
      static_cast<uint8_t*>(ok));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
