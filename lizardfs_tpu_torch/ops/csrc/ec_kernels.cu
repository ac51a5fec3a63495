// Hand-written Hopper (sm_90a) kernels for the erasure-coding data plane.
//
// Built by lizardfs_tpu_torch/ops/_build.py with nvcc into a shared library
// with a plain C interface (bottom of this file) and bound with ctypes by
// lizardfs_tpu_torch/ops/cuda_ec.py. Every launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Every kernel reads only tables built on the host with numpy
// (lizardfs_tpu_torch/ops/kernel_tables.py, cached per matrix and device
// by the wrappers). A grid of the CTAs that fit on the card at once
// (lz_resident, asked once per shape by the wrapper) copies them into
// shared memory with 16-byte loads and one barrier, then walks the work
// with its grid stride. Two building blocks carry all four TPU functions:
//
//  * GF(2^8) matrix apply through packed nibble tables. For each group q
//    of four output rows and each input row j, 16 lo and 16 hi words sit
//    in one aligned run of 32; byte g of lo[n] (hi[n]) is the product of
//    output row 4q+g's coefficient for row j with n (n << 4). One pair of
//    32-bit lookups per input byte (xor_packed) thus serves four output
//    rows: the same GF(2)-linear map the TPU computes as a bit-plane
//    matmul on the MXU. A row's 32 words fill 16 banks per lookup, free
//    of conflicts. 16 packed accumulators a thread (one per byte of its
//    16-byte column unit) are turned into the four rows' bytes with eight
//    __byte_perm (transpose4) only at the end.
//
//  * CRC32 of 16-byte spans combined by table-driven shifts. Each thread
//    takes the raw register (init 0, no final XOR) of its span with
//    slicing-by-8 tables (crc_raw16); registers of adjacent spans combine
//    as R(A||B) = S^|B| R(A) ^ R(B), where a shift S^n (n zero bytes,
//    lizardfs_tpu_torch/ops/crc32.py:shift_matrix) is 8 nibble tables,
//    N[q][x] = S^n (x << 4q), so a combine is the XOR of 8 lookups
//    (shift_nibbles). crc_tree_nibbles folds the span registers of a slab
//    (16 * blockDim.x bytes) in shared memory, one pad word per 32 so
//    that its strided pairs hit distinct banks; crc_fold_kernel folds the
//    slab registers of each block by Horner's rule with S^slab and XORs
//    K = crc32 of block_size zero bytes. This is the affine decomposition
//    of ops/crc32.py.
//
// Kernels and the TPU kernels they replace (lizardfs_tpu/ops/pallas_ec.py):
//
//  gf_apply_kernel          replaces `encode` (:91-118, pallas_call :108).
//    Bound by bytes on the H100: r input rows read once, w output rows
//    written once (the bit-plane formulation's int8 work is below the
//    memory time at EC shapes). Design: each thread step takes one
//    16-byte column unit of all r input rows (coalesced 512-byte warp
//    loads), one packed lookup pair per input byte for each group of
//    four output rows; groups short of four rows (w = 1 in a one-part
//    rebuild) read zero bytes in the unused lanes and skip their stores.
//    Inputs are re-read per group (from L1/L2) when w > 4. A byte-wise
//    instantiation covers lengths that are no multiple of 16 and
//    unaligned rows.
//
//  block_crc_kernel         replaces `block_crcs` (:146-190, pallas_call
//  + crc_fold_kernel         :166 plus the XLA log-tree fold). Bound by
//    bytes: each block is read once. Design: the fused kernel's CRC half,
//    over blocks instead of rows. A thread's span is kCrcVecs = 2
//    vectors of 16 bytes, a slab 128 spans (4 KiB), and a CTA of 256
//    threads loads 256 consecutive spans at a time (each warp load covers
//    1 KiB, half of each 32-byte sector, the other half by the next
//    load). A CTA takes kCrcSteps = 4 loads a step, issues the next
//    step's loads before folding this step's slabs in one tree, and
//    writes one raw register per slab; crc_fold_kernel folds them per
//    block. What bounds it is shared memory and integer issue together:
//    the slicing-by-8 lookups hit about 3.15-way bank conflicts (their
//    indices are random bytes), and the ways that remove them (lane-
//    private or nibble tables) cost more integer instructions than the
//    conflicts (PERF.md).
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
//    registers of all k+m rows of its slab in shared memory;
//    crc_fold_kernel then folds the slab registers of each (row, block),
//    XORs K, and optionally compares with the stored CRCs.
//
// What bounds the fused and block CRC designs on the H100 is integer
// issue and shared memory, not bytes: each lookup spends about three
// integer instructions on its nibble's or byte's offset and its table's
// address (the `sass` lines of chip_smoke.py; PERF.md). The GF apply
// alone moves its bytes at about two thirds of the memory rate.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCrcTableWords = 8 * 256;  // slicing-by-8 tables
constexpr int kShiftWords = 8 * 16;      // one shift as 8 nibble tables
constexpr int kGfRowWords = 32;          // 16 lo + 16 hi packed words
constexpr int kCrcSteps = 4;  // loads a step of block_crc_kernel
constexpr int kCrcVecs = 2;   // 16-byte vectors a span of block_crc_kernel

// ---------------------------------------------------------------------------
// Device functions: host-built tables, packed GF lookups, raw CRC
// registers and table-driven CRC shifts.
// ---------------------------------------------------------------------------

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

// A log tree over `rows` rows of T = 2^levels span registers, `stride`
// words apart in the span_slot layout; level_tabs + kShiftWords * l
// shifts by the length of 2^l spans. On return regs[row * stride] is the
// register of the whole row. Entry and exit are synchronised.
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

// out (w, n) = the GF(2^8) matrix of gf_tabs applied to data (r, n);
// gf_tabs (ceil(w/4), r, 32) are the packed tables of kernel_tables.py.
// kVec16: n % 16 == 0 and 16-byte aligned rows, one 16-byte column unit a
// thread step; otherwise one byte a step, whose output byte g of a group
// is byte g of the accumulated word.
template <bool kVec16>
__global__ void __launch_bounds__(256) gf_apply_kernel(
    const uint32_t* __restrict__ gf_tabs, const uint8_t* __restrict__ data,
    uint8_t* __restrict__ out, int w, int r, long long n) {
  extern __shared__ uint4 smem[];
  uint32_t* const gf = reinterpret_cast<uint32_t*>(smem);
  const int groups = (w + 3) / 4;
  copy_table(gf, gf_tabs, groups * r * kGfRowWords);
  __syncthreads();
  const long long units = kVec16 ? n / 16 : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       u < units; u += stride) {
    for (int q = 0; q < groups; ++q) {
      const uint32_t* const t = gf + q * r * kGfRowWords;
      if constexpr (kVec16) {
        uint32_t acc[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) acc[b] = 0;
        for (int j = 0; j < r; ++j)
          xor_packed(acc, t + j * kGfRowWords,
                     *reinterpret_cast<const uint4*>(data + j * n + u * 16));
        uint32_t o[4][4];  // [word of the 16 bytes][output row of the group]
#pragma unroll
        for (int v = 0; v < 4; ++v) transpose4(acc + 4 * v, o[v]);
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (4 * q + g < w)
            *reinterpret_cast<uint4*>(out + (4 * q + g) * n + u * 16) =
                make_uint4(o[0][g], o[1][g], o[2][g], o[3][g]);
      } else {
        uint32_t acc = 0;
        for (int j = 0; j < r; ++j) {
          const uint32_t b = data[j * n + u];
          acc ^= t[j * kGfRowWords + (b & 15u)] ^ t[j * kGfRowWords + 16u + (b >> 4)];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
          if (4 * q + g < w) out[(4 * q + g) * n + u] = static_cast<uint8_t>(acc >> (8 * g));
      }
    }
  }
}

// x[i][v] = vector v of this thread's span in load i of the step at slab
// c0 (block_crc_kernel's layout), for the loads that hold slabs.
__device__ __forceinline__ void load_step(uint4 (&x)[kCrcSteps][kCrcVecs],
                                          const uint8_t* __restrict__ blocks,
                                          long long c0, long long slabs, int G,
                                          int row, long long load) {
  const uint4* const p = reinterpret_cast<const uint4*>(
      blocks + c0 * (load / G) + threadIdx.x * 16LL * kCrcVecs);
#pragma unroll
  for (int i = 0; i < kCrcSteps; ++i)
#pragma unroll
    for (int v = 0; v < kCrcVecs; ++v)
      if (c0 + i * G + row < slabs) x[i][v] = p[i * (load / 16) + v];
}

// Raw CRC registers of the slabs that tile the blocks: a slab is T =
// 2^levels spans of kCrcVecs * 16 bytes, and regs_out[c] is the register
// of bytes [c * slab, (c + 1) * slab). crc_tabs (8, 256) and level_tabs
// (levels, 8, 16) are the host-built tables of kernel_tables.py; level l
// shifts by 2^l spans. A load covers blockDim.x spans, G = blockDim.x / T
// slabs (T <= blockDim.x): thread t takes span t % T of slab t / T, so the
// CTA reads blockDim.x * kCrcVecs * 16 contiguous bytes. A step takes
// kCrcSteps loads (fewer slabs at the end) and folds their kCrcSteps * G
// rows in one tree; the next step's loads are issued before the tree. Two
// register buffers alternate between steps, so a step needs no barrier
// after its registers are read out.
__global__ void __launch_bounds__(256) block_crc_kernel(
    const uint8_t* __restrict__ blocks, long long slabs,
    const uint32_t* __restrict__ crc_tabs,
    const uint32_t* __restrict__ level_tabs, int levels,
    uint32_t* __restrict__ regs_out) {
  extern __shared__ uint4 smem[];
  uint32_t* const sm = reinterpret_cast<uint32_t*>(smem);
  uint32_t* const lvl = sm + kCrcTableWords;
  uint32_t* const regs = lvl + levels * kShiftWords;
  copy_table(sm, crc_tabs, kCrcTableWords);
  copy_table(lvl, level_tabs, levels * kShiftWords);
  const int G = blockDim.x >> levels;
  const int row = threadIdx.x >> levels;
  const long long per = static_cast<long long>(kCrcSteps) * G;  // slabs a step
  const long long load = 16LL * kCrcVecs * blockDim.x;         // bytes a load
  uint4 x[kCrcSteps][kCrcVecs];
  long long c0 = blockIdx.x * per;
  if (c0 < slabs) load_step(x, blocks, c0, slabs, G, row, load);
  __syncthreads();
  const uint32_t(*tabs)[256] = reinterpret_cast<const uint32_t(*)[256]>(sm);
  const int stride = span_slot(1 << levels);
  const int slot = span_slot(threadIdx.x & ((1 << levels) - 1));
  uint32_t* buf = regs;
  for (; c0 < slabs; c0 += gridDim.x * per) {
    const int rows = slabs - c0 < per ? static_cast<int>(slabs - c0) : static_cast<int>(per);
#pragma unroll
    for (int i = 0; i < kCrcSteps; ++i) {
      uint32_t crc = 0;
#pragma unroll
      for (int v = 0; v < kCrcVecs; ++v) crc = crc_raw16(tabs, crc, x[i][v]);
      if (i * G + row < rows) buf[(i * G + row) * stride + slot] = crc;
    }
    if (c0 + gridDim.x * per < slabs)
      load_step(x, blocks, c0 + gridDim.x * per, slabs, G, row, load);
    __syncthreads();
    crc_tree_nibbles(buf, rows, stride, levels, lvl);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) regs_out[c0 + i] = buf[i * stride];
    buf = buf == regs ? regs + per * stride : regs;
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

// ---------------------------------------------------------------------------
// Host side: shared-memory sizes, the occupancy query, the fold launch.
// ---------------------------------------------------------------------------

// Kernel ids of lz_resident.
enum KernelId : int { kFused = 0, kGfApplyVec = 1, kGfApplyByte = 2, kBlockCrc = 3 };

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

// Shared memory of gf_apply_kernel: the packed GF tables.
size_t gf_smem_bytes(int w, int r) {
  return 4 * static_cast<size_t>((w + 3) / 4) * r * kGfRowWords;
}

// Shared memory of block_crc_kernel: the CRC tables, the tree's shift
// tables, then two buffers of kCrcSteps * threads / 2^levels rows of
// 2^levels span registers.
size_t crc_smem_bytes(int threads, int levels) {
  const size_t rows = static_cast<size_t>(kCrcSteps) * (threads >> levels);
  return 4 * (kCrcTableWords + static_cast<size_t>(levels) * kShiftWords +
              2 * rows * span_slot(1 << levels));
}

// CTAs of `kernel` with `threads` threads and `smem` bytes of dynamic
// shared memory that fit on the current device at once (at least 1), or
// minus the CUDA error. Also lets the kernel take the device's opt-in
// shared memory.
template <typename Kernel>
int resident_ctas(Kernel kernel, int threads, size_t smem) {
  int device = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// crc_fold_kernel over `count` rows of `splits` slab registers.
cudaError_t launch_fold(const uint32_t* regs, long long count, int splits,
                        const void* slab_tab, uint32_t k_const, void* out,
                        const void* expected, void* ok, cudaStream_t s) {
  const int threads = 256;  // >= kShiftWords
  const long long grid = grid_for(count, threads, 65536);
  crc_fold_kernel<<<static_cast<unsigned>(grid), threads, 0, s>>>(
      regs, count, splits, static_cast<const uint32_t*>(slab_tab), k_const,
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(expected),
      static_cast<uint8_t*>(ok));
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface (ctypes): pointers and the stream as void*.
// ---------------------------------------------------------------------------

extern "C" {

// CTAs of one kernel (KernelId) that fit on the current device at once
// for this shape (at least 1), or minus the CUDA error; also lets the
// kernel take the device's opt-in shared memory. rows_in, rows_out: k and
// m of the fused kernel, r and w of the GF apply, the loads a step and
// the vectors a span of the block CRC. The wrappers ask once per shape and device and pass the
// count to every launch.
int lz_resident(int kernel, int threads, int rows_in, int rows_out, int levels) {
  switch (kernel) {
    case kFused:
      return resident_ctas(fused_encode_crc_kernel, threads,
                           fused_smem_bytes(rows_in, rows_out, threads, levels));
    case kGfApplyVec:
      return resident_ctas(gf_apply_kernel<true>, threads, gf_smem_bytes(rows_out, rows_in));
    case kGfApplyByte:
      return resident_ctas(gf_apply_kernel<false>, threads, gf_smem_bytes(rows_out, rows_in));
    case kBlockCrc:
      if (rows_in == kCrcSteps && rows_out == kCrcVecs)
        return resident_ctas(block_crc_kernel, threads, crc_smem_bytes(threads, levels));
      break;
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

// out (w, n) = the matrix of gf_tabs applied to data (r, n), over a grid
// of at most `resident` CTAs (lz_resident) of `threads` threads. vec16:
// n % 16 == 0 and the rows 16-byte aligned.
int lz_gf_apply(const void* gf_tabs, const void* data, void* out, int w, int r,
                long long n, int vec16, int threads, int resident, void* stream) {
  const size_t smem = gf_smem_bytes(w, r);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* tabs = static_cast<const uint32_t*>(gf_tabs);
  const auto* in = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  const long long grid = grid_for(vec16 ? n / 16 : n, threads, resident);
  if (vec16)
    gf_apply_kernel<true><<<static_cast<unsigned>(grid), threads, smem, s>>>(tabs, in, o, w, r, n);
  else
    gf_apply_kernel<false><<<static_cast<unsigned>(grid), threads, smem, s>>>(tabs, in, o, w, r, n);
  return static_cast<int>(cudaGetLastError());
}

// out[b] = crc32 of blocks[b, 0:bs]: block_crc_kernel over a grid of at
// most `resident` CTAs of `threads` threads, with slabs of 2^levels spans
// (bs = splits * slab), into regs (nblocks * splits words), then the fold
// with slab_tab = S^slab. One call launches both. steps and vecs are the
// caller's kCrcSteps and kCrcVecs, checked.
int lz_block_crcs(const void* blocks, long long nblocks, int threads, int splits,
                  int steps, int vecs, const void* crc_tabs, const void* level_tabs,
                  int levels, const void* slab_tab, unsigned int k_const, int resident,
                  void* regs, void* out, void* stream) {
  if (steps != kCrcSteps || vecs != kCrcVecs) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long slabs = nblocks * splits;
  const long long per = static_cast<long long>(kCrcSteps) * (threads >> levels);
  const long long n = (slabs + per - 1) / per;
  const long long grid = n < resident ? n : resident;
  auto* r = static_cast<uint32_t*>(regs);
  block_crc_kernel<<<static_cast<unsigned>(grid), threads, crc_smem_bytes(threads, levels), s>>>(
      static_cast<const uint8_t*>(blocks), slabs, static_cast<const uint32_t*>(crc_tabs),
      static_cast<const uint32_t*>(level_tabs), levels, r);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_fold(r, nblocks, splits, slab_tab, k_const, out,
                                      nullptr, nullptr, s));
}

// The fused pass over a grid of at most `resident` CTAs (lz_resident),
// each copying the tables once and walking slabs, then the fold of the
// registers of the rows whose CRCs are returned: all k + m rows, or with
// `expected` (a rebuild) the m output rows, compared into `ok`. crc_out
// is (rows, n / bs) or (m, n / bs).
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
  return static_cast<int>(launch_fold(r + row0 * nb * splits, (k + m - row0) * nb, splits,
                                      slab_tab, k_const, crc_out, expected, ok, s));
}

}  // extern "C"
