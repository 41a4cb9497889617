// Kernels B2 and B3 for Hopper: the fused int8 MLP fraud scorer.
//
// Replaces the Pallas TPU kernels of ccfd_tpu/ops/fused_mlp_q8.py:
//   B2  _kernel       (entry fused_mlp_q8_score)       -> fused_mlp_q8_kernel
//   B3  _kernel_preq  (entry fused_mlp_q8_score_preq)  -> fused_mlp_q8_preq_kernel,
//                     and fused_mlp_q8_preq_kernel_cluster for small batches
// Both compute the served int8 graph (ccfd_tpu/ops/quant.py logits) with
// its rounding points, in one device function q8_body<kPreq> (and B3's
// cluster kernel, which keeps every rounding point):
//
//   B2 only:  h0 = x - mu, h = h0 / sigma             IEEE division by raw sigma
//   before each layer, per row:
//             s = max(amax(|h|) / 127, 1e-8)          IEEE division
//             q = clamp(rint(h / s), -127, 127)       rint: half to even
//   B3 starts here, with q and s of layer 1 computed on the host
//   (ops/fused_mlp_q8.py prequantize_rows_numpy) and F + 4 bytes a row on the wire.
//   layers 1, 2:  acc = q @ Wq (int8 x int8 -> int32 on the tensor cores)
//                 h = relu(((float)acc * s) * scale + b)
//   layer 3:      z = ((float)(q . w3q) * s) * s3 + b3   the int32 dot is exact,
//                 equal to the reference's f32 sum of integers below 2^24
//   p = 1 / (1 + expf(-z))
//
// Every multiply and add of the dequant is an explicit __fmul_rn/__fadd_rn,
// every division __fdiv_rn: nvcc would otherwise contract mul+add into an FMA,
// and a one-ulp change before a requantization moves a quantization step
// (the reference measured up to 4e-3 in p from one such ulp). The library is
// built without --use_fast_math.
//
// Widths: F up to 128 (the reference's lane bound) and H up to 1,040 (its
// bound for the integer-exact layer-3 sum). The host zero-pads F to a
// multiple of 32 and H to a multiple of 64, which is exact: a padded input
// is 0; a padded column has zero weights, scale and bias, so h = relu(0) = 0,
// which never raises a row's max (h >= 0 after relu) and quantizes to 0, and
// its w3 entry is 0.
//
// What bounds them: a row costs 2 * (30*256 + 256*256 + 256) = 146,944 int8
// operations at H = 256, against 124 bytes of f32 rows and output (B2) or 38
// bytes (B3). At B = 16384 that is 2.41e9 operations, 1.22 us at the H100's
// 1,979 int8 TOP/s, against 0.63 us (B2) or 0.21 us (B3) of HBM traffic, so
// the tensor cores set the bound. Each row also needs ~575 (B2) or ~515 (B3)
// requantizations (h / s, rounded) on the CUDA cores, an estimated 2.8 us at
// B = 16384 as IEEE divisions, which chip_smoke.py's timing holds against
// the measured time. A requantization here is one multiply by 1/s and a
// round; the true division runs only where the product lies within 1e-4 of
// a half-integer (quantize below), and gives the same integer bit for bit.
//
// Why mma.sync and not wgmma: the products are a small share of the work
// next to the requantization passes, wgmma takes 64-row tiles only, and the
// widest models need 32-row tiles (the f32 activation tile below); so
// wgmma's rate buys nothing here yet.
//
// Design:
// - a persistent grid of min(tiles, SMs) blocks, each walking row tiles of
//   R rows: 64 where shared memory allows (H <= ~600 at F = 30), else 32.
//   A row's requantization needs its max over all H columns before
//   any of its elements is quantized, so a block owns whole rows and keeps
//   the tile's f32 activations (R x (H + 8) floats) in shared memory;
// - warp specialisation: one producer warp issues asynchronous bulk copies
//   (cp.async.bulk, completing on mbarriers), sixteen consumer warps
//   compute (one block fills an SM's shared memory, so the block brings the
//   warps that hide the passes' latencies). Nothing copies weights thread
//   by thread;
// - the host packs W1^T and W2^T (output-major, the tensor cores' "col"
//   operand) once per publish into a stream of chunks (ops/fused_mlp_q8.py
//   pack_stream), each in the exact shared-memory layout the fragment loads
//   read, row strides padded by 16 bytes against bank conflicts: layer 1 as
//   groups of 64 output rows x all of K, layer 2 as 64 output rows x a
//   K-slice of up to 256. The producer streams them through a ring of
//   17,408-byte stages in the order the consumers use them. Where the whole
//   stream fits in the ring (H <= 256 at F = 30), each block copies it once
//   and keeps it resident: on later tiles the producer only re-arms stages;
// - the row tile (f32 rows for B2; int8 rows and scales for B3) comes in
//   with bulk copies; the ragged last tile copies what exists (rounded down
//   to 16 bytes, the rest read directly) and zeroes the rest;
// - products are mma.sync.m16n8k32 s8 x s8 -> s32 on ldmatrix fragments:
//   warp w owns the 16-row slab w % (R / 16) and an R / 4-column share of
//   each 64-column group; each product's epilogue writes h and takes each
//   row's max (the float's bits order like unsigned ints for atomicMax,
//   h >= +0 after relu; layer 1's normalized input is signed, so its max is
//   taken in the warp over fabsf);
// - every requantization pass runs over all 512 consumer threads, two rows
//   a warp and four columns a lane at a time; layer 3 quantizes and dots
//   each row against w3 in one pass (__dp4a), with an exact integer warp
//   sum. Rows past the batch in a ragged tile are skipped.
//
// B3 at small batches, on a thread-block cluster. At the REST buckets (16
// and 128 rows) the persistent grid above is one or two blocks, and each
// walks a tile's whole chain alone on one SM: 0.0111 ms at B = 16 and
// 0.0146 ms at 128 on the H100, against a bound of 0.00002 ms. Latency,
// not bytes or operations, bounds it. So where hp / 64 <= 8 (a portable
// cluster), ccfd_fused_mlp_q8_preq can launch
// fused_mlp_q8_preq_kernel_cluster instead (cudaLaunchKernelEx with a
// cluster dimension of hp / 64): one cluster a 64-row tile, one CTA of 8
// warps a 64-column group. The entry launches what its caller names; the
// choice by batch lives in the Python wrapper alone (ops/fused_mlp_q8.py
// path_for, CLUSTER_MAX_BATCH).
// - Loads, by bulk copies on mbarriers from the stream pack_stream lays
//   out (nothing repacked): every CTA the tile's int8 rows, all of W1's
//   chunk with s1 and b1 (about 14 KB at H = 256), and its own group of
//   W2's chunk with its columns of s2, b2 and w3. The input scales, s3 and
//   b3 are read while the copies fly.
// - Layer 1 reads its A fragments from the rows as copied (unpadded,
//   unaligned: two words and a funnel shift). A tile of one 16-row slab
//   (bucket 16) computes all hp columns of layer 1 in every CTA, 4x the
//   products of its share but no crossing between SMs before layer 2;
//   a larger tile splits layer 1's columns like layer 2's, and the rows'
//   maxima and q(h1) cross between the CTAs.
// - Layer 2: each CTA its 64 columns over the whole K from its own q(h1);
//   one slab's warps split K in two, so no warp reads all of it. The rows'
//   maxima go to every CTA (each takes the max of the CTAs' maxima:
//   order-free, the scale bit for bit), and layer 3's exact int32 partial
//   dots of each CTA's columns to rank 0, which stores z and p.
// - Crossings: st.async stores into the receiver's shared memory, counted
//   on the receiver's mbarrier, so a CTA waits for its own data and not
//   for a barrier over the cluster; one barrier.cluster arrive (early) and
//   wait (before the first remote store) only see that every CTA's
//   mbarriers are initialised.
// - Requantizations and layer 1's int-to-float run on the FP32 pipes, not
//   the conversion unit (an eighth of their rate), through the bits of
//   1.5 * 2^23 + x: exact, so the same integers and floats bit for bit.
// What bounds it: the chain of dependent steps. SM-clock stamps at B = 16
// on the H100 (NVIDIA H100 80GB HBM3, 700 W) put each copy wait, product
// chain, crossing and requantization at 200-900 cycles and the kernel at
// ~7,700 cycles; a launch adds ~1 us. B3 takes 0.0047 ms at B = 16 and
// 0.0086 ms at 128 (chip_smoke.py).
// Crossover, measured on that card with tools/torch_q8_crossover.py (the
// two paths bit-equal at every batch; ms a launch, persistent / cluster):
// at H = 256, B = 16 0.0110 / 0.0048, 128 0.0146 / 0.0085, 1024
// 0.0145 / 0.0087, 2048 0.0150 / 0.0101, 4096 0.0152 / 0.0163, 16384
// 0.0274 / 0.0428; at H = 512, 2048 0.0283 / 0.0259, 4096 0.0286 / 0.0433.
// The wrapper takes the cluster path for batches up to 2048
// (CLUSTER_MAX_BATCH), the largest measured batch at which it is the
// faster.
//
// Entries: ccfd_fused_mlp_q8 (B2), ccfd_fused_mlp_q8_preq (B3, on the
// launch its argument names: 0 the persistent grid, 1 the cluster) and
// ccfd_fused_mlp_q8_plan (the layout both use, which ops/fused_mlp_q8.py
// mirrors), plain C functions bound with ctypes. The launches return
// cudaGetLastError() (B3's cluster launch the error of cudaLaunchKernelEx);
// 1 (cudaErrorInvalidValue) for what they cannot run: a shape they do not
// take, no rows, or a cluster of more than kClusterMaxCtas CTAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kGroup = 64;        // output columns of one weight chunk row group
constexpr int kSlice = 256;       // layer-2 K-slice of one chunk
constexpr int kStageBytes = kGroup * (kSlice + 16);
constexpr int kMaxFeatures = 128;
constexpr int kMaxHidden = 1040;  // the reference's integer-exact layer-3 bound
constexpr int kMaxStages = 8;
constexpr int kConsumers = 512;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr size_t kSmemLimit = 232448;

struct Layout {
  int k1p, hp, ld1, ldh, ldf, groups, g1, c1, slices, chunks, rows, stages;
  // byte offsets into the dynamic shared memory, each a multiple of 128
  size_t ring, hf, hq, xq, xraw, sraw, sx, rcp, amax, bars, total;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__host__ __device__ inline Layout layout_for_rows(int features, int hidden, int rows) {
  Layout L;
  L.k1p = (features + 31) / 32 * 32;
  L.hp = (hidden + kGroup - 1) / kGroup * kGroup;
  L.ld1 = L.k1p + 16;
  L.ldh = L.hp + 16;
  L.ldf = (L.hp > L.k1p ? L.hp : L.k1p) + 8;
  L.groups = L.hp / kGroup;
  L.g1 = kStageBytes / (kGroup * L.ld1);  // layer-1 groups a stage holds
  if (L.g1 > L.groups) L.g1 = L.groups;
  L.c1 = (L.groups + L.g1 - 1) / L.g1;
  L.slices = (L.hp + kSlice - 1) / kSlice;
  L.chunks = L.c1 + L.groups * L.slices;
  L.rows = rows;
  size_t off = 0;
  const size_t hf = align128(sizeof(float) * rows * L.ldf);
  const size_t hq = align128(static_cast<size_t>(rows) * L.ldh);
  const size_t xq = align128(static_cast<size_t>(rows) * L.ld1);
  const size_t xraw = align128(sizeof(float) * rows * features);
  const size_t sraw = align128(sizeof(float) * rows);
  const size_t fixed = hf + hq + xq + xraw + 4 * sraw + 256;
  const int fit = fixed < kSmemLimit ? static_cast<int>((kSmemLimit - fixed) / kStageBytes) : 0;
  L.stages = L.chunks < kMaxStages ? L.chunks : kMaxStages;
  if (fit < L.stages) L.stages = fit;
  L.ring = off;  off += static_cast<size_t>(L.stages) * kStageBytes;
  L.hf = off;    off += hf;
  L.hq = off;    off += hq;
  L.xq = off;    off += xq;
  L.xraw = off;  off += xraw;   // B2: f32 rows; B3: int8 rows
  L.sraw = off;  off += sraw;   // B3: the rows' scales
  L.sx = off;    off += sraw;
  L.rcp = off;   off += sraw;
  L.amax = off;  off += sraw;
  L.bars = off;  off += 256;    // 2 * kMaxStages + 2 mbarriers
  L.total = off;
  return L;
}

// the most rows (64 or 32) whose tile and a two-stage ring fit; 32 rows
// take every width up to the bound
__host__ __device__ inline Layout make_layout(int features, int hidden) {
  Layout L = layout_for_rows(features, hidden, 64);
  if (L.stages < 2) L = layout_for_rows(features, hidden, 32);
  return L;
}

// four 8x8 matrices of 16-bit elements (8 rows x 16 bytes each) from shared
// memory; lane l gives the address of row l % 8 of matrix l / 8, and
// receives row l / 4, 4-byte word l % 4 of each matrix
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(row)));
}

// d += a (16x32, row-major) * b (32x8, col-major), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float row_scale(unsigned amax_bits) {
  return fmaxf(__fdiv_rn(__uint_as_float(amax_bits), 127.0f), 1e-8f);
}

// clamp(rint(h / s), -127, 127) with h / s the IEEE quotient, bit for bit,
// for |h| <= 127 s (every element of the row whose scale s is): t = h * rcp
// with rcp = 1/s rounded lies within 3 * 2^-24 * 127.01 < 2.3e-5 of the
// rounded quotient, so where no half-integer is within 1e-4 of t both round
// to the same integer; near one, the true division decides
// t = h * rcp, rcp = 1/s rounded, lies within 3 * 2^-24 * 127.01 < 2.3e-5 of
// the rounded quotient h / s wherever |h| <= 127 s (every element of the row
// whose scale s is). Unless t lies within 1e-4 of a half-integer, both round
// to the same integer; near one, the true division decides. So quantize()
// is clamp(rint(h / s), -127, 127) with the IEEE quotient, bit for bit.
__device__ __forceinline__ bool near_tie(float t, float q) {
  return fabsf(__fsub_rn(t, q)) >= 0.5f - 1e-4f;  // q = rint(t): t - q is exact
}

__device__ __forceinline__ int clamp_q(float q) {
  return static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f));
}

__device__ __noinline__ int quantize_exact(float h, float s) {
  return clamp_q(rintf(__fdiv_rn(h, s)));
}

__device__ __forceinline__ int quantize(float h, float s, float rcp) {
  const float t = __fmul_rn(h, rcp);
  const float q = rintf(t);
  if (__builtin_expect(near_tie(t, q), 0)) return quantize_exact(h, s);
  return clamp_q(q);
}

// four consecutive columns at once, packed into one int8x4 word
__device__ __forceinline__ unsigned quantize4(float4 h, float s, float rcp) {
  const float t[4] = {__fmul_rn(h.x, rcp), __fmul_rn(h.y, rcp), __fmul_rn(h.z, rcp),
                      __fmul_rn(h.w, rcp)};
  float q[4];
  bool tie = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = rintf(t[i]);
    tie |= near_tie(t[i], q[i]);
  }
  int v[4];
  if (__builtin_expect(tie, 0)) {
    v[0] = quantize_exact(h.x, s);
    v[1] = quantize_exact(h.y, s);
    v[2] = quantize_exact(h.z, s);
    v[3] = quantize_exact(h.w, s);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = clamp_q(q[i]);
  }
  // the low byte of each, in column order
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040),
                     0x5410);
}

// rows [0, rows) of the f32 tile (stride ldf) into int8 (stride ld), n
// columns (a multiple of 64): each warp takes two rows at a time (r and
// r + 16), four columns a lane per step, so independent work is in flight
__device__ __forceinline__ void requantize(const float* hf, int ldf, int8_t* dst, int ld,
                                           int n, int rows, const float* sx,
                                           const float* rcp, int warp, int lane) {
  for (int r = warp; r < rows; r += 2 * kConsumerWarps) {
    const int r2 = r + kConsumerWarps < rows ? r + kConsumerWarps : r;
    const float s = sx[r], rc = rcp[r], s2 = sx[r2], rc2 = rcp[r2];
    const float4* a = reinterpret_cast<const float4*>(hf + r * ldf);
    const float4* b = reinterpret_cast<const float4*>(hf + r2 * ldf);
    unsigned* oa = reinterpret_cast<unsigned*>(dst + r * ld);
    unsigned* ob = reinterpret_cast<unsigned*>(dst + r2 * ld);
#pragma unroll 2
    for (int v = lane; v < n / 4; v += 32) {
      const float4 ha = a[v], hb = b[v];
      oa[v] = quantize4(ha, s, rc);
      ob[v] = quantize4(hb, s2, rc2);  // r2 == r on a lone last row: the same word twice
    }
  }
}

// acc[j] += A (this warp's 16-row slab from row r0 - g, K bytes) x Bt (nj
// column blocks of 8 from its row 0), int8 with row strides lda, ldb (each
// a multiple of 16), K a multiple of 32. The fragments come in with
// ldmatrix: A's four 8x8 byte-pair matrices are its rows 0-7 / 8-15 at
// k0 / k0 + 16, the m16n8k32 A fragment's registers in order; a pair of
// column blocks j, j + 1 is B's four (rows of j at k0, k0 + 16, then j + 1)
__device__ __forceinline__ void mma_slab(int (&acc)[4][4], const int8_t* A, int lda,
                                         const int8_t* Bt, int ldb, int K, int nj, int r0,
                                         int g, int t) {
  const int lane = 4 * g + t, m = lane / 8, i = lane % 8;
  const int8_t* arow = A + (r0 - g + i + 8 * (m & 1)) * lda + 16 * (m >> 1);
  const int8_t* brow[2];
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    const int j = min(2 * jp + (m >> 1), nj - 1);  // a lone block loads twice
    brow[jp] = Bt + (8 * j + i) * ldb + 16 * (m & 1);
  }
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 32) {
    unsigned a[4];
    ldmatrix_x4(a, arow + k0);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      if (2 * jp < nj) {
        unsigned b[4];
        ldmatrix_x4(b, brow[jp] + k0);
        const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_s8(acc[2 * jp], a, b0);
        if (2 * jp + 1 < nj) mma_s8(acc[2 * jp + 1], a, b1);
      }
    }
  }
}

// the scale and bias of this thread's columns of a group (col0 + 8j, +1),
// loaded before the group's products so their latency hides behind them
struct Epilogue {
  float2 scale[4], bias[4];
};

__device__ __forceinline__ Epilogue load_epilogue(const float* __restrict__ scale,
                                                  const float* __restrict__ bias, int col0,
                                                  int nj) {
  Epilogue e;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < nj) {
      e.scale[j] = __ldg(reinterpret_cast<const float2*>(scale + col0 + j * 8));
      e.bias[j] = __ldg(reinterpret_cast<const float2*>(bias + col0 + j * 8));
    }
  }
  return e;
}

// one group's epilogue: h = relu(((float)acc * sx) * scale + bias) into the
// f32 tile, and the running row maxima m0, m1
__device__ __forceinline__ void dequant(const int (&acc)[4][4], int nj, int col0,
                                        const Epilogue& e, float* hf, int ldf, int r0,
                                        float sx0, float sx1, float& m0, float& m1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= nj) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? r0 : r0 + 8;
      const int col = col0 + j * 8 + (i & 1);
      float h = __fmul_rn(static_cast<float>(acc[j][i]), i < 2 ? sx0 : sx1);
      h = __fadd_rn(__fmul_rn(h, (i & 1) ? e.scale[j].y : e.scale[j].x),
                    (i & 1) ? e.bias[j].y : e.bias[j].x);
      h = h > 0.0f ? h : 0.0f;  // relu to +0, never -0: the row max is taken on the bits
      hf[row * ldf + col] = h;
      if (i < 2) m0 = fmaxf(m0, h); else m1 = fmaxf(m1, h);
    }
  }
}

// the row maxima of this warp's columns into amax: the 4 lanes of a group share rows
__device__ __forceinline__ void publish_max(float m0, float m1, unsigned* amax, int r0,
                                            int t) {
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  if (t == 0) {
    atomicMax(&amax[r0], __float_as_uint(m0));
    atomicMax(&amax[r0 + 8], __float_as_uint(m1));
  }
}

// each row's scale and its reciprocal from its max, and the max reset for
// the next reduction
__device__ __forceinline__ void take_row_scales(float* sx, float* rcp, unsigned* amax,
                                                int rows) {
  if (static_cast<int>(threadIdx.x) < rows) {
    sx[threadIdx.x] = row_scale(amax[threadIdx.x]);
    rcp[threadIdx.x] = __frcp_rn(sx[threadIdx.x]);
    amax[threadIdx.x] = 0u;
  }
}

// bytes of weight chunk c in the stream (the order the consumers read them)
__device__ __forceinline__ uint32_t chunk_bytes(const Layout& L, int c) {
  if (c < L.c1) {
    const int n = min(L.g1, L.groups - c * L.g1);
    return static_cast<uint32_t>(n * kGroup * L.ld1);
  }
  const int s = (c - L.c1) % L.slices;
  return static_cast<uint32_t>(kGroup * (min(kSlice, L.hp - s * kSlice) + 16));
}

template <bool kPreq>
__device__ __forceinline__ void q8_body(
    const float* __restrict__ x, const float* __restrict__ mu,
    const float* __restrict__ sigma, const int8_t* __restrict__ q_in,
    const float* __restrict__ s_in, const unsigned char* __restrict__ wstream,
    const float* __restrict__ vec,  // (4, hp): s1, b1, s2, b2
    const int8_t* __restrict__ w3, const float* __restrict__ s3,
    const float* __restrict__ b3, float* __restrict__ proba, float* __restrict__ logits,
    int batch, int features, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(features, hidden);
  const int R = L.rows;
  unsigned char* ring = smem + L.ring;
  float* hf = reinterpret_cast<float*>(smem + L.hf);
  int8_t* hq = reinterpret_cast<int8_t*>(smem + L.hq);
  int8_t* xq = reinterpret_cast<int8_t*>(smem + L.xq);
  float* sx = reinterpret_cast<float*>(smem + L.sx);
  float* rcp = reinterpret_cast<float*>(smem + L.rcp);
  unsigned* amax = reinterpret_cast<unsigned*>(smem + L.amax);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xfull = empty + kMaxStages;
  uint64_t* xempty = xfull + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (batch + R - 1) / R;
  const bool resident = L.stages == L.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init(xfull, 1);
    hopper::mbar_init(xempty, kConsumerWarps);
    hopper::mbar_init_fence();
  }
  if (static_cast<int>(threadIdx.x) < R) amax[threadIdx.x] = 0u;
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: the row tile, then the weight chunks, tile after tile ----
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0, xphase = 0;
    for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
      const int row0 = tile * R;
      const uint32_t rows = static_cast<uint32_t>(min(R, batch - row0));
      hopper::mbar_wait(xempty, xphase ^ 1);
      if constexpr (kPreq) {
        const uint32_t qb = (rows * features) & ~15u, sb = (rows * 4) & ~15u;
        hopper::mbar_arrive_expect_tx(xfull, qb + sb);
        if (qb) hopper::bulk_g2s(smem + L.xraw, q_in + static_cast<size_t>(row0) * features, qb, xfull);
        if (sb) hopper::bulk_g2s(smem + L.sraw, s_in + row0, sb, xfull);
      } else {
        const uint32_t xb = (rows * features * 4) & ~15u;
        hopper::mbar_arrive_expect_tx(xfull, xb);
        if (xb) hopper::bulk_g2s(smem + L.xraw, x + static_cast<size_t>(row0) * features, xb, xfull);
      }
      xphase ^= 1;
      const unsigned char* src = wstream;
      for (int c = 0; c < L.chunks; ++c) {
        const uint32_t bytes = chunk_bytes(L, c);
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        if (resident && it > 0) {
          hopper::mbar_arrive(&full[stage]);  // the chunk is still there
        } else {
          hopper::mbar_arrive_expect_tx(&full[stage], bytes);
          hopper::bulk_g2s(ring + static_cast<size_t>(stage) * kStageBytes, src, bytes,
                           &full[stage]);
        }
        src += bytes;
        if (++stage == L.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: sixteen warps ----
  const int tid = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  const int nslab = R / 16;                 // 16-row slabs in the tile
  const int share = kGroup / (kConsumerWarps / nslab);  // a warp's columns of a group
  const int nj = share / 8;
  const int r0 = (warp % nslab) * 16 + g;
  const int cw = (warp / nslab) * share;    // the warp's first column in a group
  const float* s1 = vec;
  const float* b1 = vec + L.hp;
  const float* s2 = vec + 2 * L.hp;
  const float* b2 = vec + 3 * L.hp;
  int stage = 0;
  uint32_t phase = 0, xphase = 0;

  auto next_stage = [&]() {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == L.stages) {
      stage = 0;
      phase ^= 1;
    }
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * R;
    const int rows = min(R, batch - row0);

    // ---- layer 1's int8 input tile (rows past the batch are skipped here
    // and below: nothing of theirs is stored) ----
    hopper::mbar_wait(xfull, xphase);
    xphase ^= 1;
    if constexpr (kPreq) {
      const int8_t* qs = reinterpret_cast<const int8_t*>(smem + L.xraw);
      const float* ss = reinterpret_cast<const float*>(smem + L.sraw);
      const int qn = (rows * features) & ~15, sn = ((rows * 4) & ~15) / 4;
      for (int r = warp; r < rows; r += kConsumerWarps) {
        for (int k = lane; k < L.k1p; k += 32) {
          const int idx = r * features + k;
          xq[r * L.ld1 + k] =
              k < features
                  ? (idx < qn ? qs[idx] : q_in[static_cast<size_t>(row0) * features + idx])
                  : static_cast<int8_t>(0);
        }
      }
      if (tid < rows) sx[tid] = tid < sn ? ss[tid] : s_in[row0 + tid];
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(xempty);
    } else {
      // normalize, take the row's max over |h| in the warp, quantize
      const float* xs = reinterpret_cast<const float*>(smem + L.xraw);
      const int xn = ((rows * features * 4) & ~15) / 4;
      float mu_k[kMaxFeatures / 32], sigma_k[kMaxFeatures / 32];  // this lane's features
#pragma unroll
      for (int j = 0; j < kMaxFeatures / 32; ++j) {
        const int k = lane + 32 * j;
        mu_k[j] = k < features ? __ldg(mu + k) : 0.0f;
        sigma_k[j] = k < features ? __ldg(sigma + k) : 1.0f;
      }
      for (int r = warp; r < rows; r += kConsumerWarps) {
        float m = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxFeatures / 32; ++j) {
          const int k = lane + 32 * j, idx = r * features + k;
          if (k >= L.k1p) continue;
          float v = 0.0f;
          if (k < features) {
            const float xv = idx < xn ? xs[idx] : x[static_cast<size_t>(row0) * features + idx];
            v = __fdiv_rn(__fsub_rn(xv, mu_k[j]), sigma_k[j]);
          }
          hf[r * L.ldf + k] = v;
          m = fmaxf(m, fabsf(v));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const float s = row_scale(__float_as_uint(m));
        const float rc = __frcp_rn(s);
        if (lane == 0) sx[r] = s;
        __syncwarp();
        for (int k = lane; k < L.k1p; k += 32)
          xq[r * L.ld1 + k] = static_cast<int8_t>(quantize(hf[r * L.ldf + k], s, rc));
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(xempty);
    }
    hopper::named_sync(kConsumers);

    // ---- layer 1: chunks of up to g1 groups of 64 columns x all of K ----
    const bool live = r0 - g < rows;  // this warp's slab holds rows of the batch
    float m0 = 0.0f, m1 = 0.0f;
    float sx0 = sx[r0], sx1 = sx[r0 + 8];
    for (int c = 0; c < L.c1; ++c) {
      hopper::mbar_wait(&full[stage], phase);
      const int8_t* chunk = reinterpret_cast<const int8_t*>(ring + static_cast<size_t>(stage) * kStageBytes);
      const int ng = min(L.g1, L.groups - c * L.g1);
      for (int gi = 0; gi < ng && live; ++gi) {
        const int col0 = (c * L.g1 + gi) * kGroup + cw + 2 * t;
        const Epilogue e = load_epilogue(s1, b1, col0, nj);
        int acc[4][4] = {};
        mma_slab(acc, xq, L.ld1, chunk + (gi * kGroup + cw) * L.ld1, L.ld1, L.k1p, nj, r0, g, t);
        dequant(acc, nj, col0, e, hf, L.ldf, r0, sx0, sx1, m0, m1);
      }
      next_stage();
    }
    publish_max(m0, m1, amax, r0, t);
    hopper::named_sync(kConsumers);
    take_row_scales(sx, rcp, amax, R);
    hopper::named_sync(kConsumers);
    requantize(hf, L.ldf, hq, L.ldh, L.hp, rows, sx, rcp, warp, lane);
    hopper::named_sync(kConsumers);

    // ---- layer 2: per group of 64 columns, the K-slices in order ----
    m0 = 0.0f;
    m1 = 0.0f;
    sx0 = sx[r0];
    sx1 = sx[r0 + 8];
    for (int grp = 0; grp < L.groups; ++grp) {
      const int col0 = grp * kGroup + cw + 2 * t;
      const Epilogue e = load_epilogue(s2, b2, col0, live ? nj : 0);
      int acc[4][4] = {};
      for (int s = 0; s < L.slices; ++s) {
        hopper::mbar_wait(&full[stage], phase);
        const int8_t* chunk = reinterpret_cast<const int8_t*>(ring + static_cast<size_t>(stage) * kStageBytes);
        const int ks = min(kSlice, L.hp - s * kSlice);
        if (live)
          mma_slab(acc, hq + s * kSlice, L.ldh, chunk + cw * (ks + 16), ks + 16, ks, nj, r0, g, t);
        next_stage();
      }
      if (live) dequant(acc, nj, col0, e, hf, L.ldf, r0, sx0, sx1, m0, m1);
    }
    publish_max(m0, m1, amax, r0, t);
    hopper::named_sync(kConsumers);
    take_row_scales(sx, rcp, amax, R);
    hopper::named_sync(kConsumers);

    // ---- layer 3: quantize each row and dot it with w3, two rows per warp
    // at a time (r and r + 16) ----
    const int* w3v = reinterpret_cast<const int*>(w3);
    for (int r = warp; r < rows; r += 2 * kConsumerWarps) {
      const int rr[2] = {r, r + kConsumerWarps};
      const bool two = rr[1] < rows;
      int acc[2] = {0, 0};
#pragma unroll 2
      for (int v = lane; v < L.hp / 4; v += 32) {
        const int w = __ldg(w3v + v);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = two ? rr[i] : r;
          const float4 h = reinterpret_cast<const float4*>(hf + row * L.ldf)[v];
          acc[i] = __dp4a(static_cast<int>(quantize4(h, sx[row], rcp[row])), w, acc[i]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
        acc[1] += __shfl_xor_sync(0xffffffffu, acc[1], off);
      }
      if (lane < (two ? 2 : 1)) {  // lane 0 writes row r, lane 1 row r + 16
        const int row = lane == 0 ? rr[0] : rr[1];
        const int dot = lane == 0 ? acc[0] : acc[1];
        const float z = __fadd_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(dot), sx[row]), s3[0]), b3[0]);
        proba[row0 + row] = 1.0f / (1.0f + expf(-z));
        if (logits != nullptr) logits[row0 + row] = z;
      }
    }
    hopper::named_sync(kConsumers);  // the tile's f32 activations are free again
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_q8_kernel(const float* __restrict__ x, const float* __restrict__ mu,
                    const float* __restrict__ sigma, const unsigned char* __restrict__ wstream,
                    const float* __restrict__ vec, const int8_t* __restrict__ w3,
                    const float* __restrict__ s3, const float* __restrict__ b3,
                    float* __restrict__ proba, float* __restrict__ logits, int batch,
                    int features, int hidden) {
  q8_body<false>(x, mu, sigma, nullptr, nullptr, wstream, vec, w3, s3, b3, proba, logits,
                 batch, features, hidden);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_q8_preq_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                         const unsigned char* __restrict__ wstream,
                         const float* __restrict__ vec, const int8_t* __restrict__ w3,
                         const float* __restrict__ s3, const float* __restrict__ b3,
                         float* __restrict__ proba, float* __restrict__ logits, int batch,
                         int features, int hidden) {
  q8_body<true>(nullptr, nullptr, nullptr, q, s, wstream, vec, w3, s3, b3, proba, logits,
                batch, features, hidden);
}

// ---- B3 on a thread-block cluster: the small batches ----

constexpr int kClusterRows = 64;     // rows of a cluster's tile
constexpr int kClusterMaxCtas = 8;   // the portable cluster size: H <= 512
constexpr int kClusterWarps = 8;
constexpr int kClusterThreads = 32 * kClusterWarps;
constexpr int kLdc = kGroup + 8;     // row stride of a CTA's f32 tile (its 64 columns)

struct ClusterLayout {
  int k1p, hp, ld1, ldh, ldf, ctas, slices;
  uint32_t w1_bytes, w2_bytes;  // all of W1's chunk; a CTA's group of W2's
  // byte offsets into the dynamic shared memory, each a multiple of 128
  size_t w1, w2, vec1, vec2, hf, hq, xraw, sx, rcp, amax, slots, bars, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int features, int hidden) {
  ClusterLayout C;
  C.k1p = (features + 31) / 32 * 32;
  C.hp = (hidden + kGroup - 1) / kGroup * kGroup;
  C.ld1 = C.k1p + 16;
  C.ldh = C.hp + 16;
  C.ldf = C.hp + 8;
  C.ctas = C.hp / kGroup;
  C.slices = (C.hp + kSlice - 1) / kSlice;
  C.w1_bytes = static_cast<uint32_t>(C.hp * C.ld1);
  C.w2_bytes = static_cast<uint32_t>(kGroup * (C.hp + 16 * C.slices));
  const size_t R = kClusterRows, col = align128(sizeof(float) * R);
  size_t off = 0;
  C.w1 = off;    off += align128(C.w1_bytes);
  C.w2 = off;    off += align128(C.w2_bytes);
  C.vec1 = off;  off += align128(sizeof(float) * 2 * C.hp);  // s1, b1
  C.vec2 = off;  off += align128(sizeof(float) * 2 * kGroup + kGroup);  // s2, b2, w3: its columns
  // the f32 tile: all hp columns of one slab's rows, or 64 columns of R
  C.hf = off;    off += align128(sizeof(float) * max(16 * C.ldf, static_cast<int>(R) * kLdc));
  C.hq = off;    off += align128(R * C.ldh);
  C.xraw = off;  off += align128(R * features + 36);  // and what load4 reads past the rows
  C.sx = off;    off += col;
  C.rcp = off;   off += col;
  C.amax = off;  off += col;
  C.slots = off; off += align128(3 * sizeof(unsigned) * kClusterMaxCtas * R);
  C.bars = off;  off += 128;
  C.total = off;
  return C;
}

// four int8 values from shared memory at any byte offset (two aligned
// words and a funnel shift), the bytes from the ``avail``-th on zero;
// without a branch, so the words are read even where none is kept (inside
// the tile's allocation)
__device__ __forceinline__ unsigned load4(const int8_t* p, int avail) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const unsigned* w = reinterpret_cast<const unsigned*>(a & ~uintptr_t{3});
  const unsigned v = __funnelshift_r(w[0], w[1], static_cast<unsigned>(a & 3) * 8);
  return v & static_cast<unsigned>((1ull << (8 * min(max(avail, 0), 4))) - 1ull);
}

// mma_slab with A the row tile as its copy left it: int8 rows of
// ``features`` bytes, neither padded nor aligned. Each A register is the
// four bytes of row r0 (+8) at column k0 + 4t (+16), read directly, so no
// pass lays the tile out first; columns past the features and rows past
// ``rows`` read as 0 (their bytes are read and dropped: the tile's region
// has room past its last row for the reads of a 64-row tile)
__device__ __forceinline__ void mma_rows(int (&acc)[4][4], const int8_t* X, int features,
                                         int rows, const int8_t* Bt, int ldb, int K, int nj,
                                         int r0, int g, int t) {
  const int lane = 4 * g + t, m = lane / 8, i = lane % 8;
  const int8_t* brow[2];
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    const int j = min(2 * jp + (m >> 1), nj - 1);  // a lone block loads twice
    brow[jp] = Bt + (8 * j + i) * ldb + 16 * (m & 1);
  }
  for (int k0 = 0; k0 < K; k0 += 32) {
    unsigned a[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int row = r0 + 8 * (h & 1), k = k0 + 16 * (h >> 1) + 4 * t;
      a[h] = load4(X + row * features + k, row < rows ? features - k : 0);
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      if (2 * jp < nj) {
        unsigned b[4];
        ldmatrix_x4(b, brow[jp] + k0);
        const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_s8(acc[2 * jp], a, b0);
        if (2 * jp + 1 < nj) mma_s8(acc[2 * jp + 1], a, b1);
      }
    }
  }
}

// Without the conversion unit, which issues 16 a cycle on an SM where the
// FP32 pipes issue 128 and which the requantizations of a small tile wait
// on: an int32 below 2^22 in magnitude to float, and rint(t) for |t| below
// 2^22, through the bits of 1.5 * 2^23 + x. Both are exact, so the results
// are (float)acc's and quantize4's bit for bit.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float small_int_to_float(int v) {
  return __fsub_rn(__int_as_float(v + kMagicBits), kMagic);
}

// quantize4 for 0 <= h <= 127 s (every element of the row whose scale s
// is, after relu): t = h / s then lies in [0, 127 + 3e-5], so rint(t) needs
// no clamp, and the low byte of 1.5 * 2^23 + rint(t)'s bits is its int8.
// In two halves: the multiply and round, which raises ``tie`` where a t
// lies within 1e-4 of a half-integer, and the true divisions for that case
__device__ __forceinline__ unsigned pack4_small(float4 h, float rcp, bool& tie) {
  const float t[4] = {__fmul_rn(h.x, rcp), __fmul_rn(h.y, rcp), __fmul_rn(h.z, rcp),
                      __fmul_rn(h.w, rcp)};
  int v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float m = __fadd_rn(t[i], kMagic);
    tie |= near_tie(t[i], __fsub_rn(m, kMagic));
    v[i] = __float_as_int(m);
  }
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040),
                     0x5410);
}

__device__ __noinline__ unsigned pack4_exact(float4 h, float s) {
  return __byte_perm(__byte_perm(quantize_exact(h.x, s), quantize_exact(h.y, s), 0x0040),
                     __byte_perm(quantize_exact(h.z, s), quantize_exact(h.w, s), 0x0040),
                     0x5410);
}

__device__ __forceinline__ unsigned quantize4_small(float4 h, float s, float rcp) {
  bool tie = false;
  const unsigned q = pack4_small(h, rcp, tie);
  return __builtin_expect(tie, 0) ? pack4_exact(h, s) : q;
}

// dequant for layer 1, whose sums (K <= 128) lie below 2^22 in magnitude
__device__ __forceinline__ void dequant_small(const int (&acc)[4][4], int nj, int col0,
                                              const Epilogue& e, float* hf, int ldf, int r0,
                                              float sx0, float sx1, float& m0, float& m1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= nj) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i < 2 ? r0 : r0 + 8;
      const int col = col0 + j * 8 + (i & 1);
      float h = __fmul_rn(small_int_to_float(acc[j][i]), i < 2 ? sx0 : sx1);
      h = __fadd_rn(__fmul_rn(h, (i & 1) ? e.scale[j].y : e.scale[j].x),
                    (i & 1) ? e.bias[j].y : e.bias[j].x);
      h = h > 0.0f ? h : 0.0f;
      hf[row * ldf + col] = h;
      if (i < 2) m0 = fmaxf(m0, h); else m1 = fmaxf(m1, h);
    }
  }
}

// mma_slab with the even and the odd k-steps summed apart: two chains of
// dependent products in flight in place of one (the int32 sums are exact)
__device__ __forceinline__ void mma_slab2(int (&acc)[4][4], const int8_t* A, int lda,
                                          const int8_t* Bt, int ldb, int K, int nj, int r0,
                                          int g, int t) {
  const int lane = 4 * g + t, m = lane / 8, i = lane % 8;
  const int8_t* arow = A + (r0 - g + i + 8 * (m & 1)) * lda + 16 * (m >> 1);
  const int8_t* brow[2];
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    const int j = min(2 * jp + (m >> 1), nj - 1);  // a lone block loads twice
    brow[jp] = Bt + (8 * j + i) * ldb + 16 * (m & 1);
  }
  int odd[4][4] = {};
  auto step = [&](int (&d)[4][4], int k) {
    unsigned a[4];
    ldmatrix_x4(a, arow + k);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      if (2 * jp < nj) {
        unsigned b[4];
        ldmatrix_x4(b, brow[jp] + k);
        const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_s8(d[2 * jp], a, b0);
        if (2 * jp + 1 < nj) mma_s8(d[2 * jp + 1], a, b1);
      }
    }
  };
  if (K == kSlice) {  // a whole slice: every fragment load can be issued ahead
#pragma unroll
    for (int k0 = 0; k0 < kSlice; k0 += 64) {
      step(acc, k0);
      step(odd, k0 + 32);
    }
  } else {  // K is a multiple of 32 below a slice
    int k0 = 0;
    for (; k0 + 32 < K; k0 += 64) {
      step(acc, k0);
      step(odd, k0 + 32);
    }
    if (k0 < K) step(acc, k0);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += odd[j][e];
}

// acc += q(h1)[:, k_begin : k_begin + len] x this CTA's W2 group's rows
// [c0, c0 + 8 nj) over the same K, across the group's 256-deep slices (a
// row of a slice is its K, contiguous); k_begin and len multiples of 32
__device__ __forceinline__ void mma_w2(int (&acc)[4][4], const int8_t* hq, int ldh,
                                       const int8_t* w2s, int hp, int c0, int k_begin, int len,
                                       int nj, int r0, int g, int t) {
  for (int k = k_begin; k < k_begin + len;) {
    const int sl = k / kSlice, ks = min(kSlice, hp - sl * kSlice);
    const int n = min(k_begin + len, sl * kSlice + ks) - k;
    mma_slab2(acc, hq + k, ldh, w2s + sl * kGroup * (kSlice + 16) + c0 * (ks + 16) +
              (k - sl * kSlice), ks + 16, n, nj, r0, g, t);
    k += n;
  }
}

// load_epilogue from shared memory
__device__ __forceinline__ Epilogue load_epilogue_smem(const float* scale, const float* bias,
                                                       int col0, int nj) {
  Epilogue e;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < nj) {
      e.scale[j] = *reinterpret_cast<const float2*>(scale + col0 + j * 8);
      e.bias[j] = *reinterpret_cast<const float2*>(bias + col0 + j * 8);
    }
  }
  return e;
}

// The mbarriers of a cluster CTA: the row tile with W1, s1 and b1; its
// group of W2 with its columns of s2, b2 and w3; and what the other CTAs
// send it
enum ClusterBar { kBarIn, kBarW2, kBarMax1, kBarH1, kBarMax2, kBarPart, kClusterBars };

// each row's max over all H columns: this CTA's maxima (amax, reset here)
// go to slot ``rank`` of ``slots`` in every CTA of the cluster, each CTA
// waiting for the ctas x rows values it receives; then each row's scale
// and reciprocal from the maximum of its slots (order-free: every CTA takes
// the bits one block's atomicMax gives)
__device__ __forceinline__ void exchange_row_scales(unsigned* amax, unsigned* slots,
                                                    uint64_t* bar, float* sx, float* rcp,
                                                    int rows, int rank, int ctas) {
  const int tid = threadIdx.x;
  __syncthreads();  // every warp's maxima are in amax
  if (tid < rows) {
    const unsigned m = amax[tid];
    amax[tid] = 0u;
    for (int p = 0; p < ctas; ++p)
      hopper::st_async(hopper::peer_addr(slots + rank * kClusterRows + tid, p), m,
                       hopper::peer_addr(bar, p));
  }
  hopper::mbar_wait_cluster(bar, 0);
  if (tid < rows) {
    unsigned m = 0u;
    for (int p = 0; p < ctas; ++p) m = max(m, slots[p * kClusterRows + tid]);
    sx[tid] = row_scale(m);
    rcp[tid] = __frcp_rn(sx[tid]);
  }
  __syncthreads();
}

// One cluster scores one tile of up to 64 rows; CTA r of its hp / 64 owns
// columns [64 r, 64 r + 64) of layer 2. A tile of one 16-row slab computes
// all of layer 1 (K = F is small) in every CTA; a larger tile splits it
// like layer 2, and the rows' maxima and q(h1) cross between the CTAs.
// Layer 2's row maxima go to every CTA and layer 3's integer partial sums
// to rank 0, through distributed shared memory.
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_mlp_q8_preq_kernel_cluster(const int8_t* __restrict__ q, const float* __restrict__ s,
                                 const unsigned char* __restrict__ wstream,
                                 const float* __restrict__ vec, const int8_t* __restrict__ w3,
                                 const float* __restrict__ s3, const float* __restrict__ b3,
                                 float* __restrict__ proba, float* __restrict__ logits,
                                 int batch, int features, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ClusterLayout C = cluster_layout(features, hidden);
  constexpr int R = kClusterRows;
  const int rank = hopper::cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x) / C.ctas * R;
  const int rows = min(R, batch - row0);
  const int8_t* w1s = reinterpret_cast<const int8_t*>(smem + C.w1);
  const int8_t* w2s = reinterpret_cast<const int8_t*>(smem + C.w2);
  const float* s1v = reinterpret_cast<const float*>(smem + C.vec1);
  const float* b1v = s1v + C.hp;
  const float* s2v = reinterpret_cast<const float*>(smem + C.vec2);
  const float* b2v = s2v + kGroup;
  const int* w3v = reinterpret_cast<const int*>(b2v + kGroup);
  float* hf = reinterpret_cast<float*>(smem + C.hf);
  int8_t* hq = reinterpret_cast<int8_t*>(smem + C.hq);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + C.xraw);
  float* sx = reinterpret_cast<float*>(smem + C.sx);
  float* rcp = reinterpret_cast<float*>(smem + C.rcp);
  unsigned* amax = reinterpret_cast<unsigned*>(smem + C.amax);
  unsigned* slots1 = reinterpret_cast<unsigned*>(smem + C.slots);  // layer 1's maxima
  unsigned* slots2 = slots1 + kClusterMaxCtas * R;                    // layer 2's
  unsigned* part = slots2 + kClusterMaxCtas * R;                      // layer 3's sums
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C.bars);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t qb = (static_cast<uint32_t>(rows) * features) & ~15u;
  const uint32_t from_all = static_cast<uint32_t>(C.ctas * rows * 4);  // a 4-byte value a row
  // one 16-row slab takes all of layer 1 in every CTA; more split it too
  const bool split = rows > 16;

  // ---- the copies: thread 0 the row tile and layer 1's operands, warp 1
  // this CTA's group of layer 2's; warp 7 arms the barriers of what the
  // other CTAs will send, and their cluster-wide fence is off the copies'
  // path ----
  if (tid == 0) {
    hopper::mbar_init(&bar[kBarIn], 1);
    hopper::fence_proxy_async();  // the barrier, to this CTA's copies
    hopper::mbar_arrive_expect_tx(&bar[kBarIn], qb + C.w1_bytes + 8 * C.hp);
    if (qb)
      hopper::bulk_g2s(xs, q + static_cast<size_t>(row0) * features, qb, &bar[kBarIn]);
    hopper::bulk_g2s(smem + C.w1, wstream, C.w1_bytes, &bar[kBarIn]);
    hopper::bulk_g2s(smem + C.vec1, vec, 8 * C.hp, &bar[kBarIn]);
  } else if (tid == 32) {
    hopper::mbar_init(&bar[kBarW2], 1);
    hopper::fence_proxy_async();
  } else if (tid == kClusterThreads - 32) {
    for (int i = kBarMax1; i < kClusterBars; ++i) hopper::mbar_init(&bar[i], 1);
    if (split) {
      hopper::mbar_arrive_expect_tx(&bar[kBarMax1], from_all);
      hopper::mbar_arrive_expect_tx(&bar[kBarH1], static_cast<uint32_t>(rows * C.hp));
    }
    hopper::mbar_arrive_expect_tx(&bar[kBarMax2], from_all);
    hopper::mbar_arrive_expect_tx(&bar[kBarPart], rank == 0 ? from_all : 0u);
  }
  if (tid < R) amax[tid] = 0u;
  // the ragged tail past the row copy (under 16 bytes) comes directly
  if (tid < rows * features - static_cast<int>(qb))
    xs[qb + tid] = q[static_cast<size_t>(row0) * features + qb + tid];
  __syncthreads();
  if (tid == 32) {
    const size_t c = static_cast<size_t>(rank) * kGroup;
    hopper::mbar_arrive_expect_tx(&bar[kBarW2], C.w2_bytes + 9 * kGroup);
    hopper::bulk_g2s(smem + C.w2, wstream + static_cast<size_t>(C.w1_bytes) + rank * C.w2_bytes,
                     C.w2_bytes, &bar[kBarW2]);
    hopper::bulk_g2s(smem + C.vec2, vec + 2 * C.hp + c, 4 * kGroup, &bar[kBarW2]);
    hopper::bulk_g2s(smem + C.vec2 + 4 * kGroup, vec + 3 * C.hp + c, 4 * kGroup, &bar[kBarW2]);
    hopper::bulk_g2s(smem + C.vec2 + 8 * kGroup, w3 + c, kGroup, &bar[kBarW2]);
  }
  if (tid == kClusterThreads - 32) hopper::mbar_init_fence();  // to the other CTAs
  hopper::cluster_arrive_relaxed();

  // every warp takes a share of the live 16-row slabs: one slab over 8
  // warps, two over 4 each, four over 2 each
  const int need = (rows + 15) / 16;
  const int nslab = need == 3 ? 4 : need;
  const int wps = kClusterWarps / nslab;  // warps a slab
  const int g = lane >> 2, t = lane & 3;
  const int slab = warp % nslab;
  const int r0 = slab * 16 + g;
  const bool live = slab * 16 < rows;
  // the scales of this thread's two rows, s3 and b3 while the copies fly
  const float sx0 = r0 < rows ? __ldg(s + row0 + r0) : 0.0f;
  const float sx1 = r0 + 8 < rows ? __ldg(s + row0 + r0 + 8) : 0.0f;
  const float s3v = __ldg(s3), b3v = __ldg(b3);

  // ---- layer 1 ----
  const int share = kGroup / wps, nj = share / 8;  // a slab's warps split 64 columns
  const int cw = (warp / nslab) * share;  // the warp's first column in the CTA's group
  hopper::mbar_wait(&bar[kBarIn], 0);
  float m0 = 0.0f, m1 = 0.0f;
  if (!split) {
    // one slab: all hp columns in every CTA, 32 a warp at a time, so the
    // CTAs exchange nothing before layer 2
    for (int c = warp * 32; c < C.hp; c += 32 * kClusterWarps) {
      const Epilogue e1 = load_epilogue_smem(s1v, b1v, c + 2 * t, 4);
      int acc[4][4] = {};
      mma_rows(acc, xs, features, rows, w1s + c * C.ld1, C.ld1, C.k1p, 4, r0, g, t);
      dequant_small(acc, 4, c + 2 * t, e1, hf, C.ldf, r0, sx0, sx1, m0, m1);
    }
    publish_max(m0, m1, amax, r0, t);
    __syncthreads();
    if (tid < rows) {
      sx[tid] = row_scale(amax[tid]);
      rcp[tid] = __frcp_rn(sx[tid]);
      amax[tid] = 0u;
    }
    __syncthreads();
    // q(h1): a warp two rows at a time (r and r + 8), four columns a lane
    for (int r = warp; r < rows; r += 2 * kClusterWarps) {
      const int r2 = r + kClusterWarps < rows ? r + kClusterWarps : r;
      const float s_a = sx[r], rc_a = rcp[r], s_b = sx[r2], rc_b = rcp[r2];
      const float4* a = reinterpret_cast<const float4*>(hf + r * C.ldf);
      const float4* b = reinterpret_cast<const float4*>(hf + r2 * C.ldf);
      unsigned* oa = reinterpret_cast<unsigned*>(hq + r * C.ldh);
      unsigned* ob = reinterpret_cast<unsigned*>(hq + r2 * C.ldh);
#pragma unroll 2
      for (int v = lane; v < C.hp / 4; v += 32) {
        const float4 ha = a[v], hb = b[v];
        bool tie = false;  // one branch for both words
        unsigned qa = pack4_small(ha, rc_a, tie), qb_ = pack4_small(hb, rc_b, tie);
        if (__builtin_expect(tie, 0)) {
          qa = pack4_exact(ha, s_a);
          qb_ = pack4_exact(hb, s_b);
        }
        oa[v] = qa;
        ob[v] = qb_;  // r2 == r on a lone last row: the same word twice
      }
    }
  } else {
    // more slabs: this CTA's 64 columns; the rows' maxima and q(h1) cross
    // between the CTAs
    if (live) {
      const int c = rank * kGroup + cw;
      const Epilogue e1 = load_epilogue_smem(s1v, b1v, c + 2 * t, nj);
      int acc[4][4] = {};
      mma_rows(acc, xs, features, rows, w1s + c * C.ld1, C.ld1, C.k1p, nj, r0, g, t);
      dequant_small(acc, nj, cw + 2 * t, e1, hf, kLdc, r0, sx0, sx1, m0, m1);
      publish_max(m0, m1, amax, r0, t);
    }
    hopper::cluster_wait();  // every CTA's barriers are initialised
    exchange_row_scales(amax, slots1, &bar[kBarMax1], sx, rcp, rows, rank, C.ctas);
    // q(h1) of this CTA's columns into every CTA's hq: a row over 16
    // threads of four columns each; each four gather their 16 bytes in one
    // lane, which stores them to every CTA
    for (int base = 0; base < rows * 16; base += kClusterThreads) {
      const int r = (base + tid) / 16, wd = tid % 16;
      unsigned v = 0u;
      if (r < rows)
        v = quantize4_small(reinterpret_cast<const float4*>(hf + r * kLdc)[wd], sx[r], rcp[r]);
      const uint4 w = make_uint4(v, __shfl_down_sync(0xffffffffu, v, 1),
                                 __shfl_down_sync(0xffffffffu, v, 2),
                                 __shfl_down_sync(0xffffffffu, v, 3));
      if (r < rows && wd % 4 == 0) {
        const int8_t* dst = hq + r * C.ldh + rank * kGroup + wd * 4;
        for (int p = 0; p < C.ctas; ++p)
          hopper::st_async4(hopper::peer_addr(dst, p), w,
                            hopper::peer_addr(&bar[kBarH1], p));
      }
    }
    hopper::mbar_wait_cluster(&bar[kBarH1], 0);
  }
  __syncthreads();  // hq is whole; the f32 tile is free for layer 2

  // ---- layer 2: this CTA's 64 columns x the whole K ----
  m0 = 0.0f;
  m1 = 0.0f;
  if (!split) {
    // one slab: warps w and w + 4 take the same 16 columns over the two
    // halves of K (each warp reads a quarter of what 8 columns over all of
    // K would cost it), and w adds w + 4's sums
    hopper::mbar_wait(&bar[kBarW2], 0);
    const int c16 = (warp % 4) * 16, kh = C.hp / 2;
    int acc[4][4] = {};
    mma_w2(acc, hq, C.ldh, w2s, C.hp, c16, (warp / 4) * kh, kh, 2, r0, g, t);
    int* half = reinterpret_cast<int*>(hf + 16 * kLdc) + (warp % 4) * 256 + lane;
    if (warp >= 4) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) half[(4 * j + i) * 32] = acc[j][i];
    }
    __syncthreads();
    if (warp < 4) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += half[(4 * j + i) * 32];
      const Epilogue e2 = load_epilogue_smem(s2v, b2v, c16 + 2 * t, 2);  // its columns
      dequant(acc, 2, c16 + 2 * t, e2, hf, kLdc, r0, sx[r0], sx[r0 + 8], m0, m1);
      publish_max(m0, m1, amax, r0, t);
    }
  } else if (live) {
    hopper::mbar_wait(&bar[kBarW2], 0);
    const Epilogue e2 = load_epilogue_smem(s2v, b2v, cw + 2 * t, nj);  // its columns
    int acc[4][4] = {};
    mma_w2(acc, hq, C.ldh, w2s, C.hp, cw, 0, C.hp, nj, r0, g, t);
    dequant(acc, nj, cw + 2 * t, e2, hf, kLdc, r0, sx[r0], sx[r0 + 8], m0, m1);
    publish_max(m0, m1, amax, r0, t);
  }
  if (!split) hopper::cluster_wait();  // every CTA's barriers are initialised
  exchange_row_scales(amax, slots2, &bar[kBarMax2], sx, rcp, rows, rank, C.ctas);
  hopper::mbar_wait(&bar[kBarW2], 0);  // w3's columns, where no warp of this CTA was live

  // ---- layer 3: q(h2) of this CTA's columns . its slice of w3, two rows a
  // warp (a half-warp a row, four columns a lane); the exact int32 partial
  // sums go to rank 0 ----
  const int w3w = w3v[lane & 15];
  for (int base = 2 * warp; base < rows; base += 2 * kClusterWarps) {
    const int r = base + (lane >> 4);
    int acc = 0;
    if (r < rows) {
      const float4 h = reinterpret_cast<const float4*>(hf + r * kLdc)[lane & 15];
      acc = __dp4a(static_cast<int>(quantize4_small(h, sx[r], rcp[r])), w3w, 0);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if ((lane & 15) == 0 && r < rows)
      hopper::st_async(hopper::peer_addr(part + rank * R + r, 0), static_cast<unsigned>(acc),
                       hopper::peer_addr(&bar[kBarPart], 0));
  }
  if (rank == 0) {
    hopper::mbar_wait_cluster(&bar[kBarPart], 0);
    if (tid < rows) {
      int dot = 0;
      for (int p = 0; p < C.ctas; ++p) dot += static_cast<int>(part[p * R + tid]);
      const float z =
          __fadd_rn(__fmul_rn(__fmul_rn(static_cast<float>(dot), sx[tid]), s3v), b3v);
      // __frcp_rn is the correctly rounded 1 / x, so the bits of 1.0f / x
      proba[row0 + tid] = __frcp_rn(1.0f + expf(-z));
      if (logits != nullptr) logits[row0 + tid] = z;
    }
  }
}

std::once_flag g_once;
cudaError_t g_init_err = cudaSuccess;
int g_sms = 0;

// the shared-memory attribute of the kernels and the SM count, once per
// library load
cudaError_t init_once() {
  std::call_once(g_once, [] {
    const void* kernels[] = {reinterpret_cast<const void*>(fused_mlp_q8_kernel),
                             reinterpret_cast<const void*>(fused_mlp_q8_preq_kernel),
                             reinterpret_cast<const void*>(fused_mlp_q8_preq_kernel_cluster)};
    for (const void* k : kernels) {
      if (g_init_err == cudaSuccess)
        g_init_err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(kSmemLimit));
    }
    int dev = 0;
    if (g_init_err == cudaSuccess) g_init_err = cudaGetDevice(&dev);
    if (g_init_err == cudaSuccess)
      g_init_err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
  });
  return g_init_err;
}

bool takes(int features, int hidden) {
  if (features <= 0 || features > kMaxFeatures || hidden <= 0 || hidden > kMaxHidden)
    return false;
  const Layout L = make_layout(features, hidden);
  return L.stages >= 2 && L.total <= kSmemLimit;
}

// the checks both launches share; returns the grid, or 0 with *err set
int launch_grid(int batch, int features, int hidden, size_t* smem, cudaError_t* err) {
  *err = cudaSuccess;
  if (batch <= 0 || !takes(features, hidden)) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  *err = init_once();
  if (*err != cudaSuccess) return 0;
  const Layout L = make_layout(features, hidden);
  *smem = L.total;
  const int tiles = (batch + L.rows - 1) / L.rows;
  return tiles < g_sms ? tiles : g_sms;
}

cudaError_t launch_cluster(const int8_t* q, const float* s, const unsigned char* wstream,
                           const float* vec, const int8_t* w3, const float* s3,
                           const float* b3, float* proba, float* logits, int batch,
                           int features, int hidden, cudaStream_t stream) {
  cudaError_t err = init_once();
  if (err != cudaSuccess) return err;
  const ClusterLayout C = cluster_layout(features, hidden);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C.ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((batch + kClusterRows - 1) / kClusterRows * C.ctas));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = C.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_mlp_q8_preq_kernel_cluster, q, s, wstream, vec, w3, s3,
                           b3, proba, logits, batch, features, hidden);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// out: k1p, hp, rows, chunks, stages, resident, shared-memory bytes; returns
// 0, or 1 for a shape the kernels do not take
extern "C" int ccfd_fused_mlp_q8_plan(int features, int hidden, int* out) {
  if (!takes(features, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(features, hidden);
  out[0] = L.k1p;
  out[1] = L.hp;
  out[2] = L.rows;
  out[3] = L.chunks;
  out[4] = L.stages;
  out[5] = L.stages == L.chunks;
  out[6] = static_cast<int>(L.total);
  return 0;
}

extern "C" int ccfd_fused_mlp_q8(const void* x, const void* mu, const void* sigma,
                                 const void* wstream, const void* vec, const void* w3,
                                 const void* s3, const void* b3, void* proba, void* logits,
                                 int batch, int features, int hidden, void* stream) {
  cudaError_t err;
  size_t smem = 0;
  const int blocks = launch_grid(batch, features, hidden, &smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mlp_q8_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(mu),
      static_cast<const float*>(sigma), static_cast<const unsigned char*>(wstream),
      static_cast<const float*>(vec), static_cast<const int8_t*>(w3),
      static_cast<const float*>(s3), static_cast<const float*>(b3),
      static_cast<float*>(proba), static_cast<float*>(logits), batch, features, hidden);
  return static_cast<int>(cudaGetLastError());
}

// launch: 0 the persistent grid (any batch), 1 the cluster (where hp / 64
// <= kClusterMaxCtas)
extern "C" int ccfd_fused_mlp_q8_preq(const void* q, const void* s, const void* wstream,
                                      const void* vec, const void* w3, const void* s3,
                                      const void* b3, void* proba, void* logits, int batch,
                                      int features, int hidden, int launch, void* stream) {
  if (batch <= 0 || !takes(features, hidden) || launch < 0 || launch > 1 ||
      (launch == 1 && cluster_layout(features, hidden).ctas > kClusterMaxCtas))
    return static_cast<int>(cudaErrorInvalidValue);
  if (launch == 1)
    return static_cast<int>(launch_cluster(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<const unsigned char*>(wstream), static_cast<const float*>(vec),
        static_cast<const int8_t*>(w3), static_cast<const float*>(s3),
        static_cast<const float*>(b3), static_cast<float*>(proba), static_cast<float*>(logits),
        batch, features, hidden, static_cast<cudaStream_t>(stream)));
  cudaError_t err;
  size_t smem = 0;
  const int blocks = launch_grid(batch, features, hidden, &smem, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mlp_q8_preq_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const unsigned char*>(wstream), static_cast<const float*>(vec),
      static_cast<const int8_t*>(w3), static_cast<const float*>(s3),
      static_cast<const float*>(b3), static_cast<float*>(proba),
      static_cast<float*>(logits), batch, features, hidden);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ccfd_q8_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
