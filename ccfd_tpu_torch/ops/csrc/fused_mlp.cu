// Kernel B1 for Hopper: the fused 3-layer MLP fraud scorer in bf16.
//
// Replaces the Pallas TPU kernel ccfd_tpu/ops/fused_mlp.py::_kernel
// (entry fused_mlp_score). It computes what that kernel computes, with the
// same rounding points:
//
//   h1 = bf16_rn(relu(x @ W1 + b1))        x (B, F<=128) bf16, W1 (F, H) bf16
//   h2 = bf16_rn(relu(h1 @ W2 + b2))       W2 (H, H) bf16, f32 accumulation
//   z  = sum_j f32(h2_j) * f32(w3_j) + b3  w3 (H) bf16, an f32 reduce in a
//                                          fixed column order (below)
//   p  = sigmoid(z)
//
// The standardizer is folded into W1/b1 on the host (ops/fused_mlp.py
// fold_for_kernel). Any H and any F up to 128 (the reference's lane
// bound): the host zero-pads F to a multiple of 64 and H to a multiple of
// 128, which is exact (padded weights, biases and w3 entries are 0, so a
// padded column of h is relu(0) = 0 and adds 0 to z).
//
// What bounds it: at H = 256 a row costs 2 * (30*256 + 256*256 + 256) =
// 146,432 operations against 60 bytes of input and 4 of output, about
// 2,300 operations per byte, far above the H100's ~295 bf16 operations per
// byte of HBM: the tensor cores set the bound (2.4 us at B = 16384). The
// weights (160 KB at H = 256, 2.1 MB at H = 1,024) are read from L2, not
// HBM, once per block or once per row tile.
//
// Design:
// - a persistent grid of min(tiles, SMs) blocks, each walking 64-row tiles;
// - warp specialisation: one producer warp issues asynchronous bulk copies
//   (cp.async.bulk, completing on mbarriers), two consumer warpgroups run
//   wgmma. Nothing copies weights thread by thread;
// - the host packs W1^T and W2^T once per publish into a stream of chunks
//   (ops/fused_mlp.py pack_stream): each chunk is up to 256 output columns
//   x 64 inputs (32 KB) in exactly the shared-memory layout wgmma reads,
//   K-major with the 128-byte swizzle. The producer streams them through a
//   ring of stages, one bulk copy each, in the order the consumers use them.
//   Where the whole stream fits in the ring (H <= 256 at F <= 64), each
//   block copies it once and keeps it resident: on later tiles the producer
//   only re-arms the stages;
// - the x tile (64 rows of F bf16, 128 * F contiguous bytes) comes in with
//   one bulk copy; the ragged last tile copies what exists (rounded down to
//   16 bytes, the rest read directly) and zeroes the rest. The consumers
//   spread it into the swizzled, zero-padded A operand of layer 1;
// - products are wgmma m64n128k16 bf16 -> f32: warpgroup w owns columns
//   [128w, 128w + 128) of each 256-column part. Layer 1's epilogue adds b1,
//   applies relu, rounds to bf16 and writes h1 into the swizzled layout
//   layer 2's A operand reads (a 64 x H tile: 128 KB at H = 1,024). Layer
//   2's epilogue rounds h2 to bf16 and multiplies by w3;
// - layer 3's order, one for every launch: each row's h2 * w3 is summed
//   per 64-column group (a thread's 16 columns of the group in column
//   order, then over the group's 4 lanes: shfl_xor 1, then 2); each pair
//   of groups 2i and 2i + 1 (a 128-column half) is added, g(2i) + g(2i+1);
//   the halves are summed in order from 0, then + b3. So a row's result
//   does not depend on the batch, on which block scored it, or on the
//   launch (the cluster path below sums the same way);
// - wider than H = 1,024 the h1 tile no longer fits beside two stages
//   ("wide" layout). Layer 1's epilogue then writes h1, in bf16 and already
//   swizzled, to a per-block scratch in global memory that the wrapper
//   allocates (64 x H x 2 bytes a block: 512 KB at H = 4,096); the consumers
//   fence it for the async proxy and arrive on an mbarrier, and the
//   producer, once that barrier completes, streams each 64-column K block
//   of h1 (8 KB) through the ring beside the W2 chunk it multiplies: a
//   stage is then 32 KB of chunk + 8 KB of A block. Each warpgroup keeps a
//   running sum of its halves over the parts, in part order, and the two
//   sums are added. The h1 blocks are read once per part (H / 256 times a
//   tile), from L2;
// - shared memory: the ring, h1 (not in the wide layout), the two x tiles,
//   the partials and the barriers; 232,448 bytes at most, set once per
//   library load.
//
// B1 at small batches, on a thread-block cluster. At the REST buckets (16
// and 128 rows) the persistent grid is one or two blocks, and each walks a
// tile's whole chain alone on one SM: 0.0072 ms at B = 16 and 0.0078 ms at
// 128 on the H100, against a bound of 0.00002 ms. Latency, not bytes or
// operations, bounds it. So where hp / 64 <= 8 (a portable cluster),
// ccfd_fused_mlp_bf16 can launch fused_mlp_bf16_kernel_cluster instead
// (cudaLaunchKernelEx with a cluster dimension of hp / 64): one cluster a
// 64-row tile, one CTA of one warpgroup a 64-column group. The entry
// launches what its caller names; the choice by batch lives in the Python
// wrapper alone (ops/fused_mlp.py path_for, CLUSTER_MAX_BATCH).
// - Loads, by bulk copies on mbarriers from the stream pack_stream lays
//   out (nothing repacked): every CTA the tile's rows, all of layer 1's
//   chunks (32 KB at H = 256) with b1, and its own 64 rows of each layer-2
//   chunk (one contiguous 8 KB slice a K block) with its columns of b2 and
//   w3. b3 is read while the copies fly.
// - Layer 1 whole in every CTA, so no crossing between SMs before layer
//   2: wgmma m64n64k16 with A from registers, each thread's fragments read
//   straight from the rows as copied (unpadded; no swizzled tile, no
//   layout pass), 16-deep steps past the features skipped.
// - h1 stays in registers: the accumulator fragment of a product is laid
//   out as the A fragment of the next, so layer 1's epilogue (b1, relu,
//   bf16) writes layer 2's A operand with no trip through shared memory.
// - Layer 2: each CTA its 64 columns over the whole K, one m64n64k16
//   chain in the persistent path's K order (f32 sums are not associative:
//   K is not split).
// - Layer 3: each CTA's group sum of a row goes to rank 0 by st.async,
//   counted on rank 0's mbarrier; one barrier.cluster arrive (early) and
//   wait (before the first remote store) only see that every CTA's
//   mbarriers are initialised. Rank 0 sums the groups in the order above
//   and stores p (and z).
// The two paths give the same bits for a row at every batch (the
// products of a column do not depend on the product's width or on where
// its A operand comes from, and layer 3 has one order).
// What bounds it: the chain of dependent steps; a launch takes 0.0031 ms
// at B = 16 and 128 (H = 256) on the H100 (NVIDIA H100 80GB HBM3, 700 W).
// Crossover, measured on that card with tools/torch_q8_crossover.py
// --kernel b1 (the two paths bit-equal at every batch; ms a launch,
// persistent / cluster): at H = 256, B = 16 0.0074 / 0.0031, 128
// 0.0079 / 0.0031, 1024 0.0080 / 0.0032, 2048 0.0080 / 0.0041, 4096
// 0.0081 / 0.0061, 16384 0.0144 / 0.0141; at H = 512, 16 0.0141 / 0.0057,
// 128 0.0147 / 0.0058, 1024 0.0148 / 0.0103, 2048 0.0146 / 0.0151, 4096
// 0.0148 / 0.0242. The wrapper takes the cluster path for batches up to
// 1024 (CLUSTER_MAX_BATCH), the largest measured batch at which it is the
// faster at both widths (the buckets 16, 128 and 1024 of the Scorer's
// ladder).
//
// Entries: ccfd_fused_mlp_bf16 (the launch its argument names: 0 the
// persistent grid, 1 the cluster) and ccfd_fused_mlp_bf16_plan (the
// persistent layout, which ops/fused_mlp.py plan mirrors), plain C
// functions bound with ctypes. The launch returns cudaGetLastError() (the
// cluster launch the error of cudaLaunchKernelEx); 1
// (cudaErrorInvalidValue) for what it cannot run: a shape it does not
// take, no rows, or a cluster of more than kClusterMaxCtas CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kTileRows = 64;
constexpr int kKBlock = 64;                 // bf16 in one 128-byte swizzle row
constexpr int kPart = 256;                  // output columns of one chunk
constexpr int kHalf = 128;                  // columns one warpgroup owns in a part
constexpr int kGroup = 64;                  // columns of one term of layer 3's order
constexpr int kStageBytes = kPart * 128;    // one chunk: 256 rows x 128 bytes
constexpr int kAtomBytes = kTileRows * 128;  // a 64-row x 64-input A block
constexpr int kMaxFeatures = 128;
constexpr int kMaxResidentH1 = 1024;  // widest H whose h1 tile stays in shared memory
constexpr int kMaxParts = kMaxResidentH1 / kPart;  // partial slots of a row
constexpr int kMaxStages = 8;
constexpr int kConsumers = 256;  // two warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr size_t kSmemLimit = 232448;

struct Layout {
  int k1p, hp, parts, k1b, hb, chunks, stages;
  bool wide;      // h1 goes through global scratch and the ring
  size_t sbytes;  // one ring stage: a chunk, and in the wide layout an h1 block
  // byte offsets into the dynamic shared memory
  size_t ring, h1, xa, xraw, partial, bars, total;
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

__host__ __device__ inline Layout make_layout(int features, int hidden) {
  Layout L;
  L.k1p = (features + kKBlock - 1) / kKBlock * kKBlock;
  L.hp = (hidden + kHalf - 1) / kHalf * kHalf;
  L.parts = (L.hp + kPart - 1) / kPart;
  L.k1b = L.k1p / kKBlock;
  L.hb = L.hp / kKBlock;
  L.chunks = L.parts * (L.k1b + L.hb);
  L.wide = hidden > kMaxResidentH1;
  L.sbytes = kStageBytes + (L.wide ? kAtomBytes : 0);
  const size_t h1 = L.wide ? 0 : static_cast<size_t>(kTileRows) * L.hp * 2;
  const size_t xa = static_cast<size_t>(kTileRows) * L.k1p * 2;
  const size_t xraw = align128(static_cast<size_t>(kTileRows) * features * 2);
  const size_t partial = sizeof(float) * kTileRows * 2 * kMaxParts;
  const size_t bars = 256;  // 2 * kMaxStages + 3 mbarriers
  const size_t fixed = h1 + xa + xraw + partial + bars;
  const int fit = fixed < kSmemLimit ? static_cast<int>((kSmemLimit - fixed) / L.sbytes) : 0;
  L.stages = L.chunks < kMaxStages ? L.chunks : kMaxStages;
  if (fit < L.stages) L.stages = fit;
  // swizzled regions first, each a multiple of 1,024 bytes
  L.ring = 0;
  L.h1 = L.ring + static_cast<size_t>(L.stages) * L.sbytes;
  L.xa = L.h1 + h1;
  L.xraw = L.xa + xa;
  L.partial = L.xraw + xraw;
  L.bars = L.partial + partial;
  L.total = L.bars + bars;
  return L;
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row atoms
// 1,024 bytes apart (SBO), leading offset unused (1), base offset 0 (every
// operand block starts 1,024-aligned)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving reads or writes of the accumulators across
// the asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, the warpgroup's fragment) += A (64 x 16) * B (16 x 128),
// both bf16 from shared memory through their descriptors
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// byte offset of element (row, k) in a swizzled 64-row operand whose K runs
// in blocks of 64 (one 1,024-aligned block of rows x 128 bytes per 64 k)
__device__ __forceinline__ uint32_t a_offset(int row, int k, int rows) {
  return static_cast<uint32_t>((k / kKBlock) * rows * 128 + row * 128 +
                               ((((k % kKBlock) / 8) ^ (row % 8)) * 16) + (k % 8) * 2);
}

// two f32 of an epilogue vector: through the read-only cache from global
// memory, or from a copy in shared memory
template <bool kGlobal>
__device__ __forceinline__ float2 load2(const float* p) {
  if constexpr (kGlobal) return __ldg(reinterpret_cast<const float2*>(p));
  return *reinterpret_cast<const float2*>(p);
}

// layer 3 of kG 64-column groups of a fragment, group g its pairs 8g ..
// 8g + 7 (columns col0 + 64g + 8j, b2 and w3 indexed alike): h2 =
// bf16(relu(acc + b2)); each row's sum of h2 * w3 over the thread's 16
// columns of a group in column order, then over the group's 4 lanes
// (shfl_xor 1, then 2). Every launch sums a group this way; the groups run
// side by side, for the instruction-level parallelism.
template <bool kGlobal, int kG, int N>
__device__ __forceinline__ void group_dots(const float (&acc)[N], const float* b2,
                                           const float* w3, int col0, float (&s0)[kG],
                                           float (&s1)[kG]) {
#pragma unroll
  for (int g = 0; g < kG; ++g) s0[g] = s1[g] = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int col = col0 + g * kGroup + j * 8, a = 4 * (8 * g + j);
      const float2 b = load2<kGlobal>(b2 + col);
      const float2 w = load2<kGlobal>(w3 + col);
      const float2 top = __bfloat1622float2(
          __floats2bfloat162_rn(fmaxf(acc[a] + b.x, 0.0f), fmaxf(acc[a + 1] + b.y, 0.0f)));
      const float2 bot = __bfloat1622float2(
          __floats2bfloat162_rn(fmaxf(acc[a + 2] + b.x, 0.0f), fmaxf(acc[a + 3] + b.y, 0.0f)));
      s0[g] = __fadd_rn(s0[g], __fmul_rn(top.x, w.x));
      s0[g] = __fadd_rn(s0[g], __fmul_rn(top.y, w.y));
      s1[g] = __fadd_rn(s1[g], __fmul_rn(bot.x, w.x));
      s1[g] = __fadd_rn(s1[g], __fmul_rn(bot.y, w.y));
    }
  }
#pragma unroll
  for (int m = 1; m <= 2; m *= 2) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      s0[g] += __shfl_xor_sync(0xffffffffu, s0[g], m);
      s1[g] += __shfl_xor_sync(0xffffffffu, s1[g], m);
    }
  }
}

// a row's z (its halves' sum, in order) + b3, and its probability
__device__ __forceinline__ void store_row(float z, float b3, float* proba, float* logits,
                                          int row) {
  z += b3;
  proba[row] = 1.0f / (1.0f + expf(-z));
  if (logits != nullptr) logits[row] = z;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const unsigned char* __restrict__ wstream,
                      const float* __restrict__ vec,  // (3, hp): b1, b2, w3
                      const float* __restrict__ b3, float* __restrict__ proba,
                      float* __restrict__ logits,
                      unsigned char* __restrict__ h1_scratch,  // wide layout only
                      int batch, int features, int hidden) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout L = make_layout(features, hidden);
  if (hopper::smem_addr(smem) % 1024 != 0) __trap();  // the swizzle needs it
  unsigned char* ring = smem + L.ring;
  unsigned char* h1 = smem + L.h1;
  unsigned char* xa = smem + L.xa;
  float* partial = reinterpret_cast<float*>(smem + L.partial);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xfull = empty + kMaxStages;
  uint64_t* xempty = xfull + 1;
  uint64_t* h1full = xempty + 1;  // wide: this tile's h1 is in the scratch
  // wide: this block's h1 tile in global memory, laid out as in shared memory
  unsigned char* h1g =
      L.wide ? h1_scratch + static_cast<size_t>(blockIdx.x) * kTileRows * L.hp * 2 : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (batch + kTileRows - 1) / kTileRows;
  const bool resident = L.stages == L.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init(xfull, 1);
    hopper::mbar_init(xempty, kConsumerWarps);
    hopper::mbar_init(h1full, kConsumerWarps);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: the x tile, then the weight chunks, tile after tile ----
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0, xphase = 0, hphase = 0;
    for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
      const int row0 = tile * kTileRows;
      const int rows = min(kTileRows, batch - row0);
      const uint32_t xbytes = (static_cast<uint32_t>(rows) * features * 2) & ~15u;
      hopper::mbar_wait(xempty, xphase ^ 1);
      hopper::mbar_arrive_expect_tx(xfull, xbytes);
      if (xbytes) {
        hopper::bulk_g2s(smem + L.xraw, x + static_cast<size_t>(row0) * features, xbytes,
                         xfull);
      }
      xphase ^= 1;
      const unsigned char* src = wstream;
      for (int layer = 0; layer < 2; ++layer) {
        const int kblocks = layer == 0 ? L.k1b : L.hb;
        const bool h1_blocks = layer == 1 && L.wide;
        if (h1_blocks) {  // the consumers have written this tile's h1
          hopper::mbar_wait(h1full, hphase);
          hphase ^= 1;
        }
        for (int p = 0; p < L.parts; ++p) {
          const uint32_t bytes = static_cast<uint32_t>(min(kPart, L.hp - p * kPart)) * 128;
          for (int kb = 0; kb < kblocks; ++kb) {
            hopper::mbar_wait(&empty[stage], phase ^ 1);
            if (resident && it > 0) {
              hopper::mbar_arrive(&full[stage]);  // the chunk is still there
            } else {
              unsigned char* dst = ring + static_cast<size_t>(stage) * L.sbytes;
              hopper::mbar_arrive_expect_tx(&full[stage], bytes + (h1_blocks ? kAtomBytes : 0));
              hopper::bulk_g2s(dst, src, bytes, &full[stage]);
              if (h1_blocks) {
                hopper::bulk_g2s(dst + kStageBytes, h1g + static_cast<size_t>(kb) * kAtomBytes,
                                 kAtomBytes, &full[stage]);
              }
            }
            src += bytes;
            if (++stage == L.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups ----
  const int tid = threadIdx.x;
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp % 4) * 16 + g, r1 = r0 + 8;  // this thread's fragment rows
  const uint32_t ring_addr = hopper::smem_addr(ring);
  const uint32_t h1_addr = hopper::smem_addr(h1);
  const uint32_t xa_addr = hopper::smem_addr(xa);
  const unsigned short* xg = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(smem + L.xraw);
  int stage = 0;
  uint32_t phase = 0, xphase = 0;
  float acc[64];

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kTileRows;
    const int rows = min(kTileRows, batch - row0);
    const int xelems = static_cast<int>(((static_cast<uint32_t>(rows) * features * 2) & ~15u) / 2);

    // the x tile into layer 1's swizzled A operand, zero-padded
    hopper::mbar_wait(xfull, xphase);
    xphase ^= 1;
    const int groups = L.k1p / 8;
    for (int i = tid; i < kTileRows * groups; i += kConsumers) {
      const int r = i / groups, k0 = (i % groups) * 8;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t pair = 0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + 2 * j + e;
          uint32_t v = 0;
          if (r < rows && k < features) {
            const int idx = r * features + k;
            v = idx < xelems ? xs[idx] : xg[static_cast<size_t>(row0) * features + idx];
          }
          pair |= v << (16 * e);
        }
        w[j] = pair;
      }
      *reinterpret_cast<uint4*>(xa + a_offset(r, k0, kTileRows)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(xempty);
    hopper::fence_proxy_async();
    hopper::named_sync(kConsumers);

    float zw0 = 0.0f, zw1 = 0.0f;  // wide: this warpgroup's running sums of its halves
    for (int layer = 0; layer < 2; ++layer) {
      const int kblocks = layer == 0 ? L.k1b : L.hb;
      const uint32_t a_addr = layer == 0 ? xa_addr : h1_addr;
      const bool h1_blocks = layer == 1 && L.wide;
      for (int p = 0; p < L.parts; ++p) {
        const bool mine = min(kPart, L.hp - p * kPart) > wg * kHalf;
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
        for (int kb = 0; kb < kblocks; ++kb) {
          hopper::mbar_wait(&full[stage], phase);
          if (mine) {
            const uint32_t s_addr = ring_addr + stage * static_cast<uint32_t>(L.sbytes);
            const uint32_t b_addr = s_addr + wg * kHalf * 128;
            // the A block: in shared memory, or (wide) the h1 block beside the chunk
            const uint32_t ak_addr = h1_blocks ? s_addr + kStageBytes : a_addr + kb * kAtomBytes;
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int s = 0; s < kKBlock / 16; ++s) {
              wgmma_m64n128k16(acc, sw128_desc(ak_addr + s * 32), sw128_desc(b_addr + s * 32));
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_acc(acc);
          }
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&empty[stage]);
          if (++stage == L.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (!mine) continue;
        const int col0 = p * kPart + wg * kHalf + 2 * t;
        if (layer == 0) {
          // h1 = bf16(relu(acc + b1)) into layer 2's A operand (wide: its
          // copy in global memory, in the same layout)
          unsigned char* h1w = L.wide ? h1g : h1;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = col0 + j * 8;
            const float2 b = __ldg(reinterpret_cast<const float2*>(vec + col));
            const __nv_bfloat162 top = __floats2bfloat162_rn(fmaxf(acc[4 * j] + b.x, 0.0f),
                                                             fmaxf(acc[4 * j + 1] + b.y, 0.0f));
            const __nv_bfloat162 bot = __floats2bfloat162_rn(
                fmaxf(acc[4 * j + 2] + b.x, 0.0f), fmaxf(acc[4 * j + 3] + b.y, 0.0f));
            *reinterpret_cast<__nv_bfloat162*>(h1w + a_offset(r0, col, kTileRows)) = top;
            *reinterpret_cast<__nv_bfloat162*>(h1w + a_offset(r1, col, kTileRows)) = bot;
          }
        } else {
          // each row's sum over this half: its two 64-column groups, added
          float g0[2], g1[2];
          group_dots<true>(acc, vec + L.hp, vec + 2 * L.hp, col0, g0, g1);
          const float s0 = g0[0] + g0[1], s1 = g1[0] + g1[1];
          if (L.wide) {
            zw0 += s0;
            zw1 += s1;
          } else if (t == 0) {
            partial[r0 * 2 * kMaxParts + 2 * p + wg] = s0;
            partial[r1 * 2 * kMaxParts + 2 * p + wg] = s1;
          }
        }
      }
      if (layer == 0 && L.wide) {
        // h1's global stores before the producer's bulk copies read them
        __threadfence();
        hopper::fence_proxy_async_all();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(h1full);
      } else if (layer == 0) {
        hopper::fence_proxy_async();
      } else if (L.wide && t == 0) {
        partial[r0 * 2 * kMaxParts + wg] = zw0;
        partial[r1 * 2 * kMaxParts + wg] = zw1;
      }
      hopper::named_sync(kConsumers);
    }

    // each row's halves in (part, warpgroup) order, + b3, sigmoid
    if (tid < rows) {
      float z = 0.0f;
      if (L.wide) {
        z = partial[tid * 2 * kMaxParts] + partial[tid * 2 * kMaxParts + 1];
      } else {
        for (int p = 0; p < L.parts; ++p) {
          const int prow = min(kPart, L.hp - p * kPart);
          for (int w = 0; w * kHalf < prow; ++w) z += partial[tid * 2 * kMaxParts + 2 * p + w];
        }
      }
      store_row(z, b3[0], proba, logits, row0 + tid);
    }
  }
}

// ---- B1 on a thread-block cluster: the small batches ----

constexpr int kClusterMaxCtas = 8;  // the portable cluster size: H <= 512
constexpr int kClusterThreads = 128;  // one warpgroup
constexpr int kSliceBytes = kGroup * 128;  // a CTA's 64 rows of one layer-2 chunk

struct ClusterLayout {
  int k1p, hp, ctas;
  uint32_t w1_bytes, w2_bytes;  // all of layer 1's chunks; the CTA's slices of layer 2's
  // byte offsets into the dynamic shared memory, the chunks 1,024-aligned;
  // 217,728 bytes at most (F = 128, H = 512)
  size_t w1, w2, xraw, b1, vec2, part, bars, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int features, int hidden) {
  ClusterLayout C;
  C.k1p = (features + kKBlock - 1) / kKBlock * kKBlock;
  C.hp = (hidden + kHalf - 1) / kHalf * kHalf;
  C.ctas = C.hp / kGroup;
  C.w1_bytes = static_cast<uint32_t>(C.hp * C.k1p * 2);
  C.w2_bytes = static_cast<uint32_t>(C.hp / kKBlock * kSliceBytes);
  C.w1 = 0;
  C.w2 = C.w1 + C.w1_bytes;
  C.xraw = C.w2 + C.w2_bytes;
  C.b1 = C.xraw + align128(static_cast<size_t>(kTileRows) * features * 2);
  C.vec2 = C.b1 + sizeof(float) * C.hp;  // b2 and w3 of the CTA's columns
  C.part = C.vec2 + sizeof(float) * 2 * kGroup;  // rank 0: each CTA's group sum of a row
  C.bars = C.part + sizeof(float) * kClusterMaxCtas * kTileRows;
  C.total = C.bars + 128;
  return C;
}

// d (64 x 64 f32) += A (64 x 16, bf16 from registers: the warp's 16 rows,
// a[0..3] as for mma.sync m16n8k16) * B (16 x 64 bf16, from shared memory)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// two bf16 of row r, inputs k and k + 1 (k even), of the row tile as its
// copy left it (rows of ``features`` values, unpadded), 0 past the rows
// and the features
__device__ __forceinline__ uint32_t x_pair(const unsigned short* xs, int r, int k, int rows,
                                           int features) {
  if (r >= rows || k >= features) return 0u;
  const int idx = r * features + k;
  if ((features & 1) == 0) return *reinterpret_cast<const uint32_t*>(xs + idx);
  return static_cast<uint32_t>(xs[idx]) |
         (k + 1 < features ? static_cast<uint32_t>(xs[idx + 1]) << 16 : 0u);
}

// bf16(relu(acc + b)) of a fragment's column pair, packed as wgmma's A
// register takes it (the lower column in the low half)
__device__ __forceinline__ uint32_t h_pair(float a, float b, float2 bias) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(fmaxf(a + bias.x, 0.0f), fmaxf(b + bias.y, 0.0f));
  return static_cast<uint32_t>(__bfloat16_as_ushort(h.x)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(h.y)) << 16;
}

// The mbarriers of a cluster CTA: the row tile; layer 1's chunks with b1;
// its slices of layer 2 with its columns of b2 and w3; and (rank 0) what
// the CTAs send it
enum ClusterBar { kBarX, kBarW1, kBarW2, kBarPart };

// layer 1's 64-column groups a CTA computes at once: at most 128
// accumulator registers beside h1's fragments
__host__ __device__ constexpr int layer1_batch(int ctas) {
  return ctas <= 4 ? ctas : (ctas == 6 ? 3 : 2);
}

// One cluster of kCtas = hp / 64 CTAs of one warpgroup scores one tile of
// up to 64 rows: CTA r computes all of layer 1, keeps h1 in registers as
// the A operand of layer 2 (the layout of a product's accumulator is that
// of the next product's A fragments), computes columns [64 r, 64 r + 64)
// of layer 2, and sends each row's sum of those columns' h2 * w3 to rank 0.
template <int kCtas>
__global__ void __launch_bounds__(kClusterThreads, 1)
fused_mlp_bf16_kernel_cluster(const __nv_bfloat16* __restrict__ x,
                              const unsigned char* __restrict__ wstream,
                              const float* __restrict__ vec, const float* __restrict__ b3,
                              float* __restrict__ proba, float* __restrict__ logits, int batch,
                              int features, int hidden) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const ClusterLayout C = cluster_layout(features, hidden);
  if (hopper::smem_addr(smem) % 1024 != 0) __trap();  // the swizzle needs it
  const int rank = hopper::cluster_rank();
  const int row0 = static_cast<int>(blockIdx.x) / kCtas * kTileRows;
  const int rows = min(kTileRows, batch - row0);
  unsigned short* xs = reinterpret_cast<unsigned short*>(smem + C.xraw);
  const float* b1s = reinterpret_cast<const float*>(smem + C.b1);
  const float* b2s = reinterpret_cast<const float*>(smem + C.vec2);
  const float* w3s = b2s + kGroup;
  float* part = reinterpret_cast<float*>(smem + C.part);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C.bars);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t xbytes = (static_cast<uint32_t>(rows) * features * 2) & ~15u;

  // ---- the copies: thread 0 the row tile and layer 1's operands, warp 1
  // this CTA's slices of layer 2's; warp 2 arms the barrier of what the
  // CTAs send rank 0, and its cluster-wide fence is off the copies' path ----
  if (tid == 0) {
    hopper::mbar_init(&bar[kBarX], 1);
    hopper::mbar_init(&bar[kBarW1], 1);
    hopper::fence_proxy_async();  // the barriers, to this CTA's copies
    hopper::mbar_arrive_expect_tx(&bar[kBarX], xbytes);
    if (xbytes)
      hopper::bulk_g2s(xs, x + static_cast<size_t>(row0) * features, xbytes, &bar[kBarX]);
    hopper::mbar_arrive_expect_tx(&bar[kBarW1], C.w1_bytes + 4 * C.hp);
    hopper::bulk_g2s(smem + C.w1, wstream, C.w1_bytes, &bar[kBarW1]);
    hopper::bulk_g2s(smem + C.b1, vec, 4 * C.hp, &bar[kBarW1]);
  } else if (tid == 32) {
    hopper::mbar_init(&bar[kBarW2], 1);
    hopper::fence_proxy_async();
    hopper::mbar_arrive_expect_tx(&bar[kBarW2], C.w2_bytes + 8 * kGroup);
    // in each K block's chunk of the part holding its columns, rows
    // [64 r, 64 r + 64) are one contiguous 8 KB slice
    const int p = rank * kGroup / kPart;
    const int prow = min(kPart, C.hp - p * kPart);
    const unsigned char* src = wstream + C.w1_bytes + static_cast<size_t>(p) * kPart * C.hp * 2 +
                               static_cast<size_t>(rank * kGroup - p * kPart) * 128;
    for (int kb = 0; kb < kCtas; ++kb)  // hp / 64 K blocks
      hopper::bulk_g2s(smem + C.w2 + kb * kSliceBytes, src + static_cast<size_t>(kb) * prow * 128,
                       kSliceBytes, &bar[kBarW2]);
    hopper::bulk_g2s(smem + C.vec2, vec + C.hp + rank * kGroup, 4 * kGroup, &bar[kBarW2]);
    hopper::bulk_g2s(smem + C.vec2 + 4 * kGroup, vec + 2 * C.hp + rank * kGroup, 4 * kGroup,
                     &bar[kBarW2]);
  } else if (tid == 64) {
    hopper::mbar_init(&bar[kBarPart], 1);
    hopper::mbar_arrive_expect_tx(&bar[kBarPart],
                                  rank == 0 ? static_cast<uint32_t>(kCtas * rows * 4) : 0u);
  }
  // the ragged tail past the row copy (under 16 bytes) comes directly
  const int tail = rows * features - static_cast<int>(xbytes / 2);
  if (tid < tail)
    xs[xbytes / 2 + tid] = reinterpret_cast<const unsigned short*>(
        x)[static_cast<size_t>(row0) * features + xbytes / 2 + tid];
  __syncthreads();
  if (tid == 64) hopper::mbar_init_fence();  // to the other CTAs
  hopper::cluster_arrive_relaxed();
  const float b3v = __ldg(b3);

  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's fragment rows
  const uint32_t w1_addr = hopper::smem_addr(smem + C.w1);
  const uint32_t w2_addr = hopper::smem_addr(smem + C.w2);

  // ---- layer 1: the row tile's A fragments straight from its copy; a
  // 16-deep step past the features is all zeros and is skipped (adding a
  // zero product to an accumulator that is never -0 leaves its bits) ----
  hopper::mbar_wait(&bar[kBarX], 0);
  uint32_t xf[kMaxFeatures / 16][4];
#pragma unroll
  for (int s = 0; s < kMaxFeatures / 16; ++s) {
    if (16 * s < features) {
      xf[s][0] = x_pair(xs, r0, 16 * s + 2 * t, rows, features);
      xf[s][1] = x_pair(xs, r1, 16 * s + 2 * t, rows, features);
      xf[s][2] = x_pair(xs, r0, 16 * s + 8 + 2 * t, rows, features);
      xf[s][3] = x_pair(xs, r1, 16 * s + 8 + 2 * t, rows, features);
    }
  }
  // all hp columns, layer1_batch groups at a time, each group's K in the
  // persistent path's order; h1 = bf16(relu(acc + b1)) into the A
  // fragments of layer 2: its K step 4c + 2i + e is group c's column pairs
  // j = 2i + e
  constexpr int kBatch = layer1_batch(kCtas);
  uint32_t hf[4 * kCtas][4];
  hopper::mbar_wait(&bar[kBarW1], 0);
#pragma unroll
  for (int c0 = 0; c0 < kCtas; c0 += kBatch) {
    float acc[kBatch][32];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[i][e] = 0.0f;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) fence_acc(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kMaxFeatures / 16; ++s) {
      if (16 * s < features) {
        const int kb = s / 4;
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
          // group c's rows of layer 1's chunk (part c / 4, K block kb)
          const int c = c0 + i, p = c * kGroup / kPart;
          const int prow = min(kPart, C.hp - p * kPart);
          const uint32_t b_addr = w1_addr + p * kPart * C.k1p * 2 + kb * prow * 128 +
                                  (c * kGroup - p * kPart) * 128 + (s % 4) * 32;
          wgmma_m64n64k16_rs(acc[i], xf[s], sw128_desc(b_addr));
        }
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      fence_acc(acc[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (c0 + i) * kGroup + 8 * j + 2 * t;
        const float2 b = *reinterpret_cast<const float2*>(b1s + col);
        uint32_t* a = hf[4 * (c0 + i) + j / 2];
        a[2 * (j % 2)] = h_pair(acc[i][4 * j], acc[i][4 * j + 1], b);
        a[2 * (j % 2) + 1] = h_pair(acc[i][4 * j + 2], acc[i][4 * j + 3], b);
      }
    }
  }

  // ---- layer 2: this CTA's 64 columns over the whole K, in the persistent
  // path's order; layer 3's group sums to rank 0 ----
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
  hopper::mbar_wait(&bar[kBarW2], 0);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4 * kCtas; ++s)
    wgmma_m64n64k16_rs(acc, hf[s], sw128_desc(w2_addr + (s / 4) * kSliceBytes + (s % 4) * 32));
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
  float g0[1], g1[1];
  group_dots<false>(acc, b2s, w3s, 2 * t, g0, g1);
  const float s0 = g0[0], s1 = g1[0];
  hopper::cluster_wait();  // every CTA's barriers are initialised
  if (t == 0) {
    const uint32_t bar0 = hopper::peer_addr(&bar[kBarPart], 0);
    if (r0 < rows)
      hopper::st_async(hopper::peer_addr(part + rank * kTileRows + r0, 0), __float_as_uint(s0),
                       bar0);
    if (r1 < rows)
      hopper::st_async(hopper::peer_addr(part + rank * kTileRows + r1, 0), __float_as_uint(s1),
                       bar0);
  }
  if (rank == 0) {
    hopper::mbar_wait_cluster(&bar[kBarPart], 0);
    if (tid < rows) {
      float z = 0.0f;
#pragma unroll
      for (int c = 0; c < kCtas; c += 2)
        z += part[c * kTileRows + tid] + part[(c + 1) * kTileRows + tid];
      store_row(z, b3v, proba, logits, row0 + tid);
    }
  }
}

std::once_flag g_once;
cudaError_t g_init_err = cudaSuccess;
int g_sms = 0;

// the kernels at each cluster size the cluster path launches (hp / 64)
const void* cluster_kernel(int ctas) {
  switch (ctas) {
    case 2: return reinterpret_cast<const void*>(fused_mlp_bf16_kernel_cluster<2>);
    case 4: return reinterpret_cast<const void*>(fused_mlp_bf16_kernel_cluster<4>);
    case 6: return reinterpret_cast<const void*>(fused_mlp_bf16_kernel_cluster<6>);
    case 8: return reinterpret_cast<const void*>(fused_mlp_bf16_kernel_cluster<8>);
    default: return nullptr;
  }
}

// the shared-memory attribute of the kernels and the SM count, once per
// library load
cudaError_t init_once() {
  std::call_once(g_once, [] {
    const void* kernels[] = {reinterpret_cast<const void*>(fused_mlp_bf16_kernel),
                             cluster_kernel(2), cluster_kernel(4), cluster_kernel(6),
                             cluster_kernel(8)};
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
  if (features <= 0 || features > kMaxFeatures || hidden <= 0) return false;
  const Layout L = make_layout(features, hidden);
  return L.stages >= 2 && L.total <= kSmemLimit;
}

cudaError_t launch_cluster(const __nv_bfloat16* x, const unsigned char* wstream,
                           const float* vec, const float* b3, float* proba, float* logits,
                           int batch, int features, int hidden, cudaStream_t stream) {
  cudaError_t err = init_once();
  if (err != cudaSuccess) return err;
  const ClusterLayout C = cluster_layout(features, hidden);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C.ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((batch + kTileRows - 1) / kTileRows * C.ctas));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = C.total;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&x, &wstream, &vec, &b3, &proba, &logits, &batch, &features, &hidden};
  err = cudaLaunchKernelExC(&cfg, cluster_kernel(C.ctas), args);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace

// out: k1p, hp, chunks, stages, resident, wide, shared-memory bytes of the
// persistent grid's block; returns 0, or 1 for a shape the kernel does not
// take
extern "C" int ccfd_fused_mlp_bf16_plan(int features, int hidden, int* out) {
  if (!takes(features, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(features, hidden);
  out[0] = L.k1p;
  out[1] = L.hp;
  out[2] = L.chunks;
  out[3] = L.stages;
  out[4] = L.stages == L.chunks;
  out[5] = L.wide;
  out[6] = static_cast<int>(L.total);
  return 0;
}

// the blocks a launch of ``batch`` rows runs on the persistent grid (0
// before the first launch has read the SM count): the wide layout's
// scratch holds one h1 tile each
extern "C" int ccfd_fused_mlp_bf16_blocks(int batch) {
  if (init_once() != cudaSuccess) return 0;
  const int tiles = (batch + kTileRows - 1) / kTileRows;
  return tiles < g_sms ? tiles : g_sms;
}

// h1_scratch: the wide layout's per-block h1 tiles, scratch_bytes long (at
// least blocks * 64 * hp * 2); unused, and may be null, up to H = 1,024 and
// on the cluster. launch: 0 the persistent grid (any batch), 1 the cluster
// (where hp / 64 <= kClusterMaxCtas)
extern "C" int ccfd_fused_mlp_bf16(const void* x, const void* wstream, const void* vec,
                                   const void* b3, void* proba, void* logits, void* h1_scratch,
                                   long long scratch_bytes, int batch, int features, int hidden,
                                   int launch, void* stream) {
  if (batch <= 0 || !takes(features, hidden) || launch < 0 || launch > 1 ||
      (launch == 1 && cluster_layout(features, hidden).ctas > kClusterMaxCtas))
    return static_cast<int>(cudaErrorInvalidValue);
  if (launch == 1)
    return static_cast<int>(launch_cluster(
        static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(wstream),
        static_cast<const float*>(vec), static_cast<const float*>(b3),
        static_cast<float*>(proba), static_cast<float*>(logits), batch, features, hidden,
        static_cast<cudaStream_t>(stream)));
  const cudaError_t err = init_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Layout L = make_layout(features, hidden);
  const int tiles = (batch + kTileRows - 1) / kTileRows;
  const int blocks = tiles < g_sms ? tiles : g_sms;
  if (L.wide && (h1_scratch == nullptr ||
                 scratch_bytes < static_cast<long long>(blocks) * kTileRows * L.hp * 2))
    return static_cast<int>(cudaErrorInvalidValue);
  fused_mlp_bf16_kernel<<<blocks, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const unsigned char*>(wstream),
      static_cast<const float*>(vec), static_cast<const float*>(b3),
      static_cast<float*>(proba), static_cast<float*>(logits),
      static_cast<unsigned char*>(h1_scratch), batch, features, hidden);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ccfd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
