// Brute-force Hamming kNN(2) with a fused top-2, over packed binary
// descriptors, on the tensor cores.
//
// Replaces the Pallas kernel `hamming_top2_mxu` / `_hamming_top2_mxu_kernel`
// (vision_slam_frontend_tpu/ops/pallas_kernels.py), and serves the contract
// of the XOR + popcount `hamming_top2` beside it. For each query: the index of
// the nearest valid train (lowest index on ties), and the best and
// second-best distance. Invalid trains are skipped; a distance that no valid
// train supplied is 1e9, as on the reference's XLA path (ops/hamming.py
// _LARGE). Any Kq and Kt are accepted, at 8 or 16 words.
//
// Design: the TPU kernel computes the distances as one matrix product (+-1
// values on the MXU); here the tensor cores take the packed bits as they are,
// in binary products: mma.sync.m16n8k256 b1 with .and.popc gives popc(q & t)
// over 256 bits, exact in int32, and d = popc(q) + popc(t) - 2 popc(q & t).
// The (Kq, Kt) distance matrix never leaves the registers.
//   - Fragments: a b1 fragment register is 32 consecutive bits of the k axis,
//     so lane (group g, thread-in-group tg) takes words tg and tg + 4 of an
//     8-word slice: the A fragments are query rows g and g + 8 loaded as they
//     are, the B fragment train g's words straight from shared memory. No
//     unpacking. (A +-1 int8 form with m16n8k32 s8 products, expanding each
//     word in registers, measured 1.1 to 2.4x slower at the shapes PERF.md
//     lists, on an NVIDIA H100 80GB HBM3 at 700 W.)
//   - Staging: a block copies its trains (up to 512 at a time) and their
//     validity into shared memory with cp.async, every thread's copies in
//     flight together (16 bytes each: the trains must start on a 16-byte
//     boundary), while its queries load; then one pass stores each train's popcount, or a
//     value that keeps an invalid train out of the top-2.
//   - Work split: a block holds 16 queries (the mma's M) and 4 warps; warp w
//     takes every 4th 8-train tile of the block's trains. Where the queries
//     alone give fewer than 132 blocks, a thread block cluster (Hopper) of 2
//     or 4 blocks splits the train axis between its blocks: grid
//     (ceil(Kq / 16), split) of 128 threads, 32 x 4 = 128 blocks at the stereo
//     512 x 512, 320 at the window 5120 x 512, 512 at 8192 x 8192.
//   - Fused top-2: each lane keeps a running (d1, i1, d2) for its two query
//     rows over its accumulator columns, in increasing index order (strict <
//     keeps the lowest index); the four lanes of a quad merge by shuffles,
//     the warps through shared memory, and the cluster's first block merges
//     its blocks' partials through distributed shared memory. Every merge
//     compares (d, index) lexicographically, so the lowest index wins in
//     whatever order partials meet.
// What bounds it on the H100: 2 * Kq * Kt * nbits operations (0.47 us at
// 5120 x 512 x 256 taken at the int8 rate, 1,979 TOP/s: the data sheet gives
// no binary rate, which may be higher, so this floor is an estimate) against
// bytes that fit in L2 (0.07 us at 3.35 TB/s). At the frontend's sizes the
// fixed cost of a launch, one round trip to memory and the block and cluster
// barriers (about 5 us, the stereo 512 x 512 time on an NVIDIA H100 80GB
// HBM3 at 700 W), not the rate.
// ptxas (nvcc 12.8, sm_90a): 8 words 38 registers, 19,904 bytes of static
// shared memory; 16 words 50 registers, 36,288 bytes; no spills
// (chip_smoke.py phase 2 prints the current figures).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;        // queries per block: the mma's M
constexpr int kWarps = 4;        // warps per block
constexpr int kChunk = 512;      // trains staged in shared memory at a time
constexpr int kMaxSplit = 4;     // blocks per cluster, splitting the train axis, at most
constexpr int kMinBlocks = 132;  // split the train axis until the grid covers the SMs
constexpr int kEmpty = 1 << 30;  // no valid train yet; reported as 1e9

struct Top2 {
  int d1, i1, d2;
};

// One more column in increasing index order: strict < keeps the lowest index.
__device__ __forceinline__ void push(Top2& a, int d, int i) {
  if (d < a.d1) {
    a.d2 = a.d1;
    a.d1 = d;
    a.i1 = i;
  } else if (d < a.d2) {
    a.d2 = d;
  }
}

// Merge two partials over disjoint train sets; (d, index) compare
// lexicographically, so the result does not depend on the order of merges.
__device__ __forceinline__ void merge(Top2& a, const Top2& b) {
  if (b.d1 < a.d1 || (b.d1 == a.d1 && b.i1 < a.i1)) {
    a.d2 = min(a.d1, b.d2);
    a.d1 = b.d1;
    a.i1 = b.i1;
  } else {
    a.d2 = min(a.d2, b.d1);
  }
}

__device__ __forceinline__ Top2 shfl_xor(const Top2& a, int mask) {
  return {__shfl_xor_sync(0xffffffffu, a.d1, mask), __shfl_xor_sync(0xffffffffu, a.i1, mask),
          __shfl_xor_sync(0xffffffffu, a.d2, mask)};
}

// c += popc(a & b) over k for the m16n8k256 tile (a: 16 x 256 bits, row
// major; b: 256 x 8 bits, column major).
__device__ __forceinline__ void mma_b1(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// Stage trains n0 .. n0 + count - 1 (packed words and validity) in shared
// memory: every thread's 16-byte copies in flight at once (the wrapper
// requires 16-byte-aligned trains). The caller waits (cp.async.wait_all) and
// syncs the block before reading.
template <int WORDS>
__device__ __forceinline__ void stage_chunk(const uint32_t* __restrict__ t, const uint8_t* __restrict__ valid,
                                            int n0, int count, uint32_t* stage, uint8_t* stage_valid) {
  const uint32_t* src = t + static_cast<size_t>(n0) * WORDS;
  for (int i = threadIdx.x; i < count * WORDS / 4; i += blockDim.x) cp_async16(stage + 4 * i, src + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) stage_valid[i] = i < count && valid[n0 + i];
}

// Grid (ceil(Kq / 16), split), launched in clusters of (1, split, 1) where
// split > 1 (a launch without clusters is a cluster of one block).
template <int WORDS>
__global__ void __launch_bounds__(kWarps * 32)
    hamming_top2_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                        const uint8_t* __restrict__ valid, int Kq, int Kt, int* __restrict__ idx_out,
                        float* __restrict__ d1_out, float* __restrict__ d2_out) {
  // An invalid train's popcount: its distance is then above kEmpty and never
  // enters a top-2.
  constexpr int kInvalid = kEmpty + 1024;
  __shared__ __align__(16) uint32_t stage[kChunk * WORDS];
  __shared__ uint8_t stage_valid[kChunk];
  __shared__ __align__(8) int stage_pop[kChunk];
  __shared__ Top2 warp_part[kWarps][kRows];
  __shared__ Top2 block_part[kRows];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the mma's group: query rows g and g + 8, train column g
  const int tg = lane & 3;  // thread in group: accumulator columns 2 * tg, 2 * tg + 1
  const int row0 = blockIdx.x * kRows;

  // This block's share of the train axis, in whole 8-train tiles.
  const int tiles = (Kt + 7) / 8;
  const int per_block = (tiles + gridDim.y - 1) / gridDim.y;
  const int n_begin = min(Kt, static_cast<int>(blockIdx.y) * per_block * 8);
  const int n_end = min(Kt, n_begin + per_block * 8);

  // The first chunk's copy is in flight while the queries load: A fragments
  // of rows g and g + 8 (words tg and tg + 4 of each 8-word slice), and each
  // row's popcount, summed over the quad.
  stage_chunk<WORDS>(t, valid, n_begin, min(kChunk, n_end - n_begin), stage, stage_valid);
  uint32_t a[WORDS / 8][4];
  int pq0 = 0, pq1 = 0;
  {
    const int r0 = row0 + g;
    const int r1 = r0 + 8;
#pragma unroll
    for (int k = 0; k < WORDS / 8; ++k) {
      a[k][0] = r0 < Kq ? q[static_cast<size_t>(r0) * WORDS + 8 * k + tg] : 0u;
      a[k][1] = r1 < Kq ? q[static_cast<size_t>(r1) * WORDS + 8 * k + tg] : 0u;
      a[k][2] = r0 < Kq ? q[static_cast<size_t>(r0) * WORDS + 8 * k + tg + 4] : 0u;
      a[k][3] = r1 < Kq ? q[static_cast<size_t>(r1) * WORDS + 8 * k + tg + 4] : 0u;
      pq0 += __popc(a[k][0]) + __popc(a[k][2]);
      pq1 += __popc(a[k][1]) + __popc(a[k][3]);
    }
    pq0 += __shfl_xor_sync(0xffffffffu, pq0, 1);
    pq1 += __shfl_xor_sync(0xffffffffu, pq1, 1);
    pq0 += __shfl_xor_sync(0xffffffffu, pq0, 2);
    pq1 += __shfl_xor_sync(0xffffffffu, pq1, 2);
  }
  Top2 top0 = {kEmpty, 0, kEmpty};  // query row g
  Top2 top1 = {kEmpty, 0, kEmpty};  // query row g + 8
  for (int n0 = n_begin; n0 < n_end; n0 += kChunk) {
    const int count = min(kChunk, n_end - n0);
    if (n0 != n_begin) stage_chunk<WORDS>(t, valid, n0, count, stage, stage_valid);
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    // Each staged train's popcount (kInvalid for an invalid one or a slot
    // past the chunk's end).
    for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
      int p = 0;
      if (stage_valid[i]) {
        const uint4* row = reinterpret_cast<const uint4*>(stage + i * WORDS);
#pragma unroll
        for (int w = 0; w < WORDS / 4; ++w) {
          const uint4 v = row[w];
          p += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        }
      } else {
        p = kInvalid;
      }
      stage_pop[i] = p;
    }
    __syncthreads();

    // Warp w takes every kWarps-th 8-train tile of the chunk.
#pragma unroll 1
    for (int tile = warp; tile * 8 < count; tile += kWarps) {
      const uint32_t* row = stage + (tile * 8 + g) * WORDS;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < WORDS / 8; ++k) {
        mma_b1(acc, a[k][0], a[k][1], a[k][2], a[k][3], row[8 * k + tg], row[8 * k + tg + 4]);
      }
      const int c = tile * 8 + 2 * tg;  // the chunk's column of acc[0]
      const int2 pt = *reinterpret_cast<const int2*>(stage_pop + c);
      push(top0, pq0 + pt.x - 2 * acc[0], n0 + c);
      push(top0, pq0 + pt.y - 2 * acc[1], n0 + c + 1);
      push(top1, pq1 + pt.x - 2 * acc[2], n0 + c);
      push(top1, pq1 + pt.y - 2 * acc[3], n0 + c + 1);
    }
    __syncthreads();  // the chunk is read before the next one overwrites it
  }

  // The quad's four lanes hold one row's partials over disjoint columns;
  // then the block's warps; then the cluster's blocks.
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    merge(top0, shfl_xor(top0, m));
    merge(top1, shfl_xor(top1, m));
  }
  if (tg == 0) {
    warp_part[warp][g] = top0;
    warp_part[warp][g + 8] = top1;
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    Top2 best = warp_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) merge(best, warp_part[w][threadIdx.x]);
    block_part[threadIdx.x] = best;
  }
  cluster.sync();  // every block's partials written and visible to the cluster
  if (cluster.block_rank() == 0 && threadIdx.x < kRows) {
    const int r = threadIdx.x;
    Top2 best = block_part[r];
    Top2 remote[kMaxSplit - 1];
#pragma unroll
    for (int b = 1; b < kMaxSplit; ++b) {
      if (b < static_cast<int>(gridDim.y)) remote[b - 1] = cluster.map_shared_rank(block_part, b)[r];
    }
#pragma unroll
    for (int b = 1; b < kMaxSplit; ++b) {
      if (b < static_cast<int>(gridDim.y)) merge(best, remote[b - 1]);
    }
    if (row0 + r < Kq) {
      idx_out[row0 + r] = best.i1;
      d1_out[row0 + r] = best.d1 == kEmpty ? 1e9f : static_cast<float>(best.d1);
      d2_out[row0 + r] = best.d2 == kEmpty ? 1e9f : static_cast<float>(best.d2);
    }
  }
  cluster.sync();  // the other blocks keep their shared memory until it is read
}

template <int WORDS>
cudaError_t launch(const uint32_t* q, const uint32_t* t, const uint8_t* valid, int Kq, int Kt, int* idx,
                   float* d1, float* d2, cudaStream_t stream) {
  const int row_tiles = (Kq + kRows - 1) / kRows;
  int split = 1;
  while (split < kMaxSplit && row_tiles * split < kMinBlocks) split *= 2;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = split;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(row_tiles, split);
  config.blockDim = dim3(kWarps * 32);
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = split > 1 ? 1 : 0;  // an unsplit grid launches without clusters
  return cudaLaunchKernelEx(&config, hamming_top2_kernel<WORDS>, q, t, valid, Kq, Kt, idx, d1, d2);
}

}  // namespace

extern "C" int vsf_hamming_top2(const void* q, const void* t, const void* valid, int Kq, int Kt,
                                int words, void* idx, void* d1, void* d2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint32_t*>(q);
  const auto* tp = static_cast<const uint32_t*>(t);
  const auto* vp = static_cast<const uint8_t*>(valid);
  auto* ip = static_cast<int*>(idx);
  auto* d1p = static_cast<float*>(d1);
  auto* d2p = static_cast<float*>(d2);
  cudaError_t err;
  if (words == 8) {
    err = launch<8>(qp, tp, vp, Kq, Kt, ip, d1p, d2p, s);
  } else if (words == 16) {
    err = launch<16>(qp, tp, vp, Kq, Kt, ip, d1p, d2p, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
