// Square patch extraction around keypoints from a stack of image planes.
//
// Replaces the Pallas kernel `extract_patches_vmem` / `_extract_patches_kernel`
// (vision_slam_frontend_tpu/ops/pallas_kernels.py). Same contract: patch k of
// plane c is the ps x ps window whose top-left corner is
// clip(round(kp) - ps // 2, 0, dim - ps), with round-half-to-even, written
// row-major to out[k, c, :]. The values are copied bit for bit, so the kernel
// is the same for f16 and f32 planes (the ORB path reads f16).
//
// What bounds it on the H100: bytes. K * C * ps^2 elements are written once
// (10.4 MB for FREAK's 512 x 7 x 27^2 f32, 0.98 MB for ORB's f16) and the
// planes are read through L2, where overlapping patches meet. A patch row is
// only ps elements, so what keeps a gather from that bound is latency (a
// thread that waits on each load before its store) and index arithmetic per
// element. Design:
// - A block owns one contiguous range of the output, `rows_per_block` patch
//   rows: whole keypoints (several where one keypoint's patches are small,
//   as many as keep the grid at about two blocks per SM, so K=512 is one
//   wave), or part of one keypoint where its patches exceed the tile.
// - Its threads first write a table of where each of its patch rows starts
//   in the planes: the divisions are per patch row, none per element.
// - Lanes walk a patch row (in chunks of 32 columns where ps > 32) and warps
//   walk the rows. Each thread issues kBatch loads into registers before its
//   first store. The stores go to a shared-memory tile laid out at the
//   output range's 16-byte phase, and the block then writes the range as
//   16-byte vectors, with scalar stores only at its unaligned head and tail.
// The loads go through registers: neither TMA nor cp.async fits them, since
// a plane's pitch (914 B for a 457-wide f16 level) and base (a view at an
// element offset) need not be 16-byte aligned and an f16 row may start at an
// odd column. The start rounds with __float2int_rn (half to even, never
// roundf): the sub-pixel fit clips its offset to +-0.5, so keypoints sit
// exactly on .5.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;              // loads in flight per thread before its stores
constexpr int kTileBytes = 24 * 1024;  // staged output per block: several blocks per SM
constexpr int kMaxRows = 512;          // patch rows per block (the row table)
constexpr int kBlocksPerSm = 2;        // the grid K=512 and its neighbours aim at

// kWide: ps > 32, so a patch row takes several chunks of 32 columns.
template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
extract_patches_kernel(const T* __restrict__ planes, int C, int H, int W,
                       const float* __restrict__ kps, int K, int ps, int rows_per_block,
                       T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long row_src[kMaxRows];  // where each of the block's patch rows starts in `planes`

  const int kp_rows = C * ps;  // output rows of one keypoint
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int nrows = static_cast<int>(min(static_cast<long long>(rows_per_block),
                                         static_cast<long long>(K) * kp_rows - row0));
  const int k0 = static_cast<int>(row0 / kp_rows);  // once per block
  const int rem0 = static_cast<int>(row0 - static_cast<long long>(k0) * kp_rows);
  const size_t plane = static_cast<size_t>(H) * W;
  for (int i = threadIdx.x; i < nrows; i += kThreads) {  // once per patch row
    const int dk = (rem0 + i) / kp_rows;
    const int c = (rem0 + i - dk * kp_rows) / ps;
    const int py = rem0 + i - dk * kp_rows - c * ps;
    const int k = k0 + dk;
    const int sx = min(max(__float2int_rn(kps[2 * k]) - ps / 2, 0), W - ps);
    const int sy = min(max(__float2int_rn(kps[2 * k + 1]) - ps / 2, 0), H - ps);
    row_src[i] = static_cast<long long>(c * plane + static_cast<size_t>(sy + py) * W + sx);
  }
  T* dst = out + row0 * ps;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
  T* tile = reinterpret_cast<T*>(smem) + phase;  // tile[i] and dst[i] share their 16-byte phase
  __syncthreads();

  // Lanes along a patch row, in chunks of 32 columns; warps down the rows,
  // each thread with kBatch loads in flight before it stores them.
  const int warp = threadIdx.x >> 5;
  for (int x0 = 0; x0 < (kWide ? ps : 1); x0 += 32) {
    const int x = x0 + (threadIdx.x & 31);
    for (int r0 = warp; r0 < nrows; r0 += kWarps * kBatch) {
      T v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = r0 + j * kWarps;
        v[j] = (r < nrows && x < ps) ? planes[row_src[r] + x] : T(0);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = r0 + j * kWarps;
        if (r < nrows && x < ps) tile[r * ps + x] = v[j];
      }
    }
  }
  __syncthreads();

  const int n = nrows * ps;
  const int head = min(n, (kVec - phase) & (kVec - 1));
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = tile[i];
  const int nvec = (n - head) / kVec;
  const uint4* src4 = reinterpret_cast<const uint4*>(tile + head);
  uint4* dst4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += kThreads) dst4[i] = src4[i];
  for (int i = head + nvec * kVec + threadIdx.x; i < n; i += kThreads) dst[i] = tile[i];
}

template <typename T>
int launch(const void* planes, int C, int H, int W, const void* kps, int K, int ps, void* out,
           cudaStream_t stream) {
  int dev = 0, sms = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long long row_bytes = static_cast<long long>(ps) * sizeof(T);
  const long long kp_rows = static_cast<long long>(C) * ps;
  long long rows;
  if (kp_rows * row_bytes <= kTileBytes && kp_rows <= kMaxRows) {
    // Whole keypoints: as many as the tile and the row table hold, but no
    // more than keep about kBlocksPerSm blocks on every SM.
    const long long by_fill = (K + static_cast<long long>(kBlocksPerSm) * sms - 1) /
                              (static_cast<long long>(kBlocksPerSm) * sms);
    rows = kp_rows * std::max(1LL, std::min({kTileBytes / (kp_rows * row_bytes), kMaxRows / kp_rows, by_fill}));
  } else {
    // Part of one keypoint; a block's rows then meet at most two keypoints.
    rows = std::max(1LL, std::min(kTileBytes / row_bytes, static_cast<long long>(kMaxRows)));
  }
  const long long smem = rows * row_bytes + 16;
  if (smem + static_cast<long long>(sizeof(long long)) * kMaxRows > smem_max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = ps > 32 ? extract_patches_kernel<T, true> : extract_patches_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (K * kp_rows + rows - 1) / rows;
  kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(planes), C, H, W, static_cast<const float*>(kps), K, ps,
      static_cast<int>(rows), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vsf_extract_patches(const void* planes, int elem_bytes, int C, int H, int W,
                                   const void* kps, int K, int ps, void* out, void* stream) {
  if (K <= 0 || C <= 0 || ps <= 0 || ps > H || ps > W) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return launch<uint16_t>(planes, C, H, W, kps, K, ps, out, s);
  if (elem_bytes == 4) return launch<uint32_t>(planes, C, H, W, kps, K, ps, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
