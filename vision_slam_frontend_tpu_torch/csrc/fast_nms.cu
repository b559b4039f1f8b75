// FAST-9 corner score + strict 3x3 non-maximum suppression over a uint8 or
// float32 image (float32: the resized levels of the image pyramid).
//
// Replaces the Pallas kernel `fast_scores_nms` / `_fast_kernel`
// (vision_slam_frontend_tpu/ops/pallas_kernels.py). Same contract: the score
// of a pixel is the max over both polarities and the 16 start positions of
// the minimum signed (ring - centre) difference along a 9-pixel arc of the
// radius-3 Bresenham ring; `suppressed` keeps a score only where it is
// strictly greater than all 8 neighbours (-inf elsewhere). The image is
// zero-padded outside its bounds, as the Pallas kernel pads it.
//
// What bounds it on the H100: the min/max instructions, which issue at 64
// per clock per SM (half the FP32 add rate). It reads H*W pixels (1 or 4
// bytes each) and writes 8*H*W bytes (two f32 maps, 2.5 MB at 640x480), which
// the card moves in under a microsecond.
// Design:
//   - Arc min/max by doubling: the min (and max) over the 9-pixel arc at each
//     of the 16 starts from mins over 2, 4 and 8 neighbours, 128 min/max per
//     pixel in place of 256; exact, since min and max are exact in any order.
//     Each ring - centre difference is still one rounded f32 subtraction, as
//     in the reference.
//   - A uint8 image scores two pixels per instruction in half2: its
//     differences are integers in [-255, 255], exact in fp16, so min, max and
//     negation give the float path's values. Float32 levels stay in float.
//   - One block per 64 x 16 tile of scores (62 x 14 outputs: the scores carry
//     a 1-pixel ring for the NMS, 18% recomputed). The tile and its 3-pixel
//     ring halo load once into shared memory as float (a uint8 converts
//     exactly). Each of the 256 threads scores a run of 4 pixels down one
//     column, holding the 10 x 7 window its rings read in registers, so a
//     pixel costs 14.5 shared loads in place of 17. The scores stay in shared
//     memory for the NMS.
//   - Blocks: 11 x 35 = 385 at 640x480, 8 x 25 = 200 at 457x343; at 4
//     resident blocks per SM (registers) each is one wave over 132 SMs.
// ptxas (nvcc 12.8, sm_90a): uint8 61 registers, float32 64, 10,256 bytes of
// static shared memory, no spills (chip_smoke.py phase 2 prints the current
// figures).
// (The max-of-min chain in int, built with nvcc 12.9 for sm_90a at ptxas -O1
// or above, returned max(ring - centre) instead; the float form is right at
// every level.)

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kScoreW = 64;               // score columns per block: threads in x
constexpr int kScoreH = 16;               // score rows per block
constexpr int kRun = 4;                   // score rows per thread
constexpr int kOutW = kScoreW - 2;        // outputs per block: the scores less
constexpr int kOutH = kScoreH - 2;        //   their 1-pixel NMS ring
constexpr int kRing = 3;                  // ring radius
constexpr int kTileW = kScoreW + 2 * kRing;  // 70
constexpr int kTileH = kScoreH + 2 * kRing;  // 22
constexpr int kWin = kRun + 2 * kRing;       // window rows one thread reads

// Ring pixel s of the pixel whose centre is w[P + 3][3] is w[P + ring_row(s)]
// [ring_col(s)]: the radius-3 ring clockwise from 12 o'clock (ops/fast.py
// RING_OFFSETS) as (dy + 3, dx + 3), one nibble per s (scalars, so that the
// unrolled loops fold them into register indices).
constexpr unsigned long long kRingRows = 0x0123456665432100ull;  // 0,0,1,2,3,4,5,6,6,6,5,4,3,2,1,0
constexpr unsigned long long kRingCols = 0x2100012345666543ull;  // 3,4,5,6,6,6,5,4,3,2,1,0,0,0,1,2
__device__ __forceinline__ constexpr int ring_row(int s) { return static_cast<int>((kRingRows >> (4 * s)) & 15); }
__device__ __forceinline__ constexpr int ring_col(int s) { return static_cast<int>((kRingCols >> (4 * s)) & 15); }

__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ float vneg(float a) { return -a; }
__device__ __forceinline__ __half2 vmin(__half2 a, __half2 b) { return __hmin2(a, b); }
__device__ __forceinline__ __half2 vmax(__half2 a, __half2 b) { return __hmax2(a, b); }
__device__ __forceinline__ __half2 vneg(__half2 a) { return __hneg2(a); }

// The FAST-9 score from the 16 ring - centre differences: the max over the
// 16 arc starts of max(min over the arc, -max over the arc), the arcs' min
// and max by doubling (spans 2, 4, then 4 + 4 + 1).
template <typename V>
__device__ __forceinline__ V arc_score(const V (&d)[16], V best) {
  V lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    lo2[s] = vmin(d[s], d[(s + 1) & 15]);
    hi2[s] = vmax(d[s], d[(s + 1) & 15]);
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    lo4[s] = vmin(lo2[s], lo2[(s + 2) & 15]);
    hi4[s] = vmax(hi2[s], hi2[(s + 2) & 15]);
  }
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    const V lo = vmin(vmin(lo4[s], lo4[(s + 4) & 15]), d[(s + 8) & 15]);
    const V hi = vmax(vmax(hi4[s], hi4[(s + 4) & 15]), d[(s + 8) & 15]);
    // Bright arc: min over the arc of (ring - centre) = lo.
    // Dark arc: min over the arc of (centre - ring) = -hi.
    best = vmax(best, vmax(lo, vneg(hi)));
  }
  return best;
}

// Scores of the run's pixels P.. of one thread (centres w[P + 3][3], ...).
// A float32 image: one pixel at a time in float. A uint8 image: two pixels
// at a time in half2, whose differences are integers in [-255, 255] and so
// exact in fp16, at two values per min/max instruction.
template <bool kHalf2, int P>
__device__ __forceinline__ void score_run(const float (&w)[kWin][7], float (*score)[kScoreW], int sy, int sx) {
  if constexpr (kHalf2) {
    const float c0 = w[P + 3][3];
    const float c1 = w[P + 4][3];
    __half2 d[16];
#pragma unroll
    for (int s = 0; s < 16; ++s)
      d[s] = __floats2half2_rn(w[P + ring_row(s)][ring_col(s)] - c0, w[P + 1 + ring_row(s)][ring_col(s)] - c1);
    const __half2 best = arc_score(d, __float2half2_rn(-INFINITY));
    score[sy + P][sx] = __low2float(best);
    score[sy + P + 1][sx] = __high2float(best);
    if constexpr (P + 2 < kRun) score_run<kHalf2, P + 2>(w, score, sy, sx);
  } else {
    const float c = w[P + 3][3];
    float d[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) d[s] = w[P + ring_row(s)][ring_col(s)] - c;
    score[sy + P][sx] = arc_score(d, -INFINITY);
    if constexpr (P + 1 < kRun) score_run<kHalf2, P + 1>(w, score, sy, sx);
  }
}

template <typename T>
__global__ void __launch_bounds__(kScoreW * kScoreH / kRun)
    fast_nms_kernel(const T* __restrict__ img, int H, int W, float* __restrict__ raw, float* __restrict__ sup) {
  __shared__ float tile[kTileH][kTileW];
  __shared__ float score[kScoreH][kScoreW];
  const int x0 = blockIdx.x * kOutW;  // first output pixel of the block
  const int y0 = blockIdx.y * kOutH;
  const int tid = threadIdx.y * kScoreW + threadIdx.x;
  constexpr int kThreads = kScoreW * kScoreH / kRun;

  // tile[ty][tx] is image pixel (y0 - 4 + ty, x0 - 4 + tx), zero outside.
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int gy = y0 - kRing - 1 + ty;
    const int gx = x0 - kRing - 1 + tx;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? static_cast<float>(img[static_cast<size_t>(gy) * W + gx])
                       : 0.0f;
  }
  __syncthreads();

  // Score (sy, sx) is image pixel (y0 - 1 + sy, x0 - 1 + sx); its ring
  // reads tile rows sy .. sy + 6 and columns sx .. sx + 6.
  {
    const int sx = threadIdx.x;
    const int sy = threadIdx.y * kRun;
    float w[kWin][7];
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
#pragma unroll
      for (int c = 0; c < 7; ++c) w[j][c] = tile[sy + j][sx + c];
    }
    score_run<sizeof(T) == 1, 0>(w, score, sy, sx);
  }
  __syncthreads();

  const int sx = threadIdx.x;
  const int gx = x0 - 1 + sx;
  if (sx == 0 || sx == kScoreW - 1 || gx >= W) return;
  for (int sy = 1 + threadIdx.y; sy <= kOutH; sy += kScoreH / kRun) {
    const int gy = y0 - 1 + sy;
    if (gy >= H) break;
    const float c = score[sy][sx];
    float m = -INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dy != 0 || dx != 0) m = fmaxf(m, score[sy + dy][sx + dx]);
      }
    }
    const size_t o = static_cast<size_t>(gy) * W + gx;
    raw[o] = c;
    sup[o] = c > m ? c : -INFINITY;
  }
}

}  // namespace

// is_float: 0 for a uint8 image, 1 for a float32 one.
extern "C" int vsf_fast_scores_nms(const void* img, int is_float, int H, int W, void* raw,
                                   void* sup, void* stream) {
  const dim3 block(kScoreW, kScoreH / kRun);
  const dim3 grid((W + kOutW - 1) / kOutW, (H + kOutH - 1) / kOutH);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(raw);
  float* o = static_cast<float*>(sup);
  if (is_float) {
    fast_nms_kernel<float><<<grid, block, 0, s>>>(static_cast<const float*>(img), H, W, r, o);
  } else {
    fast_nms_kernel<uint8_t><<<grid, block, 0, s>>>(static_cast<const uint8_t*>(img), H, W, r, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vsf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
