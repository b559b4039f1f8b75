// Brute-force Hamming kNN(2) with a fused running top-2, over packed binary
// descriptors.
//
// Replaces the Pallas kernel `hamming_top2_mxu` / `_hamming_top2_mxu_kernel`
// (vision_slam_frontend_tpu/ops/pallas_kernels.py), and serves the contract
// of the XOR + popcount `hamming_top2` beside it with that same arithmetic.
// For each query: the index of the nearest valid train (lowest index on
// ties), and the best and second-best distance. Invalid trains are skipped;
// a distance that no valid train supplied is 1e9, as on the reference's XLA
// path (ops/hamming.py _LARGE). Any Kq and Kt are accepted.
//
// What bounds it on the H100: Kq * Kt * words XOR + popcount pairs (21 M at
// the window's 5120 x 512 x 8), integer ALU work on data that fits in shared
// memory; the (Kq, Kt) distance matrix is never written. Design: one thread
// per query holds its descriptor in registers; the block stages trains
// through shared memory in chunks of 256, where every thread of a warp reads
// the same train word (a broadcast). Strict `<` in the running merge keeps
// the lowest index on ties. One warp per block gives the 512-query stereo
// call 16 blocks and the window call 160.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kChunk = 256;
constexpr int kEmpty = 1 << 30;  // no valid train yet; reported as 1e9

template <int WORDS>
__global__ void hamming_top2_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                                    const uint8_t* __restrict__ valid, int Kq, int Kt,
                                    int* __restrict__ idx_out, float* __restrict__ d1_out,
                                    float* __restrict__ d2_out) {
  __shared__ uint32_t ts[kChunk * WORDS];
  __shared__ uint8_t tv[kChunk];
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = qi < Kq;
  uint32_t qw[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) qw[w] = active ? q[static_cast<size_t>(qi) * WORDS + w] : 0u;

  int d1 = kEmpty, d2 = kEmpty, i1 = 0;
  for (int base = 0; base < Kt; base += kChunk) {
    const int n = min(kChunk, Kt - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * WORDS; i += blockDim.x)
      ts[i] = t[static_cast<size_t>(base) * WORDS + i];
    for (int i = threadIdx.x; i < n; i += blockDim.x) tv[i] = valid[base + i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (!tv[j]) continue;
      int d = 0;
#pragma unroll
      for (int w = 0; w < WORDS; ++w) d += __popc(qw[w] ^ ts[j * WORDS + w]);
      if (d < d1) {
        d2 = d1;
        d1 = d;
        i1 = base + j;
      } else if (d < d2) {
        d2 = d;
      }
    }
  }
  if (active) {
    idx_out[qi] = i1;
    d1_out[qi] = d1 == kEmpty ? 1e9f : static_cast<float>(d1);
    d2_out[qi] = d2 == kEmpty ? 1e9f : static_cast<float>(d2);
  }
}

}  // namespace

extern "C" int vsf_hamming_top2(const void* q, const void* t, const void* valid, int Kq, int Kt,
                                int words, void* idx, void* d1, void* d2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Kq + kThreads - 1) / kThreads);
  const auto* qp = static_cast<const uint32_t*>(q);
  const auto* tp = static_cast<const uint32_t*>(t);
  const auto* vp = static_cast<const uint8_t*>(valid);
  auto* ip = static_cast<int*>(idx);
  auto* d1p = static_cast<float*>(d1);
  auto* d2p = static_cast<float*>(d2);
  if (words == 8) {
    hamming_top2_kernel<8><<<grid, kThreads, 0, s>>>(qp, tp, vp, Kq, Kt, ip, d1p, d2p);
  } else if (words == 16) {
    hamming_top2_kernel<16><<<grid, kThreads, 0, s>>>(qp, tp, vp, Kq, Kt, ip, d1p, d2p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
