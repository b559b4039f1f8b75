"""PyTorch + CUDA port of the stereo SLAM frontend, for one NVIDIA H100.

The JAX package `vision_slam_frontend_tpu` beside it is the reference; this
package mirrors its layout and imports nothing of JAX or of the JAX package.
Ported: the stereo keyframe path from `Frontend.observe_image` to the saved
npz, for the ORB, BRISK, FREAK and AKAZE families and the image pyramid,
with hand-written CUDA kernels for FAST + NMS, patch extraction, Hamming
top-2 and the window gather of the TPU probe (ops/cuda_kernels.py, csrc/);
and the bundle-adjustment backend that optimizes the saved problem
(backend/, plain torch on the device).

Layout:
  geometry/  quaternion and camera model ops
  types/     SLAMProblem host containers and the BAProblem tensors
  ops/       the CUDA kernels and their plain versions, FAST, the four
             descriptor families, the pyramid, matching
  frontend/  keyframe step + host loop
  backend/   BA: residuals, LM with dense-Schur Cholesky and PCG, tracks, metrics
  io/        npz serialization; the synthetic world and BA problems (numpy)
  utils/     host quaternion helpers (numpy), the device rule, BA step checks
  cli/       command-line entry points: slam_frontend, slam_backend, evaluate
"""

__version__ = "0.1.0"
