"""PyTorch + CUDA port of the stereo SLAM frontend, for one NVIDIA H100.

The JAX package `vision_slam_frontend_tpu` beside it is the reference; this
package mirrors its layout and public names (tests/test_torch_api.py holds
them name by name) and imports nothing of JAX or of the JAX package.
Ported: the stereo keyframe path from `Frontend.observe_image` to the saved
npz for the five descriptor families (ORB, BRISK, FREAK, AKAZE, SIFT) and
the image pyramid, with hand-written CUDA kernels for FAST + NMS, patch
extraction, Hamming top-2 and the window gather of the TPU probe
(ops/cuda_kernels.py, csrc/); the bundle-adjustment backend, local BA and
merge (backend/, plain torch on the device); segment-parallel and sharded BA
(parallel/); every input (synthetic, ROS bags, KITTI, EuRoC) and export; and
the tools: debug images, the live viewer, stage profiling and checkified.

Layout:
  geometry/  quaternion, SE(3) and camera model ops
  types/     SLAMProblem host containers and the BAProblem tensors
  ops/       the CUDA kernels and their plain versions, FAST, the five
             descriptor families, the pyramid, matching
  frontend/  keyframe step + host loop, checkpoints
  backend/   BA: residuals, LM with dense-Schur Cholesky and PCG, tracks,
             metrics, windowed local BA, merge
  parallel/  segment BA and observation-/landmark-sharded BA over
             torch.distributed, the collective report
  io/        npz serialization, ROS bags, KITTI, EuRoC, image decode; the
             synthetic world and BA problems (numpy)
  viz/       debug images, the live viewer, PLY and HTML export
  utils/     host quaternion helpers (numpy), the device rule, BA step
             checks, checkified, profiling, timing
  cli/       command-line entry points: slam_frontend, slam_backend,
             evaluate, slam_merge, bag_extract, profile_stages
"""

__version__ = "0.1.0"
