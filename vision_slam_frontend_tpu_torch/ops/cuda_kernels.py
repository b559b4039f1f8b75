"""The port's hand-written CUDA kernels, with their plain versions.

Each wrapper takes the TPU kernel's contract (ops/pallas_kernels.py in the
JAX package) and checks device, dtype, shape and contiguity. On a CUDA tensor
it launches its kernel from `csrc/` on the current stream, raising if the
launch fails; on a CPU tensor it runs the plain PyTorch version beside it.
There is no other fallback.

`LAUNCHES` counts kernel launches per wrapper (plain-version calls and calls
captured into a CUDA graph do not count), so a run can show that its path
went through the kernels. `CAPTURED` counts the calls recorded into CUDA
graphs instead, and `REPLAYED` the kernels that replays of graphs made by
utils/cuda_graph.CapturedCall ran (each replay adds its graph's captured
count); `runs()` is what ran either way.

Kernels (source, TPU kernel replaced):
  fast_scores_nms  csrc/fast_nms.cu         pallas_kernels.fast_scores_nms
  extract_patches  csrc/extract_patches.cu  pallas_kernels.extract_patches_vmem
  hamming_top2     csrc/hamming_top2.cu     pallas_kernels.hamming_top2_mxu and
                                            pallas_kernels.hamming_top2
  patch_windows    csrc/patch_windows.cu    probe_kernel_variants.run_variant
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LAUNCHES = {"fast_scores_nms": 0, "extract_patches": 0, "hamming_top2": 0, "patch_windows": 0}
CAPTURED = dict.fromkeys(LAUNCHES, 0)
REPLAYED = dict.fromkeys(LAUNCHES, 0)

# The FAST ring (ops/fast.py RING_OFFSETS): radius-3 Bresenham circle,
# clockwise from 12 o'clock, as (dy, dx).
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CAPTURED, REPLAYED):
        for name in counts:
            counts[name] = 0


def runs() -> dict:
    """Kernels run per wrapper: stream launches plus graph replays."""
    return {name: LAUNCHES[name] + REPLAYED[name] for name in LAUNCHES}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry `vsf_<name>` on `device`'s current stream."""
    from vision_slam_frontend_tpu_torch.ops._build import library

    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"vsf_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: error {err} "
            f"({lib.vsf_error_string(err).decode()})"
        )
    # A call made while the stream is captured into a CUDA graph records the
    # kernel and launches nothing; the graph's replays are not this wrapper's.
    if torch.cuda.is_current_stream_capturing():
        CAPTURED[name] += 1
    else:
        LAUNCHES[name] += 1


def _dispatch_device(t: torch.Tensor, name: str) -> bool:
    """True for CUDA (launch the kernel), False for CPU (plain version)."""
    if t.device.type == "cuda":
        _require(t.is_contiguous(), f"{name}: input must be contiguous")
        return True
    _require(t.device.type == "cpu", f"{name}: unsupported device {t.device}")
    return False


# ---------------------------------------------------------------------------
# B1: FAST-9 score + strict NMS
# ---------------------------------------------------------------------------


def fast_scores_nms(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) uint8 or float32 image -> (raw, suppressed) (H, W) float32
    score maps.

    `raw` is the FAST-9 score of every pixel with the image zero-padded
    outside its bounds; `suppressed` is `raw` where it is strictly greater
    than all 8 neighbours and -inf elsewhere. Callers mask the 3-pixel border
    (ops/fast.fast_detect)."""
    _require(image.dim() == 2 and image.dtype in (torch.uint8, torch.float32),
             f"fast_scores_nms: expected a (H, W) uint8 or float32 image, got {tuple(image.shape)} {image.dtype}")
    if not _dispatch_device(image, "fast_scores_nms"):
        return fast_scores_nms_plain(image)
    H, W = image.shape
    raw = torch.empty((H, W), dtype=torch.float32, device=image.device)
    sup = torch.empty_like(raw)
    _launch("fast_scores_nms", image.device, image.data_ptr(), int(image.dtype == torch.float32),
            H, W, raw.data_ptr(), sup.data_ptr())
    return raw, sup


def fast_scores_nms_plain(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `fast_scores_nms`: the same f32 differences,
    mins and maxes, so its output equals the kernel's bit for bit."""
    H, W = image.shape
    img = F.pad(image.to(torch.float32), (4, 4, 4, 4))  # zeros outside
    rows, cols = H + 2, W + 2  # the image plus a 1-pixel ring for the NMS
    center = img[3 : 3 + rows, 3 : 3 + cols]
    diff = torch.stack(
        [img[3 + dy : 3 + dy + rows, 3 + dx : 3 + dx + cols] for dy, dx in RING_OFFSETS]
    ) - center

    def polarity_score(d):
        ext = torch.cat([d, d[: ARC_LENGTH - 1]])
        wmin = ext[0:16]
        for i in range(1, ARC_LENGTH):
            wmin = torch.minimum(wmin, ext[i : i + 16])
        return wmin.amax(0)

    score = torch.maximum(polarity_score(diff), polarity_score(-diff))
    raw = score[1 : 1 + H, 1 : 1 + W]
    neigh = torch.stack([
        score[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)
    ]).amax(0)
    return raw.contiguous(), torch.where(raw > neigh, raw, float("-inf"))


# ---------------------------------------------------------------------------
# B2: patch extraction
# ---------------------------------------------------------------------------


def extract_patches(planes: torch.Tensor, keypoints: torch.Tensor, ps: int = 31) -> torch.Tensor:
    """(C, H, W) planes + (K, 2) float32 (x, y) keypoints -> (K, C, ps*ps).

    Any C and ps: ORB reads C=1, ps=31 (f16), BRISK C=5 and FREAK C=7 at
    ps=27, AKAZE C=3 at ps=31 (f32). Patch k starts at clip(round(kp) - ps // 2, 0, dim - ps) with
    round-half-to-even; values keep the planes' dtype (f16 or f32)."""
    _require(planes.dim() == 3 and planes.dtype in (torch.float16, torch.float32),
             f"extract_patches: expected (C, H, W) f16/f32 planes, got {tuple(planes.shape)} {planes.dtype}")
    _require(keypoints.dim() == 2 and keypoints.shape[1] == 2 and keypoints.dtype == torch.float32,
             f"extract_patches: expected (K, 2) float32 keypoints, got {tuple(keypoints.shape)} {keypoints.dtype}")
    C, H, W = planes.shape
    _require(0 < ps <= min(H, W), f"extract_patches: patch size {ps} does not fit {H}x{W}")
    _require(keypoints.device == planes.device, "extract_patches: planes and keypoints on different devices")
    if not _dispatch_device(planes, "extract_patches"):
        return extract_patches_plain(planes, keypoints, ps)
    _require(keypoints.is_contiguous(), "extract_patches: keypoints must be contiguous")
    K = keypoints.shape[0]
    out = torch.empty((K, C, ps * ps), dtype=planes.dtype, device=planes.device)
    if K == 0:
        return out
    _launch("extract_patches", planes.device, planes.data_ptr(), planes.element_size(),
            C, H, W, keypoints.data_ptr(), K, ps, out.data_ptr())
    return out


def extract_patches_plain(planes: torch.Tensor, keypoints: torch.Tensor, ps: int = 31) -> torch.Tensor:
    """Plain PyTorch version of `extract_patches`."""
    C, H, W = planes.shape
    r = ps // 2
    xs = (torch.round(keypoints[:, 0]).long() - r).clamp(0, W - ps)
    ys = (torch.round(keypoints[:, 1]).long() - r).clamp(0, H - ps)
    off = torch.arange(ps, device=planes.device)
    flat = (ys[:, None, None] + off[None, :, None]) * W + (xs[:, None, None] + off[None, None, :])
    out = planes.reshape(C, H * W)[:, flat.reshape(-1)]  # (C, K*ps*ps)
    return out.reshape(C, -1, ps * ps).transpose(0, 1).contiguous()


# ---------------------------------------------------------------------------
# B3: Hamming kNN(2) with a fused top-2
# ---------------------------------------------------------------------------


def hamming_top2(
    desc_q: torch.Tensor, desc_t: torch.Tensor, valid_t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN(2) of packed descriptors: (Kq, words) int32 queries against
    (Kt, words) int32 trains (on the card, stored from a 16-byte boundary,
    as every allocation and every row slice of one is), (Kt,) bool train
    validity.

    Returns (best_idx (Kq,) int32, d1 (Kq,) f32, d2 (Kq,) f32): the lowest
    index wins ties, invalid trains are ignored, 1e9 where no valid train is
    left. words is 8 (256-bit, ORB) or 16 (512-bit, BRISK, FREAK, AKAZE).

    One kernel serves both TPU kernels of this contract: the ±1 bf16 product
    of `hamming_top2_mxu` and the XOR + popcount of `hamming_top2`. It
    computes the distances on the tensor cores as binary AND + popcount
    products of the packed words (the TPU sentinels 3e9 and 1 << 20 become
    1e9)."""
    _require(desc_q.dim() == 2 and desc_t.dim() == 2 and desc_q.shape[1] == desc_t.shape[1],
             f"hamming_top2: shapes {tuple(desc_q.shape)} vs {tuple(desc_t.shape)}")
    _require(desc_q.dtype == torch.int32 and desc_t.dtype == torch.int32,
             "hamming_top2: descriptors must be packed int32 words")
    _require(valid_t.dtype == torch.bool and valid_t.shape == (desc_t.shape[0],),
             "hamming_top2: valid_t must be a (Kt,) bool tensor")
    _require(desc_q.device == desc_t.device == valid_t.device, "hamming_top2: tensors on different devices")
    words = desc_q.shape[1]
    _require(words in (8, 16), f"hamming_top2: words must be 8 or 16, got {words}")
    _require(desc_t.shape[0] > 0, "hamming_top2: empty train set")
    if not _dispatch_device(desc_q, "hamming_top2"):
        return hamming_top2_plain(desc_q, desc_t, valid_t)
    _require(desc_t.is_contiguous() and valid_t.is_contiguous(), "hamming_top2: inputs must be contiguous")
    _require(desc_t.data_ptr() % 16 == 0, "hamming_top2: train storage must be 16-byte aligned")
    Kq, Kt = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    idx = torch.empty(Kq, dtype=torch.int32, device=dev)
    d1 = torch.empty(Kq, dtype=torch.float32, device=dev)
    d2 = torch.empty(Kq, dtype=torch.float32, device=dev)
    if Kq == 0:
        return idx, d1, d2
    _launch("hamming_top2", dev, desc_q.data_ptr(), desc_t.data_ptr(), valid_t.data_ptr(),
            Kq, Kt, words, idx.data_ptr(), d1.data_ptr(), d2.data_ptr())
    return idx, d1, d2


def hamming_top2_plain(
    desc_q: torch.Tensor, desc_t: torch.Tensor, valid_t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `hamming_top2`: the (Kq, Kt) distance matrix
    as |a| + |b| - 2 a.b over unpacked bits (exact in f32: every term is an
    integer <= 512), then ops/hamming.knn2_match."""
    from vision_slam_frontend_tpu_torch.ops.brief import unpack_bits
    from vision_slam_frontend_tpu_torch.ops.hamming import knn2_match

    bq = unpack_bits(desc_q)
    bt = unpack_bits(desc_t)
    dist = bq.sum(1)[:, None] + bt.sum(1)[None, :] - 2.0 * (bq @ bt.T)
    return knn2_match(dist, valid_t)


# ---------------------------------------------------------------------------
# B5: dynamic-row window gather (the TPU toolchain probe's function)
# ---------------------------------------------------------------------------

WINDOW_COLS = 32  # the probe's lane width LW
WINDOW_ROWS = (31, 32)
WINDOW_BLOCKS = (8, 64)


def patch_windows(
    image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rows: int = 32,
    shifted: bool = False, block: int = 64,
) -> torch.Tensor:
    """(H, W) float32 image, (K,) int32 row starts `ys` and column starts
    `xs` -> (K, rows, 32) float32 windows.

    Window k is P[ys[k] : ys[k] + rows, c0 : c0 + 32] of the image padded
    with zeros (the probe pads (0, 8) rows and (0, 32) columns; reads beyond
    that are zeros too), where c0 = xs[k] if `shifted` else 0. `block` is the
    probe's keypoints per program (64 or 8); it changes neither the result
    nor the kernel's grid, which is sized to the card."""
    _require(image.dim() == 2 and image.dtype == torch.float32,
             f"patch_windows: expected a (H, W) float32 image, got {tuple(image.shape)} {image.dtype}")
    _require(ys.dim() == 1 and ys.dtype == torch.int32 and xs.shape == ys.shape and xs.dtype == torch.int32,
             f"patch_windows: expected (K,) int32 ys and xs, got {tuple(ys.shape)} {ys.dtype}, "
             f"{tuple(xs.shape)} {xs.dtype}")
    _require(rows in WINDOW_ROWS, f"patch_windows: rows must be one of {WINDOW_ROWS}, got {rows}")
    _require(block in WINDOW_BLOCKS, f"patch_windows: block must be one of {WINDOW_BLOCKS}, got {block}")
    _require(image.device == ys.device == xs.device, "patch_windows: tensors on different devices")
    if not _dispatch_device(image, "patch_windows"):
        return patch_windows_plain(image, ys, xs, rows, shifted, block)
    _require(ys.is_contiguous() and xs.is_contiguous(), "patch_windows: ys and xs must be contiguous")
    H, W = image.shape
    K = ys.shape[0]
    out = torch.empty((K, rows, WINDOW_COLS), dtype=torch.float32, device=image.device)
    if K == 0:
        return out
    _launch("patch_windows", image.device, image.data_ptr(), H, W, ys.data_ptr(), xs.data_ptr(),
            K, rows, int(shifted), block, out.data_ptr())
    return out


def patch_windows_plain(
    image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, rows: int = 32,
    shifted: bool = False, block: int = 64,
) -> torch.Tensor:
    """Plain PyTorch version of `patch_windows`: one index gather, zeros
    where the window leaves the image."""
    del block  # the probe's keypoints per program: no effect on the result
    H, W = image.shape
    dev = image.device
    y = ys.long()[:, None, None] + torch.arange(rows, device=dev)[None, :, None]
    x0 = xs.long() if shifted else torch.zeros_like(xs, dtype=torch.long)
    x = x0[:, None, None] + torch.arange(WINDOW_COLS, device=dev)[None, None, :]
    inside = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    flat = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
    return torch.where(inside, image.reshape(-1)[flat], 0.0)
