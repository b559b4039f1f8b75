"""Host-side image decoding and encoding (port of io/image.py).

The JAX package's chain, in its order: a plain (non-Bayer) JPEG takes the
native libjpeg decoder when it is built (io/native_loader.py), anything else
OpenCV, and PIL where OpenCV is not installed. Bayer frames (`bayer_rggb8`)
are demosaiced to BGR by OpenCV, then converted to gray, as the reference's
DecodeImage does. `decode_route()` names the route a plain JPEG takes here;
the frontend CLI prints it at `-v 1`.
"""

from __future__ import annotations

import io

import numpy as np

from vision_slam_frontend_tpu_torch.io import native_loader


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def decode_image_bytes(data: bytes, fmt: str = "") -> np.ndarray:
    """Decode compressed image bytes to grayscale float32 (H, W) with OpenCV,
    else PIL."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError("cv2.imdecode failed")
        if "bayer_rggb8" in fmt:
            bgr = cv2.cvtColor(img, cv2.COLOR_BayerBG2BGR)
            img = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        return img.astype(np.float32)
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("L"), np.float32)


def decode_compressed_image(msg: dict) -> np.ndarray:
    """Decode a parsed sensor_msgs/CompressedImage dict (io/rosbag.py) to
    float32: the native decoder for a plain JPEG where it is built, else
    decode_image_bytes."""
    fmt = msg.get("format", "")
    if "bayer" not in fmt and native_loader.native_available():
        out = native_loader.decode_jpeg_gray(msg["data"])
        if out is not None:
            return out.astype(np.float32)
    return decode_image_bytes(msg["data"], fmt)


def decode_route(native: bool = True) -> str:
    """The decoder a plain JPEG takes on this machine: "native libjpeg",
    "cv2" or "PIL"; with `native=False`, the one an image file takes
    (load_gray)."""
    if native and native_loader.native_available():
        return "native libjpeg"
    if _cv2() is not None:
        return "cv2"
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            f"no JPEG decoder: native libjpeg unavailable ({native_loader.unavailable_reason()}), "
            "and neither cv2 nor PIL is installed"
        ) from e
    return "PIL"


def encode_jpeg(image: np.ndarray, quality: int = 92) -> bytes:
    """Grayscale image -> JPEG bytes (for writing test and benchmark bags)."""
    img8 = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    cv2 = _cv2()
    if cv2 is not None:
        ok, buf = cv2.imencode(".jpg", img8, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise ValueError("cv2.imencode failed")
        return bytes(buf.tobytes())
    from PIL import Image

    out = io.BytesIO()
    Image.fromarray(img8).save(out, format="JPEG", quality=quality)
    return out.getvalue()


def load_gray(path: str) -> np.ndarray:
    """An image file (PNG, JPEG) as grayscale float32, with OpenCV, else PIL."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError(f"failed to read {path}")
        return img.astype(np.float32)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


def write_gray(path: str, image: np.ndarray) -> None:
    """Write a grayscale image file (the format from the suffix) with OpenCV,
    else PIL."""
    img8 = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    cv2 = _cv2()
    if cv2 is not None:
        if not cv2.imwrite(path, img8):
            raise ValueError(f"cv2.imwrite failed for {path}")
        return
    from PIL import Image

    Image.fromarray(img8).save(path)
