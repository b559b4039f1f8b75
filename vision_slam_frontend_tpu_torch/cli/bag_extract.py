"""bag_extract (port of cli/bag_extract.py): dump a bag's compressed-image
topic to numbered image files.

The reference's standalone extraction tool: open a bag, iterate one image
topic, decode (Bayer frames demosaiced), write numbered .jpg files, with the
port's bag reader and decoders (io/rosbag.py, io/image.py); no GPU is used.

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.bag_extract \\
      --input in.bag --output_dir out/ [--image_topic /camera/...] [--max_images N]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bag_extract_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", required=True, help="input bag file")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--image_topic", default="/stereo/left/image_raw/compressed")
    p.add_argument("--max_images", type=int, default=0)
    args = p.parse_args(argv)

    from vision_slam_frontend_tpu_torch.io import rosbag
    from vision_slam_frontend_tpu_torch.io.image import decode_compressed_image, encode_jpeg

    os.makedirs(args.output_dir, exist_ok=True)
    count = 0
    for _, _, msg in rosbag.read_messages(args.input, topics=[args.image_topic]):
        if "data" not in msg:
            continue
        with open(os.path.join(args.output_dir, f"{count:06d}.jpg"), "wb") as f:
            f.write(encode_jpeg(np.asarray(decode_compressed_image(msg))))
        count += 1
        if args.max_images and count >= args.max_images:
            break
    print(f"Extracted {count} images from {args.image_topic} to {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
