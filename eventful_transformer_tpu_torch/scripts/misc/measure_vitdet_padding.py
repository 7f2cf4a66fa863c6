"""The share of each VID frame that is image, not padding, at ViTDet's two
operating points (port of ``scripts/misc/measure_vitdet_padding.py``;
reference scripts/misc/measure_vitdet_padding.py): a frame resized by
``VIDResize`` to a short edge of 640 size / 1024 and a long edge of at
most ``size`` fills h w / size^2 of the size x size input, and the share,
averaged over the frames of the split (a video's first frame stands for
all of its frames), normalises the FLOP counts of the padded input.

    python -m eventful_transformer_tpu_torch.scripts.misc.measure_vitdet_padding \
        [--location data/vid]

run from the repo's root, where ``data/vid`` holds the unpacked dataset
(or its ``data.tar``, unpacked at first use). Over the vid_val split it
prints the JAX script's line for each size, ``Size <size>: <share>``,
then one JSON line of the unrounded shares. The frames are read and
resized on the host; no model runs.
"""

import argparse
import json
from pathlib import Path

from eventful_transformer_tpu_torch.data.vid import VID, VIDResize

SIZES = (672, 1024)


def padding_shares(location, tar_path=None):
    """{size: the frame-weighted mean share of the size x size input that
    the resized frames of the vid_val split fill}."""
    shares = {}
    for size in SIZES:
        data = VID(Path(location), split="vid_val", tar_path=tar_path,
                   combined_transform=VIDResize(short_edge_length=640 * size // 1024,
                                                max_size=size))
        weighted, frames = 0.0, 0
        for i in range(len(data)):
            item = data[i]
            frame = item[0][0]
            weighted += len(item) * frame.shape[-1] * frame.shape[-2] / size**2
            frames += len(item)
        shares[size] = weighted / frames
    return shares


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--location", default=str(Path("data", "vid")),
                        help="the VID dataset, unpacked or holding data.tar")
    args = parser.parse_args(argv)
    shares = padding_shares(args.location, tar_path=Path(args.location, "data.tar"))
    for size, share in shares.items():
        print(f"Size {size}: {share:.5g}")
    print(json.dumps({"split": "vid_val", "shares": {str(k): v for k, v in shares.items()}}))
    return shares


if __name__ == "__main__":
    main()
