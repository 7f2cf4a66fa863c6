"""Convert a detectron2 ViTDet checkpoint (.pkl or .pth) into the ``.npz``
parameter layout both packages read (port of ``scripts/convert/vitdet.py``):

    python -m eventful_transformer_tpu_torch.scripts.convert.vitdet \
        <in.pkl|in.pth> <out.npz> [pattern file] [-v]

run from the repo's root (the default pattern file is
``configs/convert/vitdet_b.txt``). The class token's position embedding is
dropped; the names go through the pattern file's regex renames, then
``utils/params.py::convert_torch_state_dict``.

Weight sources:
https://github.com/facebookresearch/detectron2/tree/main/projects/ViTDet
https://github.com/happyharrycn/detectron2_vitdet_vid/tree/main/projects/ViTDet-VID
"""

import pickle
from argparse import ArgumentParser

import numpy as np
import torch

from eventful_transformer_tpu_torch.utils.misc import parse_patterns, remap_weights
from eventful_transformer_tpu_torch.utils.params import convert_torch_state_dict


def main(args):
    if args.in_file.endswith(".pkl"):
        with open(args.in_file, "rb") as f:
            in_weights = pickle.load(f, encoding="latin1")
    else:
        in_weights = torch.load(args.in_file, map_location="cpu", weights_only=False)
    if "model" in in_weights:
        in_weights = in_weights["model"]
    key = "backbone.net.pos_embed"
    if key in in_weights:
        in_weights[key] = np.asarray(in_weights[key])[:, 1:]
    remapped, n_remapped = remap_weights(in_weights, parse_patterns(args.pattern_file), args.verbose)
    np.savez(args.out_file, **convert_torch_state_dict(remapped))
    print(f"Remapped {n_remapped}/{len(in_weights)} weights -> {args.out_file}")


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("in_file", help="the input .pkl or .pth checkpoint")
    parser.add_argument("out_file", help=".npz file where the output should be saved")
    parser.add_argument("pattern_file", nargs="?", default="configs/convert/vitdet_b.txt",
                        help=".txt file containing regex rename patterns")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
