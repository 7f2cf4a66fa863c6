"""Convert a TAdaConv ViViT checkpoint (.pyth or .pth) into the ``.npz``
parameter layout both packages read (port of ``scripts/convert/vivit.py``):

    python -m eventful_transformer_tpu_torch.scripts.convert.vivit \
        <in.pyth> <out.npz> [pattern file] [-v]

run from the repo's root (the default pattern file is
``configs/convert/vivit_b.txt``). The names go through the pattern file's
regex renames, then ``utils/params.py::convert_torch_state_dict``.

Weight source: https://github.com/alibaba-mmai-research/TAdaConv
"""

from argparse import ArgumentParser

import numpy as np
import torch

from eventful_transformer_tpu_torch.utils.misc import parse_patterns, remap_weights
from eventful_transformer_tpu_torch.utils.params import convert_torch_state_dict


def main(args):
    in_weights = torch.load(args.in_file, map_location="cpu", weights_only=False)
    if "model_state" in in_weights:
        in_weights = in_weights["model_state"]
    remapped, n_remapped = remap_weights(in_weights, parse_patterns(args.pattern_file), args.verbose)
    np.savez(args.out_file, **convert_torch_state_dict(remapped))
    print(f"Remapped {n_remapped}/{len(in_weights)} weights -> {args.out_file}")


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("in_file", help="the input .pyth/.pth checkpoint")
    parser.add_argument("out_file", help=".npz file where the output should be saved")
    parser.add_argument("pattern_file", nargs="?", default="configs/convert/vivit_b.txt",
                        help=".txt file containing regex rename patterns")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
