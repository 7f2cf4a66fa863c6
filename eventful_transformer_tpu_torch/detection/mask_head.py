"""Mask R-CNN mask head, inference (port of
``eventful_transformer_tpu/detection/mask_head.py``: detectron2's
MaskRCNNConvUpsampleHead as the COCO operating point's cascade_mask_rcnn
base configures it). 14 x 14 ROIAlign over p2-p5, 4 x (3x3 conv of 256
channels without bias, LN over the channels, ReLU), a 2 x 2 stride-2
transposed conv and ReLU, a 1x1 predictor, then the detected class's
channel through a sigmoid: (P, 28, 28) mask probabilities. Plain PyTorch
(cuDNN convolutions, ``ops/conv.py``), as XLA in the JAX package."""

from __future__ import annotations

import torch
from torch import nn

from eventful_transformer_tpu_torch.core.nn import LayerNorm, layer_norm, trunc_normal_
from eventful_transformer_tpu_torch.detection.roi_align import multilevel_roi_align
from eventful_transformer_tpu_torch.ops.conv import Conv2d, ConvTranspose2d


class MaskPredictor(Conv2d):
    """The 1x1 predictor, initialised as the JAX head's: a truncated normal
    kernel with standard deviation 0.001, zero bias."""

    def __init__(self, cin, num_classes):
        super().__init__(1, 1, cin, num_classes)

    def reset_parameters(self, generator):
        trunc_normal_(self.kernel, generator, std=0.001)
        with torch.no_grad():
            self.bias.zero_()


class MaskHead(nn.Module):
    def __init__(
        self,
        num_classes,
        in_channels=256,
        conv_dims=(256, 256, 256, 256),
        pooler_scales=(1 / 4, 1 / 8, 1 / 16, 1 / 32),
        pooler_output=14,
        sampling_ratio=2,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.pooler_scales = tuple(pooler_scales)
        self.pooler_output = pooler_output
        self.sampling_ratio = sampling_ratio
        self.convs = nn.ModuleList()
        cin = in_channels
        for dim in conv_dims:
            conv = Conv2d(3, 3, cin, dim, bias=False)
            conv.ln = LayerNorm(dim)
            self.convs.append(conv)
            cin = dim
        self.deconv = ConvTranspose2d(2, 2, cin, cin)
        self.predictor = MaskPredictor(cin, num_classes)

    def inference(self, features, boxes, labels):
        """features: p2-p5, a list of (1, H_l, W_l, C); boxes (P, 4) the
        final detections; labels (P,). Returns (P, 28, 28) the mask
        probabilities of each detection's class."""
        x = multilevel_roi_align(
            [f[0] for f in features], boxes, self.pooler_scales, min_level=2, max_level=5,
            output_size=self.pooler_output, sampling_ratio=self.sampling_ratio,
        )  # (P, 14, 14, C)
        for conv in self.convs:
            x = torch.relu(layer_norm(conv(x, padding=1), conv.ln))
        x = torch.relu(self.deconv(x))
        logits = self.predictor(x)  # (P, 28, 28, classes)
        index = labels.long()[:, None, None, None].expand(logits.shape[:-1] + (1,))
        return torch.sigmoid(torch.gather(logits, -1, index)[..., 0])
