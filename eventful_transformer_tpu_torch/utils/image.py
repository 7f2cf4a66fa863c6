"""Image utilities (port of ``eventful_transformer_tpu/utils/image.py``).

``pad_to_size``, ``rescale`` and ``resize_to_fit`` take numpy arrays or
tensors and return tensors on the input's device (the CPU for numpy);
the resize is the port's ``ops/resize.py::resize_bilinear``, the same
separable matrices as the JAX package's. ``as_float32``/``as_uint8`` and the
writers are host-side numpy.
"""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from eventful_transformer_tpu_torch.ops.resize import resize_bilinear


def as_float32(x):
    """uint8 [0, 255] -> float32 [0, 1]; a tuple or list of ints is scaled
    item by item; anything else becomes a float32 array."""
    if hasattr(x, "dtype") and x.dtype == np.uint8:
        return np.asarray(x).astype(np.float32) / 255.0
    if type(x) in (tuple, list) and isinstance(x[0], int):
        return type(x)(x_i / 255.0 for x_i in x)
    return np.asarray(x, dtype=np.float32)


def as_uint8(x):
    """float [0, 1] -> uint8, clipped; uint8 passes through."""
    x = np.asarray(x)
    if x.dtype != np.uint8:
        x = (x * 255.0).clip(0.0, 255.0).astype(np.uint8)
    return x


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def pad_to_size(x, size, pad_value=0.0):
    """Pad the trailing dims of x to ``size`` at the bottom and right, with
    a scalar or a value that broadcasts to the padded shape."""
    x = _tensor(x)
    ndim = len(size)
    if any(s < d for s, d in zip(size, x.shape[-ndim:])):
        raise ValueError(f"cannot pad {tuple(x.shape)} to {tuple(size)}")
    out_shape = x.shape[: x.ndim - ndim] + tuple(size)
    if np.isscalar(pad_value):
        out = x.new_full(out_shape, pad_value)
    else:
        out = _tensor(pad_value).to(device=x.device, dtype=x.dtype).expand(out_shape).clone()
    out[(...,) + tuple(slice(0, d) for d in x.shape[-ndim:])] = x
    return out


def rescale(x, scale, antialias=True):
    """Scale the last two dims by ``scale`` (sizes rounded), bilinear."""
    if scale == 1.0:
        return _tensor(x)
    x = _tensor(x)
    size = (round(scale * x.shape[-2]), round(scale * x.shape[-1]))
    return resize_bilinear(x, size, antialias=antialias)


def resize_to_fit(x, size, antialias=True):
    """Resize so that the image covers ``size`` (the short-edge scale)."""
    scale = max(size[0] / x.shape[-2], size[1] / x.shape[-1])
    return rescale(x, scale, antialias=antialias)


def write_image(filename, image):
    """Write an image, (C, H, W) or (H, W, C), through PIL."""
    from PIL import Image

    image = np.asarray(image)
    if image.ndim == 3 and image.shape[0] in (1, 3):
        image = np.moveaxis(image, 0, -1)
    Image.fromarray(as_uint8(image)).save(str(filename))


def write_video(filename, video, fps=30, is_chw=True):
    """Write a video (T, C, H, W) through ffmpeg; without ffmpeg, an
    animated GIF beside ``filename``."""
    video = np.asarray(video)
    if is_chw:
        video = np.moveaxis(video, 1, -1)
    video = as_uint8(video)
    with tempfile.TemporaryDirectory() as tmp:
        for t in range(video.shape[0]):
            write_image(Path(tmp) / f"{t:06d}.png", video[t])
        try:
            code = subprocess.call(
                ["ffmpeg", "-y", "-loglevel", "error", "-framerate", str(fps),
                 "-i", str(Path(tmp) / "%06d.png"), str(filename)]
            )
        except FileNotFoundError:
            from PIL import Image

            frames = [Image.fromarray(video[t]) for t in range(video.shape[0])]
            gif = Path(filename).with_suffix(".gif")
            frames[0].save(gif, save_all=True, append_images=frames[1:],
                           duration=int(1000 / fps), loop=0)
            print(f"WARNING: ffmpeg not found; wrote {gif} instead", flush=True)
            return
    if code != 0:
        raise RuntimeError(f"ffmpeg failed writing {filename}")
