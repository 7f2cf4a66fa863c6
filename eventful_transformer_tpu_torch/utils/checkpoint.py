"""Full-state training checkpoints (port of
``eventful_transformer_tpu/utils/checkpoint.py``): the epoch, every
parameter and the optimizer's state, so that a fine-tune resumes where it
stopped (the same optimizer moments, the same epoch schedule). Enabled by
``checkpoint_dir`` in a train config.

The format is the port's own: one ``torch.save`` file a checkpoint,
``<directory>/epoch_{epoch:05d}``, written under a temporary name and moved
into place with ``os.replace``, so that a crash never leaves a partial
checkpoint under the final name. The JAX package's Orbax directories are
not read; the weights alone cross between the packages as ``.npz``
(``utils/params.py``).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def _path(directory, epoch):
    return Path(directory) / f"epoch_{epoch:05d}"


def save_train_state(directory, epoch, model, optimizer):
    """Write the checkpoint of ``epoch``: {epoch, params (name -> CPU
    tensor), optimizer (its ``state_dict``)}. Returns its path."""
    path = _path(directory, epoch)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {
        "epoch": epoch,
        "params": {name: p.detach().cpu() for name, p in model.named_parameters()},
        "optimizer": optimizer.state_dict(),
    }
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_epoch(directory):
    """The largest epoch checkpointed under ``directory``, or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    epochs = [
        int(child.name[6:])
        for child in directory.iterdir()
        if child.name.startswith("epoch_") and child.name[6:].isdigit()
    ]
    return max(epochs) if epochs else None


def restore_train_state(directory, epoch, model, optimizer):
    """Load the checkpoint of ``epoch`` into ``model``'s parameters (on
    their devices, in their dtypes) and ``optimizer``. Returns the epoch."""
    state = torch.load(_path(directory, epoch), map_location="cpu", weights_only=True)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state["params"]))
    extra = sorted(set(state["params"]) - set(params))
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={missing[:8]} extra={extra[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(state["params"][name])
    optimizer.load_state_dict(state["optimizer"])
    return state["epoch"]
