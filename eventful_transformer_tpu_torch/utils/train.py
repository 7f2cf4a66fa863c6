"""Temporal-sub-model fine-tuning (port of
``eventful_transformer_tpu/utils/train.py``; reference utils/train.py:13-105).

The one training path of the system: the temporal sub-model and the
classifier are fine-tuned on cached spatial outputs (``utils/spatial.py``),
so no gradient reaches the spatial model or its gates.

As in the JAX package (and the reference, whose ``nn.CrossEntropyLoss``
takes the model's softmax output), the loss is the cross-entropy of the
class *probabilities* taken as logits. The optimizer holds the
``temporal_model`` and ``classifier`` parameters only; every other
parameter has ``requires_grad=False`` and stays as it was, bit for bit (JAX
``optax.multi_transform`` with ``set_to_zero``). The optimizer's names and
defaults are optax's (``make_optimizer``).

A training step runs the blocks with ``Ctx(training=True)``: their plain
PyTorch path, which autograd differentiates (the kernels have no backward);
dropout and drop-path draw from one ``torch.Generator`` on the model's
device, seeded 42. The validation passes run under ``torch.no_grad()``
through the kernels, as inference does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.utils.misc import MeanValue, TopKAccuracy, seeded_shuffle
from eventful_transformer_tpu_torch.utils.params import load_params, save_params

TRAINED_SUBTREES = ("temporal_model", "classifier")
SEED = 42

# optax's factories: the torch optimizer and optax's keywords with their
# defaults (optax.adamw's weight_decay is 1e-4, torch's 1e-2)
OPTIMIZERS = {
    "adamw": (torch.optim.AdamW, dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)),
    "adam": (torch.optim.Adam, dict(b1=0.9, b2=0.999, eps=1e-8)),
    "sgd": (torch.optim.SGD, dict(momentum=None, nesterov=False)),
}


def trained_parameters(model):
    """The parameters under ``TRAINED_SUBTREES``, which now require grad;
    every other parameter of ``model`` is frozen (``requires_grad=False``)."""
    trained = []
    for name, p in model.named_parameters():
        train = name.split(".", 1)[0] in TRAINED_SUBTREES
        p.requires_grad_(train)
        if train:
            trained.append(p)
    return trained


def make_optimizer(config, model, parameters=None):
    """The optimizer of ``config`` (``optimizer``: AdamW, Adam or SGD;
    ``optimizer_kwargs``: optax's names, ``lr`` (default 1e-4), ``b1``/``b2``
    (torch's ``betas``), ``eps``, ``weight_decay`` (AdamW), ``momentum`` and
    ``nesterov`` (SGD), optax's defaults where the config gives none) over
    ``parameters``, by default :func:`trained_parameters` of ``model``."""
    name = config.get("optimizer", "AdamW").lower()
    kwargs = dict(config.get("optimizer_kwargs", {}))
    lr = kwargs.pop("lr", 1e-4)
    factory, defaults = OPTIMIZERS[name]
    unknown = sorted(set(kwargs) - set(defaults))
    if unknown:
        raise TypeError(f"{name} takes {sorted(defaults)} besides lr, got {unknown}")
    options = {**defaults, **kwargs}
    if name == "sgd":
        momentum = options["momentum"] or 0.0
        torch_kwargs = dict(momentum=momentum, nesterov=bool(options["nesterov"]) and momentum > 0)
    else:
        torch_kwargs = dict(betas=(options["b1"], options["b2"]), eps=options["eps"])
        if name == "adamw":
            torch_kwargs["weight_decay"] = options["weight_decay"]
    if parameters is None:
        parameters = trained_parameters(model)
    return factory(parameters, lr=lr, **torch_kwargs)


def loss_fn(model, inputs, labels, ctx):
    """(mean cross-entropy of the probabilities as logits, probabilities)
    of spatial features ``inputs`` (batch, views, t, dim)."""
    probs = model._forward_temporal(ctx, inputs, inputs.shape[0])
    return F.cross_entropy(probs, labels), probs


def train_step(model, optimizer, inputs, labels, generator):
    """One optimizer step; returns the step's (loss, probabilities), taken
    before the update, detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, probs = loss_fn(model, inputs, labels, Ctx(training=True, generator=generator))
    loss.backward()
    optimizer.step()
    return loss.detach(), probs.detach()


@torch.no_grad()
def eval_step(model, inputs, labels):
    return loss_fn(model, inputs, labels, Ctx())


def _batches(data, batch_size, shuffle, seed, device):
    """(inputs, labels) batches of ``data``'s (spatial, label) items on
    ``device``, shuffled by ``seeded_shuffle(order, seed)``; the ragged tail
    is dropped, as in the JAX package."""
    order = list(range(len(data)))
    if shuffle:
        seeded_shuffle(order, seed)
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size:
            continue
        items = [data[i] for i in idx]
        inputs = torch.from_numpy(np.stack([np.asarray(x, dtype=np.float32) for x, _ in items]))
        labels = torch.as_tensor([y for _, y in items], dtype=torch.long)
        yield inputs.to(device), labels.to(device)


def train_vivit_temporal(config, train_data, val_data, model_class=None):
    """Fine-tune the temporal sub-model on cached spatial outputs (JAX
    ``train_vivit_temporal``): a validation pass, then per epoch a training
    and a validation pass, each logged as a history entry ``{pass, step,
    loss, top_1, top_5}`` and printed. ``checkpoint_dir`` saves the full
    state after each epoch and resumes from its latest (the epoch count
    and, as in the JAX package, the generator seeded anew);
    ``output_weights`` gets the final weights as a JAX-layout ``.npz``.
    The model is built from ``config["model"]`` (seed 42, on the card
    unless ``model.device`` names another device) and takes
    ``starting_weights`` where given. Returns (model, history)."""
    from eventful_transformer_tpu_torch.models import FactorizedViViT

    model_class = model_class or FactorizedViViT
    model = model_class(**{"seed": SEED, **config["model"]})
    if config.get("starting_weights"):
        load_params(config["starting_weights"], model)
    device = model.classifier.kernel.device
    optimizer = make_optimizer(config, model)

    mean_loss, top_1, top_5 = MeanValue(), TopKAccuracy(1), TopKAccuracy(5)
    history = []
    generator = torch.Generator(device=device).manual_seed(SEED)
    tensorboard = _make_tensorboard(config)

    def log_epoch(key, step):
        entry = {
            "pass": key,
            "step": step,
            "loss": mean_loss.compute(),
            "top_1": top_1.compute(),
            "top_5": top_5.compute(),
        }
        history.append(entry)
        if tensorboard is not None:
            for metric in ("loss", "top_1", "top_5"):
                tensorboard.add_scalars(metric, {key: entry[metric]}, step)
        print(
            f"Loss: {entry['loss']:.4f}; Top-1: {entry['top_1']:.4f}; "
            f"Top-5: {entry['top_5']:.4f}",
            flush=True,
        )
        return entry

    def run_pass(step, training):
        mean_loss.reset(), top_1.reset(), top_5.reset()
        data = train_data if training else val_data
        batch_size = config["train_batch_size" if training else "val_batch_size"]
        for inputs, labels in _batches(data, batch_size, training, SEED + step, device):
            if training:
                loss, probs = train_step(model, optimizer, inputs, labels, generator)
            else:
                loss, probs = eval_step(model, inputs, labels)
            mean_loss.update(float(loss))
            probs, labels = probs.float().cpu().numpy(), labels.cpu().numpy()
            top_1.update(probs, labels)
            top_5.update(probs, labels)
        return log_epoch("train" if training else "val", step)

    ckpt_dir = config.get("checkpoint_dir")
    start_epoch = 0
    if ckpt_dir:
        from eventful_transformer_tpu_torch.utils.checkpoint import (
            latest_epoch,
            restore_train_state,
            save_train_state,
        )

        done = latest_epoch(ckpt_dir)
        if done is not None:
            restore_train_state(ckpt_dir, done, model, optimizer)
            start_epoch = done
            print(f"Resumed from {ckpt_dir} at epoch {done}", flush=True)

    print("Validation pass", flush=True)
    run_pass(start_epoch, training=False)
    n_epochs = config["epochs"]
    for epoch in range(start_epoch, n_epochs):
        print(f"\nEpoch {epoch + 1}/{n_epochs}", flush=True)
        print("Training pass", flush=True)
        run_pass(epoch + 1, training=True)
        print("Validation pass", flush=True)
        run_pass(epoch + 1, training=False)
        if ckpt_dir:
            save_train_state(ckpt_dir, epoch + 1, model, optimizer)

    if tensorboard is not None:
        tensorboard.close()
    if config.get("output_weights"):
        save_params(config["output_weights"], model)
        print(f"Saved weights to {config['output_weights']}", flush=True)
    return model, history


def _make_tensorboard(config):
    """TensorBoard scalar logging (reference utils/train.py:41-57), where
    the config names a location and ``SummaryWriter`` imports; otherwise a
    warning, and the run goes on."""
    if "tensorboard" not in config:
        return None
    try:
        from datetime import datetime

        from torch.utils.tensorboard import SummaryWriter

        now = datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
        return SummaryWriter(f"{config['tensorboard']}_{now}")
    except Exception as exc:  # no tensorboard backend: the console only
        print(f"WARNING: tensorboard disabled ({exc})", flush=True)
        return None
