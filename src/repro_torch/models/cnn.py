"""The paper's CIFAR-10 model: a CNN with six convolutional layers.

Port of `repro/models/cnn.py`. Structure: 3 stages of (conv-conv-pool),
channels 32/64/128 (3x3 `SAME` convolutions, 2x2 max-pool after each
pair), then a 2048 -> 10 linear head.

The public functions take NHWC images, as the reference does. Inside, the
convolutions run in PyTorch's NCHW layout, and the activations go back
to NHWC before the flatten, so the head's 2048 input rows are in the
reference's (h, w, c) order. Parameters are a dict keyed like the
`CNN` module's `named_parameters()`: conv weights OIHW, head weight
[out, in]. `cnn_params_from_jax` converts the reference's tree (HWIO conv
weights, [in, out] head) into it.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.module import declare, materialize

CHANNELS = ((3, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128))


def _conv_decl(cin: int, cout: int, k: int = 3):
    std = math.sqrt(2.0 / (k * k * cin))  # He init over the true fan-in
    return {"w": declare((k, k, cin, cout), init="normal", scale=std),
            "b": declare((cout,), init="zeros")}


def cnn_decl(num_classes: int = 10):
    """The parameter declarations, in the reference's layout."""
    return {
        "convs": [_conv_decl(ci, co) for ci, co in CHANNELS],
        "head": {"w": declare((128 * 4 * 4, num_classes), init="scaled"),
                 "b": declare((num_classes,), init="zeros")},
    }


def cnn_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """The reference's CNN parameter tree (arrays or tensors, HWIO conv
    weights, [in, out] head) as the port's parameter dict."""
    def t(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=torch.float32)

    out = {}
    for i, p in enumerate(tree["convs"]):
        out[f"convs.{i}.weight"] = t(p["w"]).permute(3, 2, 0, 1).contiguous()
        out[f"convs.{i}.bias"] = t(p["b"])
    out["head.weight"] = t(tree["head"]["w"]).T.contiguous()
    out["head.bias"] = t(tree["head"]["b"])
    return out


def cnn_apply(params: Dict[str, torch.Tensor],
              images: torch.Tensor) -> torch.Tensor:
    """images [B,32,32,3] float (NHWC) -> logits [B,10]."""
    x = images.permute(0, 3, 1, 2)
    for i in range(len(CHANNELS)):
        x = F.relu(F.conv2d(x, params[f"convs.{i}.weight"],
                            params[f"convs.{i}.bias"], padding=1))
        if i % 2 == 1:  # pool after every conv pair
            x = F.max_pool2d(x, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c) order
    return F.linear(x, params["head.weight"], params["head.bias"])


def cnn_loss(params, batch) -> torch.Tensor:
    return L.softmax_cross_entropy(cnn_apply(params, batch["x"]),
                                   batch["y"])


def cnn_accuracy(params, batch) -> torch.Tensor:
    logits = cnn_apply(params, batch["x"])
    return (logits.argmax(-1) == batch["y"]).to(torch.float32).mean()


class CNN(nn.Module):
    """The CNN as a module; its `named_parameters()` are the keys of the
    parameter dict the functions above take."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, 3, padding=1) for ci, co in CHANNELS)
        self.head = nn.Linear(128 * 4 * 4, num_classes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return cnn_apply(dict(self.named_parameters()), images)


def init_cnn(gen: torch.Generator, num_classes: int = 10) -> CNN:
    """A CNN on `gen`'s device with the reference's initialisation (He
    normal convs, fan-in-scaled truncated-normal head, zero biases)."""
    model = CNN(num_classes).to(gen.device)
    params = cnn_params_from_jax(materialize(gen, cnn_decl(num_classes)))
    model.load_state_dict(params)
    return model
