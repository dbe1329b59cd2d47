"""LPIPS perceptual distance with the AlexNet backbone (reference
scripts/eval_coco.py:25-37, 73-193: the ``lpips`` package, alex, at 64x64).

Counterpart of ``emcid_tpu/models/lpips.py``, with its math (not the
``lpips`` package's where they differ): the input shifted and scaled per
channel, AlexNet's five conv+ReLU taps with a 3x3/2 max pool after conv0
and conv1 (the JAX module pools once more after conv4, which no tap
reads), each tap unit-normalised over channels as
``t / sqrt(sum(t^2) + 1e-10)``, the squared difference through a learned
1x1 head, the spatial mean, summed over the taps.  Parameter names are
``net.conv{i}.weight/bias`` and ``lin{i}.weight``; ``lpips_from_torch``
takes the ``lpips`` package's checkpoint names and ``lpips_from_jax`` the
JAX package's Flax tree.  Images are NHWC at the boundary, NCHW inside;
the distance runs in exact f32 (``runtime.precise_matmuls``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.models.inception import resize_bilinear
from emcid_torch.runtime import precise_matmuls, resolve_device

# the lpips package's ImageNet normalisation of [-1, 1] inputs
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# the side the images are resized to (the reference's lpips at 64x64)
LPIPS_SIZE = 64

# AlexNet's conv stack: (in, out, kernel, stride, padding)
_ALEX = [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
         (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)]
_POOL_AFTER = (0, 1)
# conv indices inside torchvision's alexnet.features
_TORCH_FEATURE_IDX = [0, 3, 6, 8, 10]


class AlexNetFeatures(nn.Module):
    """AlexNet's conv features: the five ReLU taps (NCHW)."""

    def __init__(self):
        super().__init__()
        for i, (cin, cout, k, s, p) in enumerate(_ALEX):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, k, stride=s,
                                                padding=p))

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for i in range(len(_ALEX)):
            x = F.relu(getattr(self, f"conv{i}")(x))
            taps.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, stride=2)
        return taps


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / torch.sqrt((t * t).sum(dim=1, keepdim=True) + 1e-10)


class LPIPS(nn.Module):
    """Learned perceptual distance (B,) of NCHW RGB pairs in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, (_, cout, *_) in enumerate(_ALEX):
            setattr(self, f"lin{i}", nn.Conv2d(cout, 1, 1, bias=False))
        self.register_buffer("shift", torch.as_tensor(_SHIFT)[:, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.as_tensor(_SCALE)[:, None, None],
                             persistent=False)

    def forward(self, x0, x1) -> torch.Tensor:
        f0 = self.net((x0 - self.shift) / self.scale)
        f1 = self.net((x1 - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            d = (_unit(a) - _unit(b)) ** 2
            total = total + getattr(self, f"lin{i}")(d).mean(dim=(1, 2, 3))
        return total


def lpips_from_torch(state_dict) -> Dict[str, torch.Tensor]:
    """An ``lpips`` package (alex) checkpoint -> this module's state dict.
    Its names: ``net.slice{1..5}.{idx}.weight`` (or torchvision's
    ``net.features.{idx}.weight``) convs and ``lin{0..4}.model.1.weight``
    (or ``lins.{i}.model.1.weight``) heads."""
    sd = {k: torch.as_tensor(np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                        else v, np.float32))
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for i, idx in enumerate(_TORCH_FEATURE_IDX):
        for key in (f"net.features.{idx}.weight",
                    f"net.slice{i + 1}.{idx}.weight"):
            if key in sd:
                out[f"net.conv{i}.weight"] = sd[key]
                out[f"net.conv{i}.bias"] = sd[key[:-len("weight")] + "bias"]
                break
    for i in range(len(_ALEX)):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                out[f"lin{i}.weight"] = sd[key]
                break
    return out


def lpips_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax tree (numpy leaves) -> this module's state
    dict (kernels HWIO -> OIHW)."""
    oihw = lambda k: torch.tensor(np.asarray(k, np.float32)
                                  .transpose(3, 2, 0, 1))
    out = {}
    for i in range(len(_ALEX)):
        conv = params["net"][f"conv{i}"]
        out[f"net.conv{i}.weight"] = oihw(conv["kernel"])
        out[f"net.conv{i}.bias"] = torch.tensor(
            np.asarray(conv["bias"], np.float32))
        out[f"lin{i}.weight"] = oihw(params[f"lin{i}"]["kernel"])
    return out


class LPIPSScorer:
    """uint8 or [0, 1] float NHWC images, resized to ``LPIPS_SIZE`` ->
    distances.  ``state_dict``: this module's names (``lpips_from_torch`` /
    ``lpips_from_jax``); ``None`` -> random weights from seed 0 (smoke
    runs; the heads' weights non-negative, as trained LPIPS heads are, so
    that the layer sum does not cancel)."""

    def __init__(self, state_dict=None, device=None):
        from emcid_torch.models.loader import _frozen, _random_init_

        dev = resolve_device(device)
        if state_dict is None:
            with torch.device(dev):
                model = LPIPS()
            _random_init_(model, torch.Generator(device=dev).manual_seed(0))
            with torch.no_grad():
                for i in range(len(_ALEX)):
                    getattr(model, f"lin{i}").weight.abs_()
        else:
            model = LPIPS()
            model.load_state_dict(state_dict, strict=True)
        self.model = _frozen(model.to(dev), torch.float32)

    def _prep(self, imgs) -> torch.Tensor:
        dev = next(self.model.parameters()).device
        x = torch.tensor(np.asarray(imgs), device=dev)
        if x.dim() == 3:
            x = x[None]
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)
        if tuple(x.shape[2:]) != (LPIPS_SIZE, LPIPS_SIZE):
            x = resize_bilinear(x, LPIPS_SIZE)
        return x

    @torch.no_grad()
    def distance(self, imgs_a, imgs_b) -> np.ndarray:
        with precise_matmuls():
            return self.model(self._prep(imgs_a),
                              self._prep(imgs_b)).cpu().numpy()
