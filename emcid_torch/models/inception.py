"""InceptionV3 pool3 feature extractor for FID (pytorch-fid's ``dims=2048``
network; reference scripts/test_fid_score.py:4-43).

Counterpart of ``emcid_tpu/models/inception.py``: the torchvision
InceptionV3 trunk up to the 2048-d global average pool, with pytorch-fid's
three FID patches, which the ``pt_inception-2015-12-05`` weights expect:

* the pool branch of InceptionA/C/E averages with
  ``count_include_pad=False``;
* the second InceptionE (Mixed_7c) max-pools in its pool branch (padded
  with -inf);
* inputs resize to 299x299 (bilinear, half-pixel, antialiased when
  shrinking, as ``jax.image.resize`` is) and map to [-1, 1].

BatchNorm is inference-only with eps 1e-3 (not torch's 1e-5).  Parameter
names are torchvision's (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_mean``, ...), so a torchvision or
pytorch-fid state dict loads after ``inception_from_torch`` drops its
classifier; ``inception_from_jax`` takes the JAX package's Flax tree.
NCHW inside; images are NHWC uint8 or [0, 1] float at the boundary.  The
features run in exact f32 (``runtime.precise_matmuls``), as the JAX
package pins them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.runtime import precise_matmuls, resolve_device

FID_DIMS = 2048
BN_EPS = 1e-3

_Pair = Union[int, Tuple[int, int]]


class FrozenBatchNorm(nn.Module):
    """Inference-only BatchNorm: ``x * inv + (bias - mean * inv)`` with
    ``inv = weight / sqrt(running_var + 1e-3)``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None] + shift[:, None, None]


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: _Pair,
                 stride: int = 1, padding: _Pair = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm(out_ch)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_s1(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_s1(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_s1(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """pytorch-fid's FIDInceptionE_1 (Mixed_7b: average pool without the
    padding counted) and FIDInceptionE_2 (Mixed_7c: max pool)."""

    def __init__(self, in_ch: int, max_pool: bool):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        if self.max_pool:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3_s1(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW bilinear resize to (size, size), half-pixel, antialiased when
    shrinking (``jax.image.resize(..., "bilinear")``)."""
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


class InceptionV3Features(nn.Module):
    """The trunk to the 2048-d pool3 features.  Input: NCHW float in
    [0, 1] at any resolution, resized to 299 and mapped to [-1, 1].
    ``resize_input=False`` keeps the input's size; the tests use it to run
    the trunk on 75-px images."""

    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, max_pool=False)
        self.Mixed_7c = InceptionE(2048, max_pool=True)

    def forward(self, x):
        if self.resize_input and tuple(x.shape[2:]) != (299, 299):
            x = resize_bilinear(x, 299)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> (B, 2048)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_JAX_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}


def inception_from_torch(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision / pytorch-fid InceptionV3 state dict -> this module's
    state dict: the classifier (``fc.*``, ``AuxLogits.*``) and
    ``num_batches_tracked`` dropped; any other key that is not a conv
    weight or a BatchNorm leaf raises."""
    out: Dict[str, torch.Tensor] = {}
    for key, w in state_dict.items():
        parts = key.split(".")
        if parts[0] in ("fc", "AuxLogits"):
            continue  # classifier head, not part of the feature trunk
        *mods, leaf = parts
        if mods and mods[-1] == "bn" and leaf == "num_batches_tracked":
            continue
        if not mods or not ((mods[-1] == "conv" and leaf == "weight")
                            or (mods[-1] == "bn" and leaf in _BN_LEAVES)):
            raise ValueError(f"unexpected inception key {key!r}")
        out[key] = torch.tensor(np.asarray(w, np.float32))
    return out


def inception_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's Flax tree (numpy leaves) -> this module's state
    dict: kernels HWIO -> OIHW, BatchNorm scale/bias/mean/var ->
    weight/bias/running_mean/running_var."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])
            elif k == "kernel":
                out[".".join(path + ["weight"])] = torch.as_tensor(
                    np.asarray(v, np.float32).transpose(3, 2, 0, 1).copy())
            else:
                out[".".join(path + [_JAX_BN[k]])] = torch.tensor(
                    np.asarray(v, np.float32))

    walk(params, [])
    return out


@torch.no_grad()
def _random_init_(model: InceptionV3Features, gen: torch.Generator) -> None:
    """Seeded weights: He-normal convolution kernels (so the activations
    keep their scale through the 94 ReLU layers) and identity BatchNorms."""
    for name, p in model.named_parameters():
        if name.endswith("conv.weight"):
            fan_in = int(np.prod(p.shape[1:]))
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    * (2.0 / fan_in) ** 0.5)


def load_inception(weights_path=None, device=None) -> InceptionV3Features:
    """A frozen f32 ``InceptionV3Features`` on ``device`` (the card unless
    the caller asks otherwise).  ``weights_path``: a torch ``.pth``/``.pt``
    state dict (torchvision inception_v3 or pytorch-fid's pt_inception
    file) or an ``.npz`` of the JAX package's converted leaves
    (``/``-joined keys); ``None`` -> random weights from seed 0 (smoke
    runs only)."""
    dev = resolve_device(device)
    if weights_path is None:
        with torch.device(dev):
            model = InceptionV3Features()
        _random_init_(model, torch.Generator(device=dev).manual_seed(0))
        return model.float().eval().requires_grad_(False)
    p = str(weights_path)
    if p.endswith(".npz"):
        tree: Dict[str, Any] = {}
        for k, v in np.load(p).items():
            d = tree
            *path, leaf = k.split("/")
            for part in path:
                d = d.setdefault(part, {})
            d[leaf] = v
        sd = inception_from_jax(tree)
    else:
        sd = torch.load(p, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        sd = inception_from_torch(sd)
    with torch.device("meta"):
        model = InceptionV3Features()
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(dev).float().eval().requires_grad_(False)


@torch.no_grad()
def fid_features(model: InceptionV3Features, images,
                 batch_size: int = 64) -> np.ndarray:
    """uint8 or [0, 1] float NHWC images -> (N, 2048) f32 activations in
    batches of ``batch_size`` (the last one runs short, unpadded)."""
    dev = next(model.parameters()).device
    images = np.asarray(images)
    out = []
    with precise_matmuls():
        for i in range(0, len(images), batch_size):
            x = torch.tensor(images[i:i + batch_size], device=dev)
            x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
            out.append(model(x.permute(0, 3, 1, 2)).cpu().numpy())
    return np.concatenate(out, axis=0)


def make_fid_extractor(weights_path=None, batch_size: int = 64, device=None
                       ) -> Callable[[Any], np.ndarray]:
    """Callable(images) -> (N, 2048) for ``evals.scorers.fid_between_folders``."""
    model = load_inception(weights_path, device=device)
    return lambda images: fid_features(model, images, batch_size=batch_size)
