"""Base class of the port's models (counterpart of
yomitoku_tpu/models/base.py).

A model is an ``nn.Module`` whose parameter names follow the reference
torch checkpoints' ``state_dict`` layout, so a reference checkpoint loads
as it is.  It lives on one explicit device in one compute dtype: bf16 on
CUDA (as the JAX package computes in bf16 on its accelerator), f32 on the
CPU.  Random initialisation draws from an explicit ``torch.Generator`` on
the CPU, so a seed gives the same weights on every device.
"""

import math

import torch
from torch import nn


def default_dtype(device) -> torch.dtype:
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def cached(owner, slot, tensors, build):
    """``build()``, kept in ``owner.<slot>`` until one of ``tensors``
    changes: new storage or dtype, or an in-place write (a state_dict load
    copies into the parameters and so bumps their versions).  For values
    derived from weights once, such as quantized or BN-folded copies."""
    key = tuple((t.data_ptr(), t._version, t.dtype) for t in tensors)
    hit = owner.__dict__.get(slot)
    if hit is None or hit[0] != key:
        hit = (key, build())
        owner.__dict__[slot] = hit
    return hit[1]


def trunc_normal_(w, std, gen):
    """Normal draws clipped at two standard deviations."""
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen).clamp_(-2, 2) * std)


def lecun_normal_(w, fan_in, gen):
    """Variance 1/fan_in (the JAX package's lecun_normal, up to its exact
    truncation)."""
    trunc_normal_(w, math.sqrt(1.0 / fan_in), gen)


def init_standard_layers(module, gen):
    """Seeded init of the standard layers under ``module``: lecun-normal
    weights and zero biases for Linear / Conv2d / ConvTranspose2d and
    packed attention projections, unit
    scale and zero shift for norms, variance-1/D embeddings."""
    from .layers.resnet import FrozenBatchNorm

    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            # (in, out, kh, kw): the JAX kernel (kh, kw, in, out) fans in
            # over kh * kw * in
            w = m.weight
            lecun_normal_(w, w.shape[0] * w.shape[2] * w.shape[3], gen)
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel(), gen)
        elif isinstance(m, nn.Embedding):
            lecun_normal_(m.weight, m.weight.shape[1], gen)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
        elif isinstance(getattr(m, "in_proj_weight", None), nn.Parameter):
            # packed q/k/v of nn.MultiheadAttention's layout: each (D, D)
            # block fans in over D
            lecun_normal_(m.in_proj_weight, m.in_proj_weight.shape[1], gen)
            nn.init.zeros_(m.in_proj_bias)
            continue
        elif isinstance(m, FrozenBatchNorm):
            for name, value in (("weight", 1.0), ("bias", 0.0),
                                ("running_mean", 0.0), ("running_var", 1.0)):
                getattr(m, name).fill_(value)
            continue
        else:
            continue
        if getattr(m, "bias", None) is not None:
            nn.init.zeros_(m.bias)


class TorchModel(nn.Module):
    """Holds the config, the device, the compute dtype and the parameters.

    Subclasses build their submodules, then call ``finish_init``."""

    #: reference-checkpoint keys that inference never reads
    ignored_checkpoint_keys = ("num_batches_tracked",)

    def __init__(self, cfg, device="cpu", dtype=None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype or default_dtype(self.device)
        #: "torch" when a reference checkpoint was loaded, None for the
        #: seeded random init (weights.py sets it)
        self.pretrained_source = None

    def finish_init(self):
        self.init_weights()
        self.to(device=self.device, dtype=self.dtype)
        self.eval()
        self.requires_grad_(False)

    def init_weights(self, seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        init_standard_layers(self, gen)
        self.init_extra(gen)

    def init_extra(self, gen):
        """Seeded init of the parameters no standard layer owns."""

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def load_reference_state_dict(self, sd: dict):
        """Load a reference-layout state_dict (numpy arrays or tensors),
        dropping the keys inference never reads; every parameter of the
        model must be present."""
        keep = {
            k: torch.as_tensor(v)
            for k, v in sd.items()
            if not any(s in k for s in self.ignored_checkpoint_keys)
        }
        self.load_state_dict(keep, strict=True)
