"""Base class of the port's models (counterpart of
yomitoku_tpu/models/base.py).

A model is an ``nn.Module`` whose parameter names follow the reference
torch checkpoints' ``state_dict`` layout, so a reference checkpoint loads
as it is.  It lives on one explicit device in one compute dtype: bf16 on
CUDA (as the JAX package computes in bf16 on its accelerator), f32 on the
CPU, unless ``YOMITOKU_TPU_DTYPE`` names one, as in the JAX package.
Random initialisation draws from an explicit ``torch.Generator`` on the
CPU, so a seed gives the same weights on every device.

``use_mesh`` attaches a dp mesh (``parallel.mesh``): the model then keeps
one replica per dp device (``replicas``), rebuilt when its weights
change, and its batch entries split their leading axis over them where it
divides evenly (``place_batch``, ``run_placed``), as the JAX package's
``place_batch`` shards it.
"""

import math
import os
import threading

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import batch_sharding
from ..parallel.runner import Replicas, gather, in_replica_worker


#: the names ``YOMITOKU_TPU_DTYPE`` takes, in any case (the JAX package's)
DTYPE_NAMES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
               "f32": torch.float32, "float32": torch.float32}


def default_dtype(device) -> torch.dtype:
    """The compute dtype of a model built without one: the one
    ``YOMITOKU_TPU_DTYPE`` names where it is set (an unknown name raises
    KeyError, as in the JAX package), else bf16 on CUDA and f32 on the
    CPU."""
    env = os.environ.get("YOMITOKU_TPU_DTYPE")
    if env:
        try:
            return DTYPE_NAMES[env.lower()]
        except KeyError:
            raise KeyError(f"YOMITOKU_TPU_DTYPE={env!r}: not one of "
                           f"{', '.join(DTYPE_NAMES)}") from None
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def cached(owner, slot, tensors, build, extra=()):
    """``build()``, kept in ``owner.<slot>`` until one of ``tensors``
    changes: new storage or dtype, or an in-place write (a state_dict load
    copies into the parameters and so bumps their versions), or ``extra``
    (more of the key) does.  For values derived from weights once, such
    as quantized or BN-folded copies."""
    key = (tuple(extra), tuple((t.data_ptr(), t._version, t.dtype) for t in tensors))
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
        self._mesh = None
        self._replica_lock = threading.Lock()

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

    # -- several devices ----------------------------------------------

    #: attributes a replica copies from its model before every call
    replica_attrs = ("pretrained_source",)

    def use_mesh(self, mesh):
        """Attach a (dp, tp) mesh (None detaches it and drops the
        replicas): batch entries split their leading axis over one replica
        per dp device."""
        with self._replica_lock:
            self._mesh = mesh
            if mesh is None:
                self.__dict__.pop("_replica_set", None)

    def replicas(self, devices=None) -> Replicas:
        """The model's one set of replicas, one per device in ``devices``
        (default: the attached mesh's dp devices; ``DataParallel`` names
        its mesh's), built at the first call and again when the devices or
        the weights change (a state_dict load writes into the parameters in
        place and so bumps their versions), as the JAX package drops its
        device copies when its parameters are set."""
        with self._replica_lock:
            devices = [torch.device(d) for d in
                       (self._mesh.dp_devices if devices is None else devices)]
            return cached(self, "_replica_set", [*self.parameters(), *self.buffers()],
                          lambda: Replicas(self, devices), extra=map(str, devices))

    def place_batch(self, x):
        """A batch (a tensor or ndarray, or a tuple of them sharing the
        leading axis) -> one slice per dp device of the mesh when the
        leading axis divides evenly; otherwise the whole batch on this
        model's device, as one slice.  On a replica's worker the batch is
        never split again."""
        xs = x if isinstance(x, tuple) else (x,)
        xs = tuple(torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
                   else a for a in xs)
        n = xs[0].shape[0]
        mesh = self._mesh
        if mesh is None or n == 0 or n % mesh.shape["dp"] or in_replica_worker():
            slices = [tuple(a.to(self.device) for a in xs)]
        else:
            slices = list(zip(*(batch_sharding(mesh, a.ndim).place(a) for a in xs)))
        return slices if isinstance(x, tuple) else [s[0] for s in slices]

    def run_placed(self, fn, x, *static):
        """``fn(model, batch, *static)`` over ``place_batch(x)``: inline on
        this model for one slice; else one slice per replica, each on its
        replica's worker, the outputs gathered on this model's device along
        the leading axis."""
        slices = self.place_batch(x)
        if len(slices) == 1:
            return fn(self, slices[0], *static)
        return gather(self.replicas().run(fn, slices, *static), self.device)

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
