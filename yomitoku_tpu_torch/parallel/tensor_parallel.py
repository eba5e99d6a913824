"""Tensor parallelism over the tp axis of a mesh (the port's counterpart of
what XLA does with the JAX package's ``shard_params``).

JAX places each parameter with a ``NamedSharding`` and lets XLA partition
the program: a matrix split over tp is computed shard by shard, and XLA
inserts the all-gather (the head's logits) and the all-reduce (the
embedding's lookup).  The port has no partitioner, so ``ShardedModel``
writes the two collectives out: a dp row of the mesh holds one copy of
the model whose split modules are replaced by ``SplitLinear`` /
``SplitEmbedding``, which keep one shard per tp device of the row and
gather or sum the shards' results on the row's lead device.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import to_device
from .runner import DataParallel, Replicas, replicate

__all__ = ["ShardedModel", "SplitEmbedding", "SplitLinear"]


def _frozen(tensors):
    return nn.ParameterList([nn.Parameter(t, requires_grad=False) for t in tensors])


class SplitLinear(nn.Module):
    """A Linear split by output features over devices: shard k holds a run
    of rows of the (out, in) weight, and the same slice of the bias, on its
    device.  Each shard computes ``x @ W_k^T + b_k`` on its device; the
    results are gathered along the last axis onto ``lead`` in shard order
    (the all-gather), so an argmax over them breaks ties toward the lower
    shard, as over the whole matrix.

    A shard's rows lie in storage padded with zero rows to a multiple of
    ``PAD`` (``weights[k]`` is the view of the true rows), and its GEMM runs
    on the padded matrix: a bf16 output row of an odd width (3,655 of
    PARSeq's 7,310 classes at tp = 2) is not 16-byte aligned, which sends
    cuBLAS to slower kernels.  The pad columns are cut before the gather."""

    #: output features of a shard's GEMM are rounded up to a multiple of this
    PAD = 8

    def __init__(self, weights, biases, lead):
        super().__init__()
        self.gemms = []  # (padded weight, padded bias, true rows) per shard
        for w, b in zip(weights, biases):
            n = w.shape[0]
            pw = w.new_zeros((-(-n // self.PAD) * self.PAD, w.shape[1]))
            pb = b.new_zeros(pw.shape[0])
            pw[:n], pb[:n] = w, b
            self.gemms.append((pw, pb, n))
        self.weights = _frozen([pw[:n] for pw, _, n in self.gemms])
        self.biases = _frozen([pb[:n] for _, pb, n in self.gemms])
        self.lead = torch.device(lead)

    def forward(self, x):
        return torch.cat([to_device(F.linear(to_device(x, w.device), w, b)[..., :n], self.lead)
                          for w, b, n in self.gemms], dim=-1)


class SplitEmbedding(nn.Module):
    """An Embedding split by rows over devices: shard k holds a run of rows
    of the table on its device.  Each shard looks up the ids that fall in
    its run and zeroes the others; the partial lookups are summed on
    ``lead`` (the all-reduce).  Adding exact zeros leaves every row
    bit-equal to the whole table's lookup, in any dtype."""

    def __init__(self, weights, lead):
        super().__init__()
        self.weights = _frozen(weights)
        self.starts = [0]
        for w in weights[:-1]:
            self.starts.append(self.starts[-1] + w.shape[0])
        self.lead = torch.device(lead)

    def forward(self, ids):
        out = None
        for v0, w in zip(self.starts, self.weights):
            local = to_device(ids, w.device) - v0
            miss = (local < 0) | (local >= w.shape[0])
            part = F.embedding(local.clamp(0, w.shape[0] - 1), w)
            part = to_device(part.masked_fill_(miss[..., None], 0), self.lead)
            out = part if out is None else out + part
        return out


def _split_module(module, name, weight, bias, placement, devices):
    """The tensor-parallel form of ``module`` (the owner of parameter
    ``name``) on one dp row of devices."""
    if placement.spec != ("tp", None) or not name.endswith(".weight"):
        raise ValueError(f"{name}: no tensor-parallel form for spec {placement.spec}")
    shards = placement.place_row(weight, devices)
    if isinstance(module, nn.Linear) and bias is not None:
        sizes = [w.shape[0] for w in shards]
        biases = [b.to(d, copy=True) for b, d in zip(bias.split(sizes), devices)]
        return SplitLinear(shards, biases, devices[0])
    if isinstance(module, nn.Embedding):
        return SplitEmbedding(shards, devices[0])
    raise ValueError(f"{name}: no tensor-parallel form for {type(module).__name__}")


class ShardedModel:
    """A model placed on a (dp, tp) mesh by ``shardings`` (``{state_dict
    name: Placement}``, e.g. ``mesh.parseq_param_shardings``): one
    tensor-parallel row per dp row of the mesh.

    A row is a copy of the model on the row's lead device
    (``Mesh.dp_devices``): the trunk and every replicated parameter lie
    there once.  Each module whose weight is split over tp (a Linear by
    output features, an Embedding by rows) is replaced in the row by its
    split form, whose shards lie one on each tp device of the row.  XLA
    puts a full copy of a replicated parameter on every device; the port
    keeps one per row, because nothing on the row's other devices reads
    it.  The row's other modules run as they do in the model, so every use
    of a split matrix goes through its shards.

    The rows are copies, as ``jax.device_put`` makes them: a later
    ``load_state_dict`` on the model does not reach them (call
    ``shard_params`` again).  The attributes the model's class names in
    ``replica_attrs`` are copied to the rows before every call, as
    ``Replicas`` copies them to replicas.  Each row serves its slice of a
    batch on a kept worker thread of its own (``replicas``), so
    ``DataParallel(mesh, fn, sharded)`` runs ``fn(row, slice)`` per row."""

    def __init__(self, model, shardings):
        placements = list(shardings.values())
        self.mesh = placements[0].mesh
        if any(p.mesh is not self.mesh for p in placements):
            raise ValueError("the shardings name more than one mesh")
        params = model.state_dict()
        unknown = set(shardings) - set(params)
        if unknown:
            raise ValueError(f"shardings for tensors the model lacks: {sorted(unknown)}")
        self.model = model
        split = [n for n, p in shardings.items() if "tp" in p.spec]
        self.rows = []
        for devices in self.mesh.devices:
            devices = list(devices)
            row = replicate(model, devices[0])
            for name in split:
                owner = name.rsplit(".", 1)[0]
                parent, _, child = owner.rpartition(".")
                setattr(row.get_submodule(parent), child, _split_module(
                    row.get_submodule(owner), name, params[name],
                    params.get(owner + ".bias"), shardings[name], devices))
            self.rows.append(row)
        self._replicas = Replicas(model, self.mesh.dp_devices, models=self.rows)

    def replicas(self, devices=None) -> Replicas:
        """The rows with their kept workers (what ``DataParallel`` runs on);
        ``devices``, where given, must be the mesh's dp devices."""
        if devices is not None and [torch.device(d) for d in devices] != self.mesh.dp_devices:
            raise ValueError(f"sharded over {self.mesh}, not over {list(devices)}")
        return self._replicas

    def forward_tokens(self, images):
        """(B, H, W, 3) ndarray -> (ids, probs) ndarrays on the host: the
        batch split over dp (``shard_batch``), each row decoding its slice
        with the model's ``_tokens``, cut to the true size."""
        return DataParallel(self.mesh, type(self.model)._tokens, self)(images)
