"""Data-parallel execution over a device mesh (the port's counterpart of
yomitoku_tpu/parallel/runner.py).

The unit of data parallelism follows the workload, as in the JAX package:
pages for DBNet and RT-DETRv2 (a batch of pages or of table crops), lines
for PARSeq.  Where JAX replicates the parameters over the mesh and lets
XLA run one program on every chip, the port keeps one copy of the model
per dp device (``Replicas``) and runs ``fn(replica, slice)`` on each, every
replica on a worker thread of its own that it keeps for its life: PyTorch
keeps cuDNN's convolution plans per thread, so a new thread per call would
plan every convolution again.  Each worker makes its device the current
one; the kernels launch on their tensors' own device anyway.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .mesh import local_devices, make_mesh, shard_batch, to_device

__all__ = ["DataParallel", "KeptPools", "Replicas", "dp_pages", "in_replica_worker"]

_worker = threading.local()


def in_replica_worker() -> bool:
    """Whether this thread serves a replica: a model called there runs its
    slice where it is, never splitting it again."""
    return getattr(_worker, "device", None) is not None


def _bind(device):
    _worker.device = device
    torch.set_grad_enabled(False)  # per thread, as no_grad on the caller's
    if device.type == "cuda":
        torch.cuda.set_device(device)


def same_device(a, b) -> bool:
    """Whether two torch devices name the same device ("cuda" without an
    index is the current card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return (a.index if a.index is not None else cur) == (b.index if b.index is not None else cur)


def replicate(model, device):
    """A copy of a port model on ``device``: the same class built from the
    same config, then the model's state_dict loaded into it, and the
    attributes the class names in ``replica_attrs`` copied."""
    clone = type(model)(model.cfg, device=device, dtype=model.dtype)
    clone.load_state_dict(model.state_dict())
    for name in model.replica_attrs:
        setattr(clone, name, getattr(model, name))
    return clone


def gather(outs, device, axis=0):
    """Per-replica outputs (tensors, or tuples / lists / dicts of them) ->
    one output on ``device``, concatenated along ``axis`` (on the host,
    once every copy has landed)."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([to_device(o, device) for o in outs], dim=axis)
    if isinstance(first, dict):
        return {k: gather([o[k] for o in outs], device, axis) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(gather(list(parts), device, axis) for parts in zip(*outs))
    raise TypeError(f"cannot gather {type(first).__name__}")


class Replicas:
    """One copy of ``model`` per device in ``devices``, each served by one
    kept worker thread.  The model itself serves the device it lies on
    where that device comes first; every other entry is a copy, even on the
    same device (a device list that names one card twice holds two copies
    there)."""

    def __init__(self, model, devices):
        self.devices = [torch.device(d) for d in devices]
        self.models = [
            model if i == 0 and same_device(d, model.device) else replicate(model, d)
            for i, d in enumerate(self.devices)]
        self.workers = [
            ThreadPoolExecutor(max_workers=1, thread_name_prefix=f"replica{i}-{d}",
                               initializer=_bind, initargs=(d,))
            for i, d in enumerate(self.devices)]
        self.owner = model

    def sync_attrs(self):
        """Copy the owner's ``replica_attrs`` (flags such as PARSeq's int8
        cache switch, which an audit may turn off after the copy)."""
        for m in self.models:
            if m is not self.owner:
                for name in self.owner.replica_attrs:
                    setattr(m, name, getattr(self.owner, name))

    def run(self, fn, chunks, *static):
        """``fn(replica, chunk, *static)`` for each replica and its chunk,
        on the replicas' workers, all at once -> the outputs in device
        order.  A replica that fails raises here."""
        self.sync_attrs()
        futures = [w.submit(fn, m, c, *static)
                   for w, m, c in zip(self.workers, self.models, chunks)]
        return [f.result() for f in futures]


class KeptPools:
    """Thread pools kept for their owner's life, one per (kind, size), so
    that the threads keep cuDNN's plans across calls."""

    def __init__(self, prefix):
        self.prefix = prefix
        self._pools = {}
        self._lock = threading.Lock()

    def get(self, kind, n) -> ThreadPoolExecutor:
        with self._lock:
            pool = self._pools.get((kind, n))
            if pool is None:
                pool = self._pools[(kind, n)] = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix=f"{self.prefix}-{kind}")
            return pool


def _numpy_cut(x, axis, n):
    """A gathered host output (tensors, or tuples / lists / dicts of them)
    as numpy, cut to its first ``n`` along ``axis``."""
    if isinstance(x, torch.Tensor):
        return x.numpy()[(slice(None),) * axis + (slice(0, n),)]
    if isinstance(x, dict):
        return {k: _numpy_cut(v, axis, n) for k, v in x.items()}
    return type(x)(_numpy_cut(v, axis, n) for v in x)


class DataParallel:
    """Split the leading batch axis of a model call over a mesh.

    >>> mesh = make_mesh(2, devices=["cuda:0", "cuda:1"])
    >>> run = DataParallel(mesh, lambda m, x: m.forward_u8(x), model)
    >>> out = run(batch)          # batch (N, ...) -> out (N, ...) on the host

    The replicas are the model's own (``TorchModel.replicas`` on the
    mesh's dp devices): made at the first call and kept while the weights
    stand, as the JAX runner places the parameters once.  Each call pads
    the batch with zeros to a multiple of dp, runs ``fn(replica, slice,
    *static)`` on every replica, reads each device's output back once and
    concatenates them on the host along ``batch_axis`` (the axis of the
    OUTPUT that carries the batch), cut to the true size."""

    def __init__(self, mesh, fn, model, batch_axis: int = 0):
        self.mesh = mesh
        self.fn = fn
        self.model = model
        self.batch_axis = batch_axis

    @property
    def replicas(self) -> Replicas:
        return self.model.replicas(self.mesh.dp_devices)

    def __call__(self, batch, *static_args):
        chunks, n = shard_batch(self.mesh, batch)
        outs = self.replicas.run(self.fn, chunks, *static_args)
        return _numpy_cut(gather(outs, torch.device("cpu"), self.batch_axis),
                          self.batch_axis, n)


def dp_pages(model, pages, n_devices=None, forward="forward", devices=None):
    """One-shot page-parallel forward: a dp mesh over the first
    ``n_devices`` local devices of the model's device type (or over
    ``devices``), and ``model.<forward>(slice)`` on each replica -> the
    outputs on the host."""
    if devices is None:
        devices = local_devices(model.device.type)
        if n_devices is not None:
            devices = devices[:n_devices]
    mesh = make_mesh(devices=devices, tp=1)
    runner = DataParallel(mesh, lambda m, x: getattr(m, forward)(x), model)
    return runner(pages)
