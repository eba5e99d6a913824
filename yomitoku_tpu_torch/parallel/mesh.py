"""Device meshes and placements (the port's counterpart of
yomitoku_tpu/parallel/mesh.py).

The JAX package builds a 2-D ``jax.sharding.Mesh((dp, tp))`` and lets XLA
partition its programs over it.  The port has no sharding framework:
devices are explicit, a ``Mesh`` is a (dp, tp) grid of ``torch.device``s,
and data parallelism is one replica of a model per dp device
(``runner.Replicas``), each fed its slice of the batch.  ``replicated`` and
``batch_sharding`` name the two placements the pipeline uses, and place a
tensor that way.  Tensor parallelism is the JAX module's other half:
``parseq_param_shardings`` is its rule for PARSeq (the vocabulary-sized
head and token embedding split over tp, everything else replicated), and
``shard_params`` places a model by such a rule, one tensor-parallel row
per dp row of the mesh (``tensor_parallel.ShardedModel``).
"""

import numpy as np
import torch

__all__ = ["Mesh", "Placement", "batch_sharding", "dp_mesh", "local_devices", "make_mesh",
           "parseq_param_shardings", "replicated", "shard_batch", "shard_params",
           "to_device"]


def to_device(x, device):
    """``x`` on ``device``: queued without a wait onto a card (the copy is
    ordered on the streams), with one onto the host, whose reader takes
    the bytes at once (an asynchronous copy to the host returns before
    they land)."""
    device = torch.device(device)
    return x.to(device, non_blocking=device.type == "cuda")


class Mesh:
    """A (dp, tp) grid of devices.  ``shape`` maps the axis names to their
    sizes, as ``jax.sharding.Mesh.shape`` does; ``devices`` is the grid,
    a (dp, tp) object array of ``torch.device``."""

    def __init__(self, devices):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError(f"a mesh is a (dp, tp) grid, got {self.devices.shape}")
        self.shape = {"dp": self.devices.shape[0], "tp": self.devices.shape[1]}

    @property
    def dp_devices(self):
        """The first device of each dp row: where a replica and its slice of
        the batch live."""
        return [row[0] for row in self.devices]

    def __repr__(self):
        return f"Mesh(dp={self.shape['dp']}, tp={self.shape['tp']}, {self.devices.tolist()})"


def local_devices(device_type="cuda"):
    """The devices of ``device_type`` this process sees: every card for
    "cuda", the one host for "cpu"."""
    if torch.device(device_type).type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_devices=None, tp: int = 1, devices=None, device_type="cuda") -> Mesh:
    """A (dp, tp) mesh over ``devices`` (default: the first ``n_devices``
    local devices of ``device_type``); dp is the outer axis, so a tp group
    is a run of neighbouring devices."""
    if devices is None:
        devices = local_devices(device_type)
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n % tp != 0:
        raise ValueError(f"n_devices={n} not divisible by tp={tp}")
    grid = np.empty((n // tp, tp), dtype=object)
    for i, d in enumerate(devices):
        grid[i // tp, i % tp] = d
    return Mesh(grid)


def dp_mesh(num_devices=None, device_type="cuda", devices=None):
    """A dp-only mesh for the task modules' ``num_devices``, gated as the
    JAX package's: None, 0 and 1 -> no mesh (one device); -1 -> every
    available device; N -> the first min(N, available).  Returns None
    whenever fewer than two devices would take part.  The available
    devices are ``devices`` where given (tests name the same device twice
    to hold replicas on one host), else the local devices of
    ``device_type``: the cards for CUDA, one for the CPU."""
    if num_devices in (None, 0, 1):
        return None
    devs = list(devices) if devices is not None else local_devices(device_type)
    n = len(devs) if num_devices == -1 else min(int(num_devices), len(devs))
    if n < 2:
        return None
    return make_mesh(devices=devs[:n], tp=1)


class Placement:
    """Where a tensor goes on a mesh: ``spec`` names the mesh axis each of
    its dimensions is split over (None: not split), as a JAX
    PartitionSpec does; an empty spec is a full copy on every dp device."""

    def __init__(self, mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def place(self, x):
        """``x`` (a tensor or ndarray) -> one tensor per dp device: the
        whole of it where replicated, its slice of the leading axis where
        that axis is split over "dp" (which must divide it evenly)."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        devs = self.mesh.dp_devices
        if not self.spec or self.spec[0] != "dp":
            return [to_device(x, d) for d in devs]
        if x.shape[0] % len(devs):
            raise ValueError(f"batch {x.shape[0]} does not split over dp={len(devs)}")
        return [to_device(c, d) for c, d in zip(x.chunk(len(devs)), devs)]

    def place_row(self, x, row):
        """``x`` (a tensor) -> its copies on one dp row of the mesh (``row``:
        the row's tp devices): one slice per device of the row, split
        evenly along the axis the spec names "tp"; without "tp" in the
        spec, the whole of it once, on the row's lead device.  Each is a
        copy with storage of its own, as ``jax.device_put`` makes."""
        row = [torch.device(d) for d in row]
        if "tp" not in self.spec:
            parts, row = [x], row[:1]
        else:
            axis = self.spec.index("tp")
            if x.shape[axis] % len(row):
                raise ValueError(f"axis {axis} of {tuple(x.shape)} does not split over "
                                 f"tp={len(row)}")
            parts = x.chunk(len(row), dim=axis)
        return [p.to(d, non_blocking=d.type == "cuda", copy=True).contiguous()
                for p, d in zip(parts, row)]


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def batch_sharding(mesh: Mesh, ndim: int = 4) -> Placement:
    """Split the leading (batch) axis over dp, the rest whole."""
    return Placement(mesh, ("dp",) + (None,) * (ndim - 1))


def shard_batch(mesh: Mesh, batch):
    """Pad ``batch`` with zeros to a multiple of dp and place it split over
    the dp devices -> ([one slice per dp device], n), n the true size."""
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    dp = mesh.shape["dp"]
    n = batch.shape[0]
    rem = (-n) % dp
    if rem:
        batch = torch.cat([batch, batch.new_zeros((rem,) + tuple(batch.shape[1:]))])
    return batch_sharding(mesh, batch.ndim).place(batch), n


#: PARSeq's vocabulary-sized matrices by state_dict name, each split over
#: tp along its first axis: the head's (V, D) weight, the transpose of
#: JAX's (D, V) ``head/kernel``, and the token embedding (num_tokens, D)
VOCAB_MATRICES = ("head.weight", "text_embed.embedding.weight")


def parseq_param_shardings(model, mesh: Mesh):
    """{state_dict name: Placement} for PARSeq, tensor parallel over the
    vocabulary, by the JAX package's rule:

    - the recognition head's weight (V, D): split V over tp (the largest
      matmul, 7k+ classes);
    - the token embedding (num_tokens, D): split its rows over tp;
    - everything else replicated, the head's bias too (JAX's rule
      replicates every 1-D array).

    A dimension that tp does not divide falls back to replication."""
    tp = mesh.shape["tp"]

    def spec(name, x):
        if x.ndim == 2 and name in VOCAB_MATRICES and x.shape[0] % tp == 0:
            return ("tp", None)
        return ()

    return {name: Placement(mesh, spec(name, x)) for name, x in model.state_dict().items()}


def shard_params(model, shardings):
    """Place ``model`` on the mesh of ``shardings`` -> a
    ``tensor_parallel.ShardedModel``: one row per dp row, each a copy of
    the model on the row's lead device with the split matrices' shards on
    the row's tp devices.  The copies do not follow a later weight load on
    the model, as ``jax.device_put``'s do not."""
    from .tensor_parallel import ShardedModel

    return ShardedModel(model, shardings)
