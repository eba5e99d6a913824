"""Seeded random weights, made on the device in one draw per model.

Each tensor of a model's parameter spec (the reference's ``param_spec``)
takes a slice of one normal draw from a generator on the device, shaped
by its kind: weights N(0, 1 / fan_in) (LeCun), biases and normalisation
shifts N(0, 0.02^2), normalisation scales 1 + N(0, 0.02^2), running
variances exp(N(0, 0.2^2)), learned positions N(0, 0.02^2).  The tensors are rounded to the dtype the program serves
in; the reference reads the same values in float32."""

import hashlib

import torch


def seed_for(seed, salt):
    """A 63-bit generator seed from the run's seed and a per-model salt."""
    digest = hashlib.sha256(f"{int(seed)}:{salt}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make(spec, seed, salt, device, dtype):
    """{name: tensor of ``dtype`` on ``device``} for ``spec``'s entries."""
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, salt))
    sizes = [torch.Size(shape).numel() for _, shape, _, _ in spec]
    draw = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(spec, sizes):
        z = draw[at:at + n].view(shape)
        at += n
        if kind == "weight":
            t = z / fan_in ** 0.5
        elif kind == "bias":
            t = z * 0.02
        elif kind == "norm_weight":
            t = 1.0 + z * 0.02
        elif kind == "variance":
            t = torch.exp(z * 0.2)
        elif kind == "position":
            t = z * 0.02
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = t.to(dtype)
    return out
