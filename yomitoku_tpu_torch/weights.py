"""Weights of the port's models (counterpart of yomitoku_tpu/weights.py and
yomitoku_tpu/models/weights_convert.py).

* ``load_pretrained``: a reference-layout torch ``state_dict`` from the
  weight store the JAX package also reads (``$YOMITOKU_TPU_WEIGHTS``,
  ``<repo>/pytorch_model.bin`` or ``model.safetensors``; the lookup is the
  port's own copy of yomitoku_tpu/weights.py's) loads as it is;
  without one the model keeps its seeded random init, with the JAX
  package's loud warning.
* ``state_dict_from_jax``: the JAX package's parameters (numpy arrays) as
  the port's ``state_dict``: the inverse of ``convert_parseq`` /
  ``convert_dbnet`` / ``convert_rtdetr``.  HWIO -> OIHW, (in, out) ->
  (out, in), q/k/v packed back into one (3D, D) projection; FrozenBN
  statistics map unchanged.
"""

import os
from pathlib import Path

import numpy as np
import torch

from .utils.logger import set_logger

logger = set_logger(__name__, "INFO")


def weights_dir() -> Path:
    d = os.environ.get("YOMITOKU_TPU_WEIGHTS")
    if d:
        return Path(d)
    return Path.home() / ".cache" / "yomitoku_tpu" / "weights"


def _repo_name(cfg) -> str:
    return str(cfg.hf_hub_repo).split("/")[-1]


def _find_torch_checkpoint(cfg):
    base = weights_dir() / _repo_name(cfg)
    for name in ("model.safetensors", "pytorch_model.bin"):
        for cand in (base / name, weights_dir() / f"{_repo_name(cfg)}_{name}"):
            if cand.exists():
                return cand
    return None


def load_torch_state_dict(path: Path) -> dict:
    """A torch checkpoint as a dict of numpy arrays (safetensors or a
    pickled state_dict)."""
    if path.suffix == ".safetensors":
        from safetensors.numpy import load_file

        return load_file(str(path))
    sd = torch.load(str(path), map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() for k, v in sd.items()}


def load_pretrained(model, cfg):
    """Load the reference checkpoint for ``cfg`` into ``model`` if the
    store holds one; otherwise warn and keep the seeded random init."""
    path = _find_torch_checkpoint(cfg)
    if path is not None:
        logger.info(f"Loading torch checkpoint {path}")
        model.load_reference_state_dict(load_torch_state_dict(path))
        model.pretrained_source = "torch"
        return
    logger.warning(
        f"No pretrained weights found for {cfg.hf_hub_repo} in {weights_dir()} "
        "— using RANDOM initialization. Place the torch checkpoint "
        f"({_repo_name(cfg)}/model.safetensors) in the weight store for real "
        "predictions."
    )


# ------------------------------------------------------------ JAX -> port


def _linear(p):
    """flax Dense {kernel (in, out), bias} -> torch (weight, bias)."""
    return np.transpose(p["kernel"]), p["bias"]


def _conv(k):
    """flax HWIO -> torch OIHW."""
    return np.transpose(k, (3, 2, 0, 1))


def _conv_transpose(k):
    """flax ConvTranspose (kh, kw, in, out), spatially flipped -> torch
    ConvTranspose2d (in, out, kh, kw)."""
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


class _Writer:
    def __init__(self):
        self.sd = {}

    def put(self, key, value):
        self.sd[key] = torch.from_numpy(np.array(value, np.float32))

    def linear(self, prefix, p):
        w, b = _linear(p)
        self.put(f"{prefix}.weight", w)
        self.put(f"{prefix}.bias", b)

    def layernorm(self, prefix, p):
        self.put(f"{prefix}.weight", p["scale"])
        self.put(f"{prefix}.bias", p["bias"])

    def conv(self, prefix, p):
        self.put(f"{prefix}.weight", _conv(p["kernel"]))
        if "bias" in p:
            self.put(f"{prefix}.bias", p["bias"])

    def bn(self, prefix, p):
        for src, dst in (("scale", "weight"), ("bias", "bias"),
                         ("mean", "running_mean"), ("var", "running_var")):
            self.put(f"{prefix}.{dst}", p[src])

    def packed(self, prefix, p, weight_key, bias_key, out_prefix):
        """q/k/v denses -> one packed (3D, D) projection + out denses."""
        ws, bs = zip(*(_linear(p[f"{n}_proj"]) for n in "qkv"))
        self.put(f"{prefix}.{weight_key}", np.concatenate(ws, 0))
        self.put(f"{prefix}.{bias_key}", np.concatenate(bs, 0))
        self.linear(f"{prefix}.{out_prefix}", p["out_proj"])


def _parseq_state_dict(params, model):
    w = _Writer()
    enc = params["encoder"]
    w.conv("encoder.patch_embed.proj", enc["patch_embed"]["proj"])
    w.put("encoder.pos_embed", enc["pos_embed"])
    w.layernorm("encoder.norm", enc["norm"])
    for i in range(len(model.encoder.blocks)):
        p, b = f"encoder.blocks.{i}", enc[f"blocks_{i}"]
        w.layernorm(f"{p}.norm1", b["norm1"])
        w.packed(f"{p}.attn", b["attn"], "qkv.weight", "qkv.bias", "proj")
        w.layernorm(f"{p}.norm2", b["norm2"])
        w.linear(f"{p}.mlp.fc1", b["mlp"]["fc1"])
        w.linear(f"{p}.mlp.fc2", b["mlp"]["fc2"])
    dec = params["decoder"]
    w.layernorm("decoder.norm", dec["norm"])
    for i in range(len(model.decoder.layers)):
        p, d = f"decoder.layers.{i}", dec[f"layers_{i}"]
        for attn in ("self_attn", "cross_attn"):
            w.packed(f"{p}.{attn}", d[attn], "in_proj_weight",
                     "in_proj_bias", "out_proj")
        w.linear(f"{p}.linear1", d["mlp"]["fc1"])
        w.linear(f"{p}.linear2", d["mlp"]["fc2"])
        for n in ("norm1", "norm2", "norm_q", "norm_c"):
            w.layernorm(f"{p}.{n}", d[n])
    w.linear("head", params["head"])
    w.put("text_embed.embedding.weight", params["text_embed"]["embedding"])
    w.put("pos_queries", params["pos_queries"])
    return w.sd


def _dbnet_state_dict(params, model):
    w = _Writer()
    bb = params["backbone"]
    w.conv("backbone.body.conv1", bb["conv1"])
    w.bn("backbone.body.bn1", bb["bn1"])
    for li, blocks in enumerate((3, 4, 6, 3)):
        for bi in range(blocks):
            p, b = f"backbone.body.layer{li + 1}.{bi}", bb[f"layer{li + 1}_{bi}"]
            for j in (1, 2, 3):
                w.conv(f"{p}.conv{j}", b[f"conv{j}"])
                w.bn(f"{p}.bn{j}", b[f"bn{j}"])
            if bi == 0:
                w.conv(f"{p}.downsample.0", b["downsample_conv"])
                w.bn(f"{p}.downsample.1", b["downsample_bn"])
    dec = params["decoder"]
    for L in ("layer1", "layer2", "layer3", "layer4"):
        w.conv(f"decoder.input_proj.{L}", dec[f"input_proj_{L}"])
        suffix = "" if L == "layer1" else ".0"
        w.conv(f"decoder.out_proj.{L}{suffix}", dec[f"out_proj_{L}"])
    w.conv("decoder.binarize.0", dec["bin0"]["conv"])
    w.bn("decoder.binarize.1", dec["bin0"]["bn"])
    for idx, name in ((3, "bin_up1"), (6, "bin_up2")):
        w.put(f"decoder.binarize.{idx}.weight", _conv_transpose(dec[name]["kernel"]))
        w.put(f"decoder.binarize.{idx}.bias", dec[name]["bias"])
    w.bn("decoder.binarize.4", dec["bin_bn1"])
    ca, ea = "decoder.concat_attention", dec["concat_attention"]
    w.conv(f"{ca}.conv", ea["conv"])
    e = ea["enhanced_attention"]
    for dst, src in (("channel_wise.1", "cw_fc1"), ("channel_wise.3", "cw_fc2"),
                     ("spatial_wise.0", "sw_conv1"), ("spatial_wise.2", "sw_conv2"),
                     ("attention_wise.0", "attn")):
        w.conv(f"{ca}.enhanced_attention.{dst}", e[src])
    return w.sd


def _rtdetr_state_dict(params, model):
    """Inverse of ``convert_rtdetr``.  The JAX decoder holds only the score
    head of ``eval_idx``; the reference checkpoints (and the port, so that
    they load strictly) hold one per layer: the others keep ``model``'s own
    values."""
    w = _Writer()

    def conv_norm(prefix, p):
        w.conv(f"{prefix}.conv", p["conv"])
        w.bn(f"{prefix}.norm", p["norm"])

    def mlp(prefix, p):
        for j in range(len(p)):
            w.linear(f"{prefix}.layers.{j}", p[f"layers_{j}"])

    def csp(prefix, p):
        for name in ("conv1", "conv2", "conv3"):
            if name in p:
                conv_norm(f"{prefix}.{name}", p[name])
        for j in range(sum(k.startswith("bottlenecks_") for k in p)):
            for name in ("conv1", "conv2"):
                conv_norm(f"{prefix}.bottlenecks.{j}.{name}",
                          p[f"bottlenecks_{j}"][name])

    bb = params["backbone"]
    for name in ("conv1_1", "conv1_2", "conv1_3"):
        conv_norm(f"backbone.conv1.{name}", bb[name])
    for si, layer in enumerate(model.backbone.res_layers):
        for bi in range(len(layer.blocks)):
            p, b = f"backbone.res_layers.{si}.blocks.{bi}", bb[f"stage{si}_{bi}"]
            for name in ("branch2a", "branch2b", "branch2c"):
                conv_norm(f"{p}.{name}", b[name])
            if "short_conv" in b:
                # variant d: stride-2 shortcuts are (pool, conv)
                conv_norm(f"{p}.short.conv" if si else f"{p}.short", b["short_conv"])

    enc, E = params["encoder"], model.encoder
    for i in range(len(E.input_proj)):
        w.conv(f"encoder.input_proj.{i}.conv", enc[f"input_proj_{i}_conv"])
        w.bn(f"encoder.input_proj.{i}.norm", enc[f"input_proj_{i}_norm"])
    for k, e in enumerate(E.encoder):
        for li in range(len(e.layers)):
            p, lp = f"encoder.encoder.{k}.layers.{li}", enc[f"encoder_{k}_layer_{li}"]
            w.packed(f"{p}.self_attn", lp["self_attn"], "in_proj_weight",
                     "in_proj_bias", "out_proj")
            for name in ("linear1", "linear2"):
                w.linear(f"{p}.{name}", lp[name])
            for name in ("norm1", "norm2"):
                w.layernorm(f"{p}.{name}", lp[name])
    for i in range(len(E.lateral_convs)):
        conv_norm(f"encoder.lateral_convs.{i}", enc[f"lateral_convs_{i}"])
        csp(f"encoder.fpn_blocks.{i}", enc[f"fpn_blocks_{i}"])
        conv_norm(f"encoder.downsample_convs.{i}", enc[f"downsample_convs_{i}"])
        csp(f"encoder.pan_blocks.{i}", enc[f"pan_blocks_{i}"])

    dec, D = params["decoder"], model.decoder
    for i in range(len(D.input_proj)):
        w.conv(f"decoder.input_proj.{i}.conv", dec[f"input_proj_{i}_conv"])
        w.bn(f"decoder.input_proj.{i}.norm", dec[f"input_proj_{i}_norm"])
    w.linear("decoder.enc_output.proj", dec["enc_output_proj"])
    w.layernorm("decoder.enc_output.norm", dec["enc_output_norm"])
    w.linear("decoder.enc_score_head", dec["enc_score_head"])
    mlp("decoder.enc_bbox_head", dec["enc_bbox_head"])
    mlp("decoder.query_pos_head", dec["query_pos_head"])
    for i in range(D.num_layers):
        p, lp = f"decoder.decoder.layers.{i}", dec[f"layers_{i}"]
        w.packed(f"{p}.self_attn", lp["self_attn"], "in_proj_weight",
                 "in_proj_bias", "out_proj")
        for name in ("sampling_offsets", "attention_weights", "value_proj",
                     "output_proj"):
            w.linear(f"{p}.cross_attn.{name}", lp["cross_attn"][name])
        for name in ("linear1", "linear2"):
            w.linear(f"{p}.{name}", lp[name])
        for name in ("norm1", "norm2", "norm3"):
            w.layernorm(f"{p}.{name}", lp[name])
        mlp(f"decoder.dec_bbox_head.{i}", dec[f"dec_bbox_head_{i}"])
        if f"dec_score_head_{i}" in dec:
            w.linear(f"decoder.dec_score_head.{i}", dec[f"dec_score_head_{i}"])
        else:
            head = D.dec_score_head[i]
            w.put(f"decoder.dec_score_head.{i}.weight", head.weight.float().cpu())
            w.put(f"decoder.dec_score_head.{i}.bias", head.bias.float().cpu())
    return w.sd


def state_dict_from_jax(params, model) -> dict:
    """The JAX package's parameter pytree ({"params": ...} of numpy arrays)
    as a state_dict for the port's ``model`` (a PARSeq, a DBNet or an
    RTDETRv2)."""
    from .models.dbnet import DBNet
    from .models.parseq import PARSeq
    from .models.rtdetr import RTDETRv2

    params = params.get("params", params)
    if isinstance(model, PARSeq):
        return _parseq_state_dict(params, model)
    if isinstance(model, DBNet):
        return _dbnet_state_dict(params, model)
    if isinstance(model, RTDETRv2):
        return _rtdetr_state_dict(params, model)
    raise TypeError(f"no JAX parameter mapping for {type(model).__name__}")
