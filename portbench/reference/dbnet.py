"""DBNet++ text detector as upstream YomiToku builds it (dbnet_plus.py):
torchvision ResNet-50 with the last stage dilated (features at /4, /8,
/16, /16), frozen BatchNorm, an FPN decoder (1x1 input projections, top-
down bilinear adds, 3x3 output projections to hidden/4, upsampled to /4),
the scale-feature-selection attention over the four levels, and the
binarize head (3x3 conv, BN, ReLU, 2x2 transposed conv, BN, ReLU, 2x2
transposed conv, sigmoid).  The adaptive-threshold head is not evaluated
at inference and is not built."""

import torch
import torch.nn.functional as F

LAYERS = (3, 4, 6, 3)
LEVELS = ("layer1", "layer2", "layer3", "layer4")


def param_spec(c):
    """[(name, shape, kind, fan_in)] of DBNet with the widths of ``c`` (the
    configuration's ``text_detector`` entry)."""
    spec = []

    def conv(name, cout, cin, k, bias=False):
        spec.append((f"{name}.weight", (cout, cin, k, k), "weight", cin * k * k))
        if bias:
            spec.append((f"{name}.bias", (cout,), "bias", None))

    def bn(name, ch):
        spec.append((f"{name}.weight", (ch,), "norm_weight", None))
        spec.append((f"{name}.bias", (ch,), "bias", None))
        spec.append((f"{name}.running_mean", (ch,), "bias", None))
        spec.append((f"{name}.running_var", (ch,), "variance", None))

    body = "backbone.body"
    conv(f"{body}.conv1", 64, 3, 7)
    bn(f"{body}.bn1", 64)
    inplanes, planes = 64, 64
    for li, blocks in enumerate(LAYERS):
        for bi in range(blocks):
            p = f"{body}.layer{li + 1}.{bi}"
            cin = inplanes if bi == 0 else planes * 4
            conv(f"{p}.conv1", planes, cin, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if bi == 0:
                conv(f"{p}.downsample.0", planes * 4, cin, 1)
                bn(f"{p}.downsample.1", planes * 4)
        inplanes, planes = planes * 4, planes * 2
    d = c["hidden_dim"]
    for name, cin in zip(LEVELS, c["in_channels"]):
        conv(f"decoder.input_proj.{name}", d, cin, 1)
        conv(f"decoder.out_proj.{name}" + ("" if name == "layer1" else ".0"), d // 4, d, 3)
    conv("decoder.binarize.0", d // 4, d, 3)
    bn("decoder.binarize.1", d // 4)
    q = d // 4
    spec.append(("decoder.binarize.3.weight", (q, q, 2, 2), "weight", q * 4))
    spec.append(("decoder.binarize.3.bias", (q,), "bias", None))
    bn("decoder.binarize.4", q)
    spec.append(("decoder.binarize.6.weight", (q, 1, 2, 2), "weight", q * 4))
    spec.append(("decoder.binarize.6.bias", (1,), "bias", None))
    a = "decoder.concat_attention"
    conv(f"{a}.conv", q, d, 3, bias=True)
    conv(f"{a}.enhanced_attention.channel_wise.1", q // 4, q, 1)
    conv(f"{a}.enhanced_attention.channel_wise.3", q, q // 4, 1)
    conv(f"{a}.enhanced_attention.spatial_wise.0", 1, 1, 3)
    conv(f"{a}.enhanced_attention.spatial_wise.2", 1, 1, 1)
    conv(f"{a}.enhanced_attention.attention_wise.0", 4, q, 1)
    return spec


def _bn(x, p, name):
    scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + 1e-5)
    shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def _conv(x, p, name, prec, stride=1, dilation=1):
    w = p[f"{name}.weight"]
    pad = dilation * (w.shape[-1] - 1) // 2
    return prec.conv2d(x, w, p.get(f"{name}.bias"), stride, pad, dilation)


def _up(x, hw):
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def backbone(p, x, prec):
    """(B, 3, H, W) -> {layer1..layer4} features."""
    body = "backbone.body"
    x = F.relu(_bn(prec.conv2d(x, p[f"{body}.conv1.weight"], None, 2, 3), p, f"{body}.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    feats, dilation = {}, 1
    for li, blocks in enumerate(LAYERS):
        stride = 1 if li == 0 else 2
        prev = dilation
        if li == 3:  # the last stage dilated instead of strided
            dilation, stride = dilation * 2, 1
        for bi in range(blocks):
            b = f"{body}.layer{li + 1}.{bi}"
            s, dil = (stride, prev) if bi == 0 else (1, dilation)
            out = F.relu(_bn(_conv(x, p, f"{b}.conv1", prec), p, f"{b}.bn1"))
            out = F.relu(_bn(_conv(out, p, f"{b}.conv2", prec, s, dil), p, f"{b}.bn2"))
            out = _bn(_conv(out, p, f"{b}.conv3", prec), p, f"{b}.bn3")
            if bi == 0:
                x = _bn(_conv(x, p, f"{b}.downsample.0", prec, s), p, f"{b}.downsample.1")
            x = F.relu(out + x)
        feats[f"layer{li + 1}"] = x
    return feats


def forward(p, x, prec):
    """(B, 3, H, W) standardized float32 -> (B, H, W) probability map."""
    feats = backbone(p, x, prec)
    proj = {n: _conv(feats[n], p, f"decoder.input_proj.{n}", prec) for n in LEVELS}
    for top, bottom in (("layer3", "layer4"), ("layer2", "layer3"), ("layer1", "layer2")):
        b = proj[bottom]
        if b.shape[-2:] != proj[top].shape[-2:]:
            b = _up(b, proj[top].shape[-2:])
        proj[top] = proj[top] + b
    hw = proj["layer1"].shape[-2:]
    outs = []
    for n in reversed(LEVELS):  # layer4 .. layer1
        o = _conv(proj[n], p, f"decoder.out_proj.{n}" + ("" if n == "layer1" else ".0"), prec)
        outs.append(o if o.shape[-2:] == hw else _up(o, hw))
    a = "decoder.concat_attention"
    e = f"{a}.enhanced_attention"
    g = _conv(torch.cat(outs, 1), p, f"{a}.conv", prec)
    ch = F.relu(_conv(F.adaptive_avg_pool2d(g, 1), p, f"{e}.channel_wise.1", prec))
    g = torch.sigmoid(_conv(ch, p, f"{e}.channel_wise.3", prec)) + g
    s = F.relu(_conv(g.mean(1, keepdim=True), p, f"{e}.spatial_wise.0", prec))
    g = torch.sigmoid(_conv(s, p, f"{e}.spatial_wise.2", prec)) + g
    score = torch.sigmoid(_conv(g, p, f"{e}.attention_wise.0", prec))
    fuse = torch.cat([score[:, i:i + 1] * outs[i] for i in range(4)], 1)
    y = F.relu(_bn(_conv(fuse, p, "decoder.binarize.0", prec), p, "decoder.binarize.1"))
    y = prec.conv_transpose2d(y, p["decoder.binarize.3.weight"], p["decoder.binarize.3.bias"], 2)
    y = F.relu(_bn(y, p, "decoder.binarize.4"))
    y = prec.conv_transpose2d(y, p["decoder.binarize.6.weight"], p["decoder.binarize.6.bias"], 2)
    return torch.sigmoid(y)[:, 0]
