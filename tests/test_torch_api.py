"""The port's public API against the JAX package's: every module both
packages have, walked for its public functions and classes (and the
public methods of its classes; a flax module's fields are its framework's,
so only its name counts), finds nothing that JAX has and the port lacks
but the listed JAX-only names, each with its reason (ROADMAP.md queue 2,
"Not queued"); ``NOT_YET``, the names queued for a later slice, is
empty.  The public callables both have take JAX's parameters in JAX's
order with JAX's defaults, up to what the frameworks make differ (the
port's explicit ``device``, its ``dtype``, a kept ``executor``, an
explicit device list), and the listed differences."""

import importlib
import inspect
import pkgutil
import sys
import types

import flax.linen as fnn
import pytest

import yomitoku_tpu
import yomitoku_tpu_torch

#: JAX-only names and why the port has none (ROADMAP.md queue 2, "Not queued")
JAX_ONLY = {
    "base.enable_compilation_cache": "XLA's persistent compilation cache",
    "models.base.JaxModel": "the flax wrapper (parameter pytree, jitted programs); "
                            "the port's is models/base.py TorchModel",
    "models.base.default_compute_dtype": "picks bf16 by JAX backend; the port's "
                                         "models/base.py default_dtype",
    "models.base.on_host_cpu": "a JAX default-device context",
    "models.dbnet.ConvBNReLU": "flax module structure",
    "models.dbnet.DBNetCore": "flax module structure (the port's DBNet holds it)",
    "models.parseq.PARSeqCore": "flax module structure (the port's PARSeq holds it)",
    "models.rtdetr.RTDETRv2Core": "flax module structure (the port's RTDETRv2 holds it)",
    "models.layers.resnet.BNParams": "flax parameter holder of the Pallas bottleneck",
    "models.layers.resnet.ConvParams": "flax parameter holder of the Pallas bottleneck",
    "models.layers.resnet.BottleneckFoldedParams": "flax parameter holder of the "
                                                   "Pallas bottleneck",
    "models.layers.resnet.conv": "a lax convolution helper",
    "models.layers.attention.layer_norm": "a functional LayerNorm; the port's "
                                          "layers are nn.LayerNorm",
    "models.layers.rtdetr_decoder.bilinear_sample_zeros": "the JAX plain version of "
                                                          "kernel 5's gather",
    "models.layers.rtdetr_decoder.deformable_attention_core": "the JAX plain version of "
                                                              "kernel 5",
    "models.dbnet.DBNet.convert_torch_state_dict": "the JAX weight format "
                                                   "(models/weights_convert.py)",
    "models.parseq.PARSeq.convert_torch_state_dict": "the JAX weight format",
    "models.rtdetr.RTDETRv2.convert_torch_state_dict": "the JAX weight format",
    "models.dbnet.DBNet.init_params": "a JAX parameter pytree",
    "models.parseq.PARSeq.init_params": "a JAX parameter pytree",
    "models.rtdetr.RTDETRv2.init_params": "a JAX parameter pytree",
    "weights.load_params_msgpack": "the JAX side's msgpack weights",
    "weights.save_params_msgpack": "the JAX side's msgpack weights",
    "weights.load_pretrained_params": "returns a JAX parameter pytree; the port's "
                                      "weights.load_pretrained loads the module",
    "weights.seeded_normal": "a JAX init helper; the port draws from torch.Generator",
    "native.depth_to_space_u8": "ops/dbnet_head.py's packed TPU layout",
    "ops.device_crop.forward_regions_from_page": "the TSR batch buckets, a TPU "
                                                 "workaround",
    "ops.separable_resize.mats_separable": "the separable line program, a TPU workaround",
    "ops.separable_resize.mats_separable_mask": "the separable line program",
    "ops.separable_resize.sample_lines_separable": "the separable line program",
}
#: queued for a later bring-up slice (ROADMAP.md queue 2): none left
NOT_YET = set()

#: parameters the port adds: its explicit devices, its compute dtype, its
#: kept worker pools
PORT_EXTRA = {"device", "devices", "dtype", "executor"}
#: deliberate differences of signature, each with its reason
SIGNATURE_DIFFS = {
    "models.dbnet.DBNet.forward_binary_u8": "the host entries return the u8 wire map "
                                           "(JAX's as_u8=True); the float map is "
                                           "forward_binary",
    "models.dbnet.DBNet.forward_binary_from_page": "as forward_binary_u8",
    "ops.separable_resize.sample_regions_separable": "chunk is JAX's lax.map size and "
                                                     "valid_wh serves its separable "
                                                     "line program",
    "utils.synthetic_heads.spread_score_heads": "JAX takes a parameter pytree, the "
                                                "port the model",
    "parallel.runner.DataParallel": "JAX replicates a parameter pytree, the port the "
                                    "model (replicas)",
    "parallel.runner.DataParallel.__init__": "as DataParallel",
    "parallel.runner.dp_pages": "forward names the model's method: JAX's raw jitted "
                                "program is _fwd, the port's forward",
    "parallel.mesh.parseq_param_shardings": "JAX takes the parameter pytree, the port "
                                            "the model (its state_dict names the tensors)",
    "parallel.mesh.shard_params": "JAX places a parameter pytree, the port the model "
                                  "(one tensor-parallel row per dp row)",
}


def _modules(pkg):
    return {m.name.split(".", 1)[1]
            for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}


@pytest.fixture(scope="module")
def pairs():
    """(name, JAX module, port module) for every module both have, the MCP
    servers imported under a stubbed ``mcp`` (an optional extra)."""
    fastmcp = types.ModuleType("mcp.server.fastmcp")

    class FastMCP:
        def __init__(self, name):
            pass

        def tool(self):
            return lambda fn: fn

        def resource(self, uri):
            return lambda fn: fn

    fastmcp.FastMCP, fastmcp.Context = FastMCP, object
    common = sorted(_modules(yomitoku_tpu) & _modules(yomitoku_tpu_torch))
    out = []
    servers = ("yomitoku_tpu.cli.mcp_server", "yomitoku_tpu_torch.cli.mcp_server")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "mcp", types.ModuleType("mcp"))
        mp.setitem(sys.modules, "mcp.server", types.ModuleType("mcp.server"))
        mp.setitem(sys.modules, "mcp.server.fastmcp", fastmcp)
        mp.setenv("RESOURCE_DIR", ".")
        for name in servers:
            mp.delitem(sys.modules, name, raising=False)
        for name in common:
            out.append((name, importlib.import_module("yomitoku_tpu." + name),
                        importlib.import_module("yomitoku_tpu_torch." + name)))
        for name in servers:
            sys.modules.pop(name, None)
    return out


def _public(mod):
    """{dotted name: object} of the module's own public functions and
    classes, and of those classes' public members (and __init__ /
    __call__); a flax module contributes its name only."""
    out = {}
    for n, v in vars(mod).items():
        if n.startswith("_") or getattr(v, "__module__", None) != mod.__name__:
            continue
        if not (inspect.isfunction(v) or inspect.isclass(v)):
            continue
        out[n] = v
        if inspect.isclass(v) and not issubclass(v, fnn.Module):
            for a, av in vars(v).items():
                if not a.startswith("_") or a in ("__init__", "__call__", "__getitem__",
                                                  "__len__"):
                    out[f"{n}.{a}"] = av
    return out


def test_modules_walked(pairs):
    names = {n for n, _, _ in pairs}
    assert {"base", "config", "document_analyzer", "table_semantic_parser",
            "parallel.mesh", "parallel.runner", "ops.fused_page", "cli.mcp_server",
            "data.functions", "utils.stagetrace"} <= names
    assert len(names) > 60


def test_no_public_name_missing(pairs):
    missing = set()
    for name, jm, pm in pairs:
        missing |= {f"{name}.{n}" for n in set(_public(jm)) - set(_public(pm))}
    # a JAX-only class's members go with it
    missing = {m for m in missing
               if not any(m.startswith(k + ".") for k in JAX_ONLY)}
    assert missing == set(JAX_ONLY) | NOT_YET, sorted(missing ^ (set(JAX_ONLY) | NOT_YET))


def _norm(value):
    if value is inspect.Parameter.empty:
        return value
    if isinstance(value, str):
        return value.replace("yomitoku_tpu_torch", "yomitoku_tpu")
    name = getattr(value, "__name__", None)
    if name is None and "float" in str(value):
        name = str(value)
    return name.rsplit(".", 1)[-1] if name else value


def _signature(obj):
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    if getattr(obj, "_is_observer", False):
        # a task module's __call__ once its class was first built: the timing
        # observer's wrapper, which holds the function it wraps
        obj = next(c.cell_contents for c in obj.__closure__
                   if inspect.isfunction(c.cell_contents))
    if isinstance(obj, property) or not callable(obj):
        return None
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def test_signatures_match(pairs):
    checked, bad = 0, []
    for name, jm, pm in pairs:
        j, p = _public(jm), _public(pm)
        for n in sorted(set(j) & set(p)):
            top = j[n.split(".")[0]]
            if inspect.isclass(top) and issubclass(top, fnn.Module):
                continue
            sj, sp = _signature(j[n]), _signature(p[n])
            if sj is None or sp is None:
                continue
            checked += 1
            want = [(k, _norm(v.default)) for k, v in sj.parameters.items()]
            got = [(k, _norm(v.default)) for k, v in sp.parameters.items()
                   if k not in PORT_EXTRA or k in sj.parameters]
            same = ([k for k, _ in got[:len(want)]] == [k for k, _ in want]
                    and all(a == b or k == "device"
                            for (k, a), (_, b) in zip(want, got)))
            if not same and f"{name}.{n}" not in SIGNATURE_DIFFS:
                bad.append(f"{name}.{n}: JAX {sj} port {sp}")
            if same and f"{name}.{n}" in SIGNATURE_DIFFS:
                bad.append(f"{name}.{n} is listed as different but matches")
    assert not bad, "\n".join(bad)
    assert checked > 300


def test_ported_api_behaves_as_jax(tmp_path):
    """A few of the names the walk found missing before this port, on the
    same inputs as the JAX package's."""
    import numpy as np

    from yomitoku_tpu import config as jcfg
    from yomitoku_tpu.data import functions as jfn
    from yomitoku_tpu.utils import stagetrace as jst
    from yomitoku_tpu_torch import config as pcfg
    from yomitoku_tpu_torch.data import functions as pfn
    from yomitoku_tpu_torch.data import standardization_image
    from yomitoku_tpu_torch.utils import stagetrace as pst

    img = np.random.default_rng(0).integers(0, 255, (20, 30, 3), np.uint8)
    np.testing.assert_array_equal(standardization_image(img), jfn.standardization_image(img))
    np.testing.assert_array_equal(pfn.array_to_tensor(img), jfn.array_to_tensor(img))
    cfg = {"a": 1, "b": {"c": [1, 2], "d": {"e": "x"}}}
    assert pcfg.Config(cfg).to_yaml() == jcfg.Config(cfg).to_yaml()
    pcfg.save_config(pcfg.Config(cfg), tmp_path / "p.yaml")
    jcfg.save_config(jcfg.Config(cfg), tmp_path / "j.yaml")
    assert (tmp_path / "p.yaml").read_bytes() == (tmp_path / "j.yaml").read_bytes()
    tables = []
    for st in (jst, pst):
        with st.collect() as stats:
            with st.segment("det", "sync", nbytes=2_000_000):
                pass
            st.note("rec", "dispatch", seconds=0.25, nbytes=0)
        table = stats.table(pages=2)
        table["det"]["sync"].pop("ms")
        tables.append(table)
    assert tables[0] == tables[1]
    assert tables[1]["rec"]["dispatch"] == {"ms": 125.0, "n": 0.5}
