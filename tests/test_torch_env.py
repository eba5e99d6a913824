"""The two variables the port reads as the JAX package reads them.

``YOMITOKU_TPU_DTYPE``: ``models.base.default_dtype`` makes the choice of
the JAX package's ``default_compute_dtype`` for each name it takes (in any
case), raises as it does on an unknown name, and falls back to bf16 on
CUDA and f32 on the CPU where it is unset or empty; an explicit ``dtype=``
wins in both packages; a task class built without one takes it.

``YOMITOKU_TPU_NATIVE_DIR``: ``ops._build.build_dir`` picks the directory
as the JAX package's ``native._build_dir`` does (the variable, else the
default beside the package, else the temporary directory where the
default cannot be made); ``host_library`` builds into and loads from it,
with the same output as the default build; the CUDA library is looked up
there; a failed build still raises ``KernelBuildError``."""

import ctypes
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yomitoku_tpu.native as jax_native
from yomitoku_tpu import text_recognizer as jax_rec
from yomitoku_tpu.models import base as jax_base
from yomitoku_tpu.models.parseq import PARSeq as JaxPARSeq
from yomitoku_tpu_torch import native as port_native
from yomitoku_tpu_torch import text_recognizer as port_rec
from yomitoku_tpu_torch.configs import TextRecognizerPARSeqConfig
from yomitoku_tpu_torch.models import base as port_base
from yomitoku_tpu_torch.models.parseq import PARSeq as PortPARSeq
from yomitoku_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
REC_SMALL = str(ROOT / "tests" / "yaml" / "rec_small.yaml")


def _name(dtype):
    """bfloat16 / float32, for either package's dtype."""
    return str(dtype).rsplit(".", 1)[-1] if isinstance(dtype, torch.dtype) \
        else jnp.dtype(dtype).name


# ------------------------------------------------------------------ dtype


@pytest.mark.parametrize("value", ["bf16", "BF16", "bfloat16", "BFloat16", "f32", "F32",
                                   "float32", "Float32"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_dtype_variable_matches_jax(monkeypatch, value, device):
    monkeypatch.setenv("YOMITOKU_TPU_DTYPE", value)
    want = _name(jax_base.default_compute_dtype())
    assert want == ("bfloat16" if "b" in value.lower() else "float32")
    assert _name(port_base.default_dtype(device)) == want


@pytest.mark.parametrize("value", ["fp16", "float16", "bf 16", "int8"])
def test_unknown_dtype_raises_as_jax(monkeypatch, value):
    monkeypatch.setenv("YOMITOKU_TPU_DTYPE", value)
    with pytest.raises(KeyError):
        jax_base.default_compute_dtype()
    with pytest.raises(KeyError, match="YOMITOKU_TPU_DTYPE"):
        port_base.default_dtype("cuda")


@pytest.mark.parametrize("value", [None, ""])
def test_dtype_default_without_the_variable(monkeypatch, value):
    """Unset or empty: the JAX package's CPU backend computes in f32, and
    the port keeps its device rule."""
    if value is None:
        monkeypatch.delenv("YOMITOKU_TPU_DTYPE", raising=False)
    else:
        monkeypatch.setenv("YOMITOKU_TPU_DTYPE", value)
    assert _name(jax_base.default_compute_dtype()) == "float32"
    assert port_base.default_dtype("cpu") == torch.float32
    assert port_base.default_dtype("cuda") == torch.bfloat16
    assert port_base.default_dtype(torch.device("cuda", 0)) == torch.bfloat16


@pytest.mark.parametrize("value", ["bf16", "f32"])
def test_explicit_dtype_wins(monkeypatch, value):
    """A model given a dtype keeps it whatever the variable says; one
    given none takes the variable's, its parameters too."""
    monkeypatch.setenv("YOMITOKU_TPU_DTYPE", value)
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    other = {"bf16": (jnp.float32, torch.float32), "f32": (jnp.bfloat16, torch.bfloat16)}
    jax_dtype, port_dtype = other[value]
    from yomitoku_tpu.config import load_config as jax_load
    from yomitoku_tpu.configs import TextRecognizerPARSeqConfig as JaxConfig
    from yomitoku_tpu_torch.config import load_config as port_load

    jax_cfg, port_cfg = jax_load(JaxConfig, REC_SMALL), port_load(
        TextRecognizerPARSeqConfig, REC_SMALL)
    assert _name(JaxPARSeq(jax_cfg, dtype=jax_dtype).dtype) == _name(jax_dtype)
    explicit = PortPARSeq(port_cfg, device="cpu", dtype=port_dtype)
    assert explicit.dtype == port_dtype
    assert {p.dtype for p in explicit.parameters()} == {port_dtype}
    chosen = PortPARSeq(port_cfg, device="cpu")
    assert _name(chosen.dtype) == _name(JaxPARSeq(jax_cfg).dtype) == (
        "bfloat16" if value == "bf16" else "float32")
    assert {p.dtype for p in chosen.parameters()} == {chosen.dtype}


def test_task_class_takes_the_variable(monkeypatch):
    """TextRecognizer built with no dtype, as the CLI builds its modules,
    computes in the variable's dtype in both packages."""
    monkeypatch.setenv("YOMITOKU_TPU_DTYPE", "bf16")
    monkeypatch.setenv("YOMITOKU_TPU_INT8_KV", "0")
    port = port_rec.TextRecognizer(path_cfg=REC_SMALL, device="cpu", from_pretrained=False)
    jax = jax_rec.TextRecognizer(path_cfg=REC_SMALL, device="cpu", from_pretrained=False)
    assert port.model.dtype == torch.bfloat16
    assert _name(jax.model.dtype) == "bfloat16"


# ------------------------------------------------------------- native dir


@pytest.fixture
def fresh_libraries(monkeypatch):
    """No host library loaded or signed yet in this process, so that a
    call builds and loads it again (and the process's own stay as they
    were for the other tests)."""
    monkeypatch.setattr(_build, "_HOST", {})
    monkeypatch.setattr(port_native, "_SIGNED", set())


def _unmakeable(tmp_path):
    """A directory path that cannot be made: its parent is a file."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    return blocker / "build"


@pytest.mark.parametrize("case", ["named", "default", "unmakeable"])
def test_build_dir_matches_jax(tmp_path, monkeypatch, case):
    """The variable where set, else the default beside the package, else
    the temporary directory: the same choice as the JAX package's."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    jax_default = tmp_path / "jax_pkg"
    jax_default.mkdir()
    port_default = tmp_path / "port_build"
    monkeypatch.delenv("YOMITOKU_TPU_NATIVE_DIR", raising=False)
    if case == "named":
        monkeypatch.setenv("YOMITOKU_TPU_NATIVE_DIR", str(tmp_path / "named"))
    elif case == "unmakeable":
        jax_default = _unmakeable(tmp_path)
        port_default = _unmakeable(tmp_path)
    monkeypatch.setattr(jax_native, "_HERE", jax_default)
    monkeypatch.setattr(_build, "BUILD_DIR", port_default)
    want = jax_native._build_dir()
    got = _build.build_dir()
    assert got.is_dir()
    if case == "named":
        assert got == want == tmp_path / "named"
    elif case == "default":
        assert want == jax_default / "_build" and got == port_default
    else:
        assert want.parent == got.parent == tmp_path / "tmp"
        assert got.name == "yomitoku_tpu_torch"


def _dbnet_output():
    prob = np.zeros((96, 160), np.float32)
    prob[10:30, 20:120] = 0.9
    prob[50:80, 40:70] = 0.8
    return port_native.dbnet_boxes(prob, 0.3, 0.5, 2.0, 2, 100, 320, 192)


def test_host_library_builds_into_the_named_dir(tmp_path, monkeypatch, fresh_libraries):
    """``host_library`` builds into the directory the variable names (made
    if missing), named by its source hash as the default build is, and
    loads it from there; its output equals the default build's."""
    monkeypatch.delenv("YOMITOKU_TPU_NATIVE_DIR", raising=False)
    default = Path(_build.host_library("dbnet_post")._name)
    want = _dbnet_output()
    assert want[0], "the map holds no box"
    monkeypatch.setattr(_build, "_HOST", {})
    monkeypatch.setattr(port_native, "_SIGNED", set())
    named = tmp_path / "native" / "dir"
    monkeypatch.setenv("YOMITOKU_TPU_NATIVE_DIR", str(named))
    lib = _build.host_library("dbnet_post")
    path = Path(lib._name)
    assert path.parent == named and path.name == default.name
    assert _dbnet_output() == want
    assert [p.name for p in named.iterdir()] == [default.name]


def test_unmakeable_default_falls_back_to_the_temporary_dir(tmp_path, monkeypatch,
                                                            fresh_libraries):
    monkeypatch.delenv("YOMITOKU_TPU_NATIVE_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(_build, "BUILD_DIR", _unmakeable(tmp_path))
    lib = _build.host_library("dbnet_post")
    assert Path(lib._name).parent == tmp_path / "tmp" / "yomitoku_tpu_torch"
    assert isinstance(lib, ctypes.CDLL)
    assert _dbnet_output()[0]


def test_cuda_library_is_looked_up_in_the_named_dir(tmp_path, monkeypatch):
    """``build`` loads the CUDA library of this source hash from the
    variable's directory where it is there (no nvcc needed), and where it
    is not and nvcc is missing raises KernelBuildError."""
    loaded = []
    monkeypatch.setattr(_build, "_Library", lambda path, seconds, log: loaded.append(
        (path, seconds)) or path)
    monkeypatch.setenv("YOMITOKU_TPU_NATIVE_DIR", str(tmp_path))
    (tmp_path / f"libyt_kernels_{_build.source_hash()}.so").write_bytes(b"")
    assert _build.build() == tmp_path / f"libyt_kernels_{_build.source_hash()}.so"
    assert loaded == [(tmp_path / f"libyt_kernels_{_build.source_hash()}.so", 0.0)]

    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setenv("YOMITOKU_TPU_NATIVE_DIR", str(tmp_path / "empty"))
    with pytest.raises(_build.KernelBuildError):
        _build.build()
    assert (tmp_path / "empty").is_dir() and not any((tmp_path / "empty").iterdir())


def test_failed_build_in_the_fallback_dir_raises(tmp_path, monkeypatch, fresh_libraries):
    """The fallback only chooses where the library is written: a source
    that does not compile raises KernelBuildError and leaves no file."""
    monkeypatch.delenv("YOMITOKU_TPU_NATIVE_DIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(_build, "BUILD_DIR", _unmakeable(tmp_path))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    with pytest.raises(_build.KernelBuildError, match="broken.cpp"):
        _build.host_library("broken")
    assert not any((tmp_path / "tmp" / "yomitoku_tpu_torch").iterdir())
