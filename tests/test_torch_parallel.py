"""The port's ``parallel/`` against the JAX package's, and the models'
replicas, CPU, f32.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port holds several replicas on the one host by naming the CPU more than
once in a device list.  Held: ``dp_mesh``'s gating and ``make_mesh``'s
shapes and tp check equal to JAX's; ``shard_batch``'s zero padding equal
to JAX's; ``DataParallel`` on a tiny PARSeq's tokens (the batch on the
JAX output's axis 1) over two devices against JAX's over two virtual
devices, ids equal and probs within 1e-4; ``dp_pages`` on the small DBNet
within one u8 quantum of the JAX map and equal to the port's own call.
Replicas: DBNet, RT-DETRv2 and PARSeq under a 2-device mesh against the
same model without one (the u8 map within one quantum; logits and boxes
within 1e-4 of their largest magnitude; ids equal, probs within 2e-4), a
batch that does not divide staying on the model's own device, and a
weight load after ``use_mesh`` reaching every replica."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from yomitoku_tpu import parallel as jpar
from yomitoku_tpu.config import structured as jax_structured
from yomitoku_tpu.configs import TextRecognizerPARSeqTinyConfig as JaxTinyConfig
from yomitoku_tpu.models.parseq import PARSeq as JaxPARSeq
from yomitoku_tpu.models.weights_convert import convert_dbnet
from yomitoku_tpu.text_detector import TextDetector as JaxTextDetector
from yomitoku_tpu_torch import parallel as par
from yomitoku_tpu_torch.config import structured
from yomitoku_tpu_torch.configs import TextRecognizerPARSeqTinyConfig
from yomitoku_tpu_torch.layout_parser import LayoutParser
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.parallel import runner
from yomitoku_tpu_torch.text_detector import TextDetector
from yomitoku_tpu_torch.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
YAML = ROOT / "tests" / "yaml"
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small models gain nothing from more, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")


def _tiny(cfg):
    cfg.encoder.depth = 1
    cfg.encoder.embed_dim = 32
    cfg.encoder.num_heads = 2
    cfg.decoder.embed_dim = 32
    cfg.decoder.num_heads = 2
    cfg.num_tokens = 16
    cfg.max_label_length = 4
    cfg.data.img_size = [16, 32]
    return cfg


@pytest.fixture(scope="module")
def parseq_pair():
    """A tiny PARSeq in both packages on the JAX seeded init."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        jm = JaxPARSeq(_tiny(jax_structured(JaxTinyConfig)))
        pm = PARSeq(_tiny(structured(TextRecognizerPARSeqTinyConfig)), device="cpu")
    jm.params = jm.init_params(0)
    pm.load_state_dict(state_dict_from_jax(jm.params, pm))
    assert not pm.int8_kv
    return jm, pm


@pytest.fixture(scope="module")
def detectors():
    """The small DBNet in both packages on the port's seeded init."""
    port = TextDetector(path_cfg=str(YAML / "det_small.yaml"), from_pretrained=False,
                        device="cpu")
    jdet = JaxTextDetector(path_cfg=str(YAML / "det_small.yaml"), from_pretrained=False,
                           device="cpu")
    sd = {k: v.numpy() for k, v in port.model.state_dict().items()}
    jdet.model.params = convert_dbnet(sd, jdet.model)
    return jdet, port


@pytest.mark.parametrize("num_devices", [None, 0, 1, -1, 4, 99])
def test_dp_mesh_gating_matches_jax(num_devices):
    want = jpar.dp_mesh(num_devices)
    got = par.dp_mesh(num_devices, devices=CPU8)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.shape == dict(want.shape)
        assert got.dp_devices == [torch.device("cpu")] * want.shape["dp"]
    # one CPU, and any count of cards this host lacks: the one-device path
    assert par.dp_mesh(num_devices, device_type="cpu") is None


@pytest.mark.parametrize("n,tp", [(8, 1), (8, 2), (8, 4), (4, 2), (6, 4), (3, 2)])
def test_make_mesh_matches_jax(n, tp):
    try:
        want = dict(jpar.make_mesh(n, tp=tp).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match="not divisible"):
            par.make_mesh(n, tp=tp, devices=CPU8[:n])
        assert "not divisible" in str(e)
        return
    mesh = par.make_mesh(n, tp=tp, devices=CPU8[:n])
    assert mesh.shape == want
    assert mesh.devices.shape == (n // tp, tp)


@pytest.mark.parametrize("n", [1, 5, 8, 11])
def test_shard_batch_pads_as_jax(n):
    batch = np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3) + 1
    sharded, jn = jpar.shard_batch(jpar.make_mesh(4), batch)
    chunks, pn = par.shard_batch(par.make_mesh(devices=CPU8[:4]), batch)
    assert pn == jn == n and len(chunks) == 4
    assert len({c.shape for c in chunks}) == 1
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), np.asarray(sharded))


def test_placements():
    mesh = par.make_mesh(devices=CPU8[:2])
    x = torch.arange(8.0).reshape(4, 2)
    assert [c.tolist() for c in par.batch_sharding(mesh, 2).place(x)] == \
        [x[:2].tolist(), x[2:].tolist()]
    assert all(torch.equal(c, x) for c in par.replicated(mesh).place(x))
    with pytest.raises(ValueError):
        par.batch_sharding(mesh, 2).place(x[:3])


def test_data_parallel_parseq_tokens_match_jax(parseq_pair):
    jm, pm = parseq_pair
    h, w = pm.img_size
    crops = np.random.RandomState(1).rand(11, h, w, 3).astype(np.float32) * 2 - 1
    want_ids, want_probs = jpar.DataParallel(jpar.make_mesh(2), jm._tokens_fn, jm.params,
                                             batch_axis=1)(crops, True, 1)
    run = par.DataParallel(par.make_mesh(devices=CPU8[:2]),
                           lambda m, x: m.forward_tokens_device(x), pm)
    assert run.replicas.models[0] is pm and run.replicas.models[1] is not pm
    ids, probs = run(crops)
    assert ids.shape == (11, pm.max_label_length + 1) == want_ids.shape
    np.testing.assert_array_equal(ids, np.asarray(want_ids))
    np.testing.assert_allclose(probs, np.asarray(want_probs), rtol=0, atol=1e-4)


def test_data_parallel_output_batch_axis(parseq_pair):
    """``batch_axis`` names the output axis that carries the batch."""
    _, pm = parseq_pair
    h, w = pm.img_size
    crops = np.random.RandomState(2).rand(5, h, w, 3).astype(np.float32)
    run = par.DataParallel(par.make_mesh(devices=CPU8[:2]),
                           lambda m, x: torch.stack(m.forward_tokens_device(x)[::-1]).float(),
                           pm, batch_axis=1)
    packed = run(crops)
    ids, probs = pm.forward_tokens(crops)
    assert packed.shape == (2, 5, pm.max_label_length + 1)
    np.testing.assert_array_equal(packed[1].astype(np.int32), ids)
    np.testing.assert_allclose(packed[0], probs, atol=2e-4)


def test_dp_pages_dbnet(detectors):
    jdet, port = detectors
    pages = np.random.RandomState(0).randint(0, 255, (5, 64, 96, 3), np.uint8)
    got = par.dp_pages(port.model, pages, forward="forward_u8", devices=CPU8[:2])
    assert got.shape == (5, 64, 96) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, port.model.forward_binary_u8(pages))
    want = jdet.model.forward_binary_u8(pages, as_u8=True)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture
def meshed():
    """Attach a 2-device CPU mesh to a model for the test, then detach."""
    models = []

    def attach(model, n=2):
        model.use_mesh(par.make_mesh(devices=CPU8[:n]))
        models.append(model)
        return model

    yield attach
    for m in models:
        m.use_mesh(None)


def _replica_runs(monkeypatch):
    calls = []
    real = runner.Replicas.run

    def spy(self, fn, chunks, *static):
        calls.append([c.shape[0] if isinstance(c, torch.Tensor) else c[0].shape[0]
                      for c in chunks])
        return real(self, fn, chunks, *static)

    monkeypatch.setattr(runner.Replicas, "run", spy)
    return calls


def test_dbnet_replicas(detectors, meshed, monkeypatch):
    _, port = detectors
    pages = np.random.RandomState(3).randint(0, 255, (4, 64, 96, 3), np.uint8)
    want = port.model.forward_binary_u8(pages)
    calls = _replica_runs(monkeypatch)
    meshed(port.model)
    got = port.model.forward_binary_u8(pages)
    assert calls == [[2, 2]]
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the page route's stack of pages splits the same way
    stack = torch.from_numpy(pages)
    got = port.model.forward_from_pages(stack, [(64, 96)] * 4, (64, 96)).numpy()
    assert calls[-1] == [2, 2]
    solo = np.stack([port.model.forward_from_page(p, (64, 96), (64, 96))[0].numpy()
                     for p in stack])
    assert np.abs(got.astype(int) - solo.astype(int)).max() <= 1


def test_rtdetr_replicas(meshed, monkeypatch):
    lp = LayoutParser(path_cfg=str(YAML / "layout_small.yaml"), from_pretrained=False,
                      device="cpu")
    h, w = lp._cfg.data.img_size
    x = np.random.RandomState(4).randint(0, 255, (4, h, w, 3), np.uint8)
    want = lp.model(x)
    calls = _replica_runs(monkeypatch)
    meshed(lp.model)
    got = lp.model(x)
    assert calls == [[2, 2]]
    for key in ("pred_logits", "pred_boxes"):
        scale = want[key].abs().max().item()
        assert (got[key] - want[key]).abs().max().item() <= 1e-4 * scale, key
    # the k-th gap: the top-k picks the same queries where it is wide
    k = lp.postprocessor.num_top_queries
    for a, b in zip(got["pred_logits"].flatten(1), want["pred_logits"].flatten(1)):
        top = b.sort(descending=True).values
        if (top[k - 1] - top[k]).item() > 1e-3:
            assert set(a.topk(k).indices.tolist()) == set(b.topk(k).indices.tolist())


def test_parseq_replicas(parseq_pair, meshed, monkeypatch):
    _, pm = parseq_pair
    h, w = pm.img_size
    crops = np.random.RandomState(5).rand(8, h, w, 3).astype(np.float32) * 2 - 1
    want_ids, want_probs = pm.forward_tokens(crops)
    calls = _replica_runs(monkeypatch)
    meshed(pm)
    ids, probs = pm.forward_tokens(crops)
    assert calls == [[4, 4]]
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=2e-4)
    # each replica decodes in its own AR loops, under its own lock
    a, b = pm.replicas().models
    assert a is pm and b._ar_lock is not a._ar_lock
    assert b._ar_loops is not a._ar_loops
    # the page route: the lines split, the page is read on each replica
    page = torch.from_numpy(np.random.RandomState(6).randint(0, 255, (64, 96, 3), np.uint8))
    mats = np.tile(np.eye(3, dtype=np.float32), (8, 1, 1))
    mats[:, 0, 2] = np.arange(8) * 4
    wh = np.tile(np.int32([w, h]), (8, 1))
    got = pm.forward_tokens_from_page(page, mats, wh)
    assert calls[-1] == [4, 4]
    pm.use_mesh(None)
    want = pm.forward_tokens_from_page(page, mats, wh)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=2e-4)


def test_uneven_batch_stays_on_one_device(detectors, meshed, monkeypatch):
    _, port = detectors
    pages = np.random.RandomState(7).randint(0, 255, (3, 64, 96, 3), np.uint8)
    calls = _replica_runs(monkeypatch)
    meshed(port.model)
    slices = port.model.place_batch(pages)
    assert len(slices) == 1 and slices[0].shape[0] == 3
    out = port.model.forward_binary_u8(pages)
    assert out.shape == (3, 64, 96) and calls == []
    # an empty batch too
    assert len(port.model.place_batch(pages[:0])) == 1


def test_weight_load_after_use_mesh_reaches_replicas(parseq_pair, meshed):
    _, pm = parseq_pair
    saved = {k: v.clone() for k, v in pm.state_dict().items()}
    meshed(pm)
    first = pm.replicas()
    assert pm.replicas() is first  # kept while the weights stand
    try:
        with torch.no_grad():
            sd = {k: v * 1.5 if v.is_floating_point() else v for k, v in saved.items()}
        pm.load_state_dict(sd)
        second = pm.replicas()
        assert second is not first
        for name, p in second.models[1].state_dict().items():
            torch.testing.assert_close(p, pm.state_dict()[name], rtol=0, atol=0)
        h, w = pm.img_size
        crops = np.random.RandomState(8).rand(4, h, w, 3).astype(np.float32)
        ids, probs = pm.forward_tokens(crops)
        pm.use_mesh(None)
        want_ids, want_probs = pm.forward_tokens(crops)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_allclose(probs, want_probs, rtol=0, atol=2e-4)
    finally:
        pm.load_state_dict(saved)


def test_replica_attributes_follow_the_model(parseq_pair, meshed):
    """A flag the owner changes after the copy (the int8 audit turning the
    cache off) reaches the replicas before their next call."""
    _, pm = parseq_pair
    meshed(pm)
    reps = pm.replicas()
    pm.refine_iters = 0
    try:
        reps.sync_attrs()
        assert reps.models[1].refine_iters == 0
    finally:
        pm.refine_iters = 1
        reps.sync_attrs()


def test_replica_failure_raises(detectors, meshed):
    _, port = detectors
    meshed(port.model)

    def boom(m, x):
        if m is not port.model:
            raise RuntimeError("replica failed")
        return x

    with pytest.raises(RuntimeError, match="replica failed"):
        port.model.run_placed(boom, np.zeros((2, 4, 4, 3), np.uint8))


def test_replicas_built_once_under_racing_threads(parseq_pair, meshed, monkeypatch):
    """Sixteen threads asking for the replicas at once, the switch interval
    shortened: one set is built, and every thread gets it."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    _, pm = parseq_pair
    meshed(pm)
    builds = []
    real = runner.Replicas.__init__

    def counted(self, *args, **kwargs):
        builds.append(1)
        real(self, *args, **kwargs)

    monkeypatch.setattr(runner.Replicas, "__init__", counted)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            got = [f.result(timeout=60) for f in [pool.submit(pm.replicas) for _ in range(64)]]
    finally:
        sys.setswitchinterval(interval)
    assert len(builds) == 1
    assert all(g is got[0] for g in got)


@pytest.mark.parametrize("device,waits", [("cpu", True), ("cuda:0", False)])
def test_copies_to_the_host_wait_for_their_bytes(device, waits):
    """A copy onto the host is made with a wait (its reader takes the bytes
    at once: an asynchronous device-to-host copy returns before they
    land); one onto a card is queued without one."""
    seen = []

    class Tensor:
        def to(self, to, non_blocking=False):
            seen.append((to, non_blocking))
            return self

    par.mesh.to_device(Tensor(), device)
    assert seen == [(torch.device(device), not waits)]


def test_data_parallel_uses_the_model_replicas(parseq_pair, meshed):
    """The runner keeps no replicas of its own: it runs the model's one set
    on its mesh's devices, which the model's own mesh on the same devices
    shares and a weight load rebuilds for both."""
    _, pm = parseq_pair
    run = par.DataParallel(par.make_mesh(devices=CPU8[:2]),
                           lambda m, x: m.forward_tokens_device(x), pm)
    first = run.replicas
    assert first is pm.replicas(CPU8[:2]) and first.models[0] is pm
    meshed(pm)
    assert pm.replicas() is first
    saved = {k: v.clone() for k, v in pm.state_dict().items()}
    try:
        pm.load_state_dict({k: v * 1.5 if v.is_floating_point() else v
                            for k, v in saved.items()})
        assert run.replicas is not first and run.replicas is pm.replicas()
        h, w = pm.img_size
        crops = np.random.RandomState(9).rand(4, h, w, 3).astype(np.float32)
        ids, probs = run(crops)
        pm.use_mesh(None)
        want_ids, want_probs = pm.forward_tokens(crops)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_allclose(probs, want_probs, rtol=0, atol=2e-4)
    finally:
        pm.load_state_dict(saved)
    # other devices: the set is made anew for them
    assert pm.replicas(CPU8[:3]).devices == [torch.device("cpu")] * 3
