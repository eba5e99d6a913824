"""The tensor-parallel half of the port's ``parallel/`` against the JAX
package's, and the sharded PARSeq against the unsharded one, CPU, f32.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port names the CPU several times in a device list, so a (dp, tp) mesh's
rows and their shards all lie on the host.  Held:

- ``parseq_param_shardings``' spec tree against JAX's, through torch's
  (V, D) head against JAX's (D, V) kernel: the tiny model of JAX's test
  (16 tokens, 14 classes) at tp 1, 2, 4 and 8, and a narrow model at
  ``parseq``'s 7,312 tokens and ``parseq-large-v4_1``'s 7,121 at tp 2, 4
  and 8 (nothing split at 7,121: both dimensions are odd);
- the port's counterpart of JAX's ``test_dp_tp_mesh_parseq``: the tiny
  model sharded on a (4, 2) mesh against JAX's on its (4, 2) mesh, the
  same weights: ids equal, probs within 1e-4;
- the sharded model against the unsharded port model at 7,312 tokens on
  (1, 2), (2, 2) and (2, 4) meshes, on the AR decode with and without the
  refine pass, the non-AR decode and the uncached AR loop (decoder depth
  2), with a batch that does not divide dp: ids equal, probs within 1e-5,
  the shards' shapes as the rule gives, each with storage of its own, and
  every embedding lookup bit-equal to the whole table's;
- the rows are copies (a later weight load does not reach them), copy
  the model's ``replica_attrs`` before each call, and serve their slices
  on kept workers; and the CUDA-graph decision of the AR loop."""

import jax
import numpy as np
import pytest
import torch

from yomitoku_tpu import parallel as jpar
from yomitoku_tpu.config import structured as jax_structured
from yomitoku_tpu.configs import TextRecognizerPARSeqTinyConfig as JaxTinyConfig
from yomitoku_tpu.models.parseq import PARSeq as JaxPARSeq
from yomitoku_tpu.parallel.mesh import _path_str
from yomitoku_tpu_torch import parallel as par
from yomitoku_tpu_torch.config import structured
from yomitoku_tpu_torch.configs import TextRecognizerPARSeqTinyConfig
from yomitoku_tpu_torch.models import parseq as port_parseq
from yomitoku_tpu_torch.models.parseq import PARSeq
from yomitoku_tpu_torch.parallel import runner
from yomitoku_tpu_torch.parallel.tensor_parallel import SplitEmbedding, SplitLinear
from yomitoku_tpu_torch.weights import state_dict_from_jax

CPU8 = ["cpu"] * 8
#: the JAX parameter path of each split matrix -> the port's state_dict name
JAX_TO_PORT = {"head/kernel": "head.weight",
               "text_embed/embedding": "text_embed.embedding.weight"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")


def _cfg(cfg, num_tokens=16, max_label_length=4, depth=1):
    """JAX's test model (16 tokens), or a narrow one at a real vocabulary."""
    cfg.encoder.depth = 1
    cfg.encoder.embed_dim = 32
    cfg.encoder.num_heads = 2
    cfg.decoder.embed_dim = 32
    cfg.decoder.num_heads = 2
    cfg.decoder.depth = depth
    cfg.num_tokens = num_tokens
    cfg.max_label_length = max_label_length
    cfg.data.img_size = [16, 32]
    return cfg


def _pair(**kw):
    """The model in both packages on the JAX seeded init, full K/V cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        jm = JaxPARSeq(_cfg(jax_structured(JaxTinyConfig), **kw))
        pm = PARSeq(_cfg(structured(TextRecognizerPARSeqTinyConfig), **kw), device="cpu")
    jm.params = jm.init_params(0)
    pm.load_state_dict(state_dict_from_jax(jm.params, pm))
    return jm, pm


@pytest.fixture(scope="module")
def pairs():
    """{num_tokens: (JAX model, port model)}, built once each."""
    cache = {}

    def get(num_tokens):
        if num_tokens not in cache:
            cache[num_tokens] = _pair(num_tokens=num_tokens)
        return cache[num_tokens]

    return get


@pytest.fixture(scope="module")
def wide():
    """The narrow model at parseq's 7,312 tokens, decoding 8 steps: the
    port's alone, on its own seeded init, and with a depth-2 decoder (the
    uncached AR loop)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("YOMITOKU_TPU_INT8_KV", "0")
        return {depth: PARSeq(_cfg(structured(TextRecognizerPARSeqTinyConfig), 7312, 8, depth),
                              device="cpu") for depth in (1, 2)}


def _jax_split(params, tp):
    """{port name: spec} of the matrices JAX's rule splits on an (8 / tp,
    tp) mesh, each spec turned into the port's layout."""
    shardings = jpar.parseq_param_shardings(params, jpar.make_mesh(8, tp=tp))
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        spec = tuple(s.spec)
        if any(a is not None for a in spec):
            name = next(p for j, p in JAX_TO_PORT.items() if _path_str(path).endswith(j))
            out[name] = spec[::-1] if name == "head.weight" else spec
    return out


@pytest.mark.parametrize("num_tokens,tp,split", [
    (16, 1, {"head.weight", "text_embed.embedding.weight"}),
    (16, 2, {"head.weight", "text_embed.embedding.weight"}),
    (16, 4, {"text_embed.embedding.weight"}),
    (16, 8, {"text_embed.embedding.weight"}),
    (7312, 2, {"head.weight", "text_embed.embedding.weight"}),
    (7312, 4, {"text_embed.embedding.weight"}),
    (7312, 8, {"text_embed.embedding.weight"}),
    (7121, 2, set()),
    (7121, 4, set()),
    (7121, 8, set()),
])
def test_spec_tree_matches_jax(pairs, num_tokens, tp, split):
    jm, pm = pairs(num_tokens)
    mesh = par.make_mesh(devices=CPU8, tp=tp)
    got = par.parseq_param_shardings(pm, mesh)
    assert set(got) == set(pm.state_dict())
    assert all(p.mesh is mesh for p in got.values())
    port_split = {n: p.spec for n, p in got.items() if p.spec}
    assert port_split == _jax_split(jm.params, tp)
    assert port_split == {n: ("tp", None) for n in split}


def test_dp_tp_mesh_parseq_matches_jax(pairs):
    """JAX's ``test_dp_tp_mesh_parseq`` in both packages: the tiny model
    on a (4, 2) mesh, the batch split over dp, tp over the head and the
    embedding."""
    jm, pm = pairs(16)
    jmesh = jpar.make_mesh(8, tp=2)
    params = jpar.shard_params(jm.params, jpar.parseq_param_shardings(jm.params, jmesh))
    h, w = pm.img_size
    batch = np.random.RandomState(2).rand(8, h, w, 3).astype(np.float32)
    images, n = jpar.shard_batch(jmesh, batch)
    with jmesh:
        want_ids, want_probs = jm._tokens_fn(params, images, True, 1)
    mesh = par.make_mesh(devices=CPU8, tp=2)
    assert mesh.shape == dict(jmesh.shape)
    sharded = par.shard_params(pm, par.parseq_param_shardings(pm, mesh))
    assert len(sharded.rows) == 4
    assert all(isinstance(r.head, SplitLinear) and isinstance(r.text_embed.embedding,
                                                               SplitEmbedding)
               for r in sharded.rows)
    ids, probs = par.DataParallel(mesh, PARSeq._tokens, sharded)(batch)
    np.testing.assert_array_equal(ids, np.asarray(want_ids)[:n])
    np.testing.assert_allclose(probs, np.asarray(want_probs)[:n], rtol=0, atol=1e-4)
    # the sharded object's own entry gives the same
    got_ids, got_probs = sharded.forward_tokens(batch)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_probs, probs)


#: (dp, tp) meshes of the comparisons with the unsharded model
MESHES = [(1, 2), (2, 2), (2, 4)]
#: decode routes: (decoder depth, decode_ar, refine_iters)
ROUTES = {"ar_refine": (1, True, 1), "ar": (1, True, 0), "non_ar": (1, False, 1),
          "uncached_ar": (2, True, 1)}


@pytest.mark.parametrize("dp,tp", MESHES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_sharded_matches_unsharded(wide, dp, tp, route):
    depth, decode_ar, refine_iters = ROUTES[route]
    pm = wide[depth]
    mesh = par.make_mesh(devices=CPU8[:dp * tp], tp=tp)
    sharded = par.shard_params(pm, par.parseq_param_shardings(pm, mesh))
    h, w = pm.img_size
    crops = np.random.RandomState(3).rand(5, h, w, 3).astype(np.float32) * 2 - 1
    try:
        pm.decode_ar, pm.refine_iters = decode_ar, refine_iters
        want_ids, want_probs = pm.forward_tokens(crops)
        ids, probs = sharded.forward_tokens(crops)
    finally:
        pm.decode_ar, pm.refine_iters = True, 1
    assert ids.shape == (5, pm.max_label_length + 1)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-5)
    # the shards: the rule's shapes (the head whole where tp does not
    # divide 7,310), each with storage of its own
    ptrs = {p.data_ptr() for p in pm.parameters()}
    for row in sharded.rows:
        assert row.decode_ar == decode_ar and row.refine_iters == refine_iters
        emb = row.text_embed.embedding
        assert [tuple(s.shape) for s in emb.weights] == [(7312 // tp, 32)] * tp
        if 7310 % tp == 0:
            assert [tuple(s.shape) for s in row.head.weights] == [(7310 // tp, 32)] * tp
            # each shard's GEMM runs on rows padded with zeros to a multiple of 8
            assert all(pw.shape[0] % 8 == 0 and pw.shape[0] - n < 8 and not pw[n:].any()
                       and pw.data_ptr() == w.data_ptr()
                       for (pw, _, n), w in zip(row.head.gemms, row.head.weights))
            shards = [*row.head.weights, *row.head.biases, *emb.weights]
        else:
            assert isinstance(row.head, torch.nn.Linear)
            shards = [*emb.weights]
        assert all(s.data_ptr() not in ptrs for s in shards)
        ptrs |= {s.data_ptr() for s in shards}
        # every id's lookup bit-equal to the whole table's
        tokens = torch.arange(pm.num_tokens).reshape(4, -1)
        assert torch.equal(row.text_embed(tokens), pm.text_embed(tokens))
        x = torch.from_numpy(crops[:2]).float()
        torch.testing.assert_close(row.head(row.encode(x)), pm.head(pm.encode(x)),
                                   rtol=0, atol=1e-5)


def test_rows_are_copies(wide):
    """A weight load on the model after ``shard_params`` does not reach the
    rows, as a device_put copy does not follow later parameters; sharding
    again places the new weights."""
    pm = wide[1]
    mesh = par.make_mesh(devices=CPU8[:4], tp=2)
    sharded = par.shard_params(pm, par.parseq_param_shardings(pm, mesh))
    h, w = pm.img_size
    crops = np.random.RandomState(4).rand(4, h, w, 3).astype(np.float32)
    before = sharded.forward_tokens(crops)
    saved = {k: v.clone() for k, v in pm.state_dict().items()}
    try:
        pm.load_state_dict({k: v * 1.5 for k, v in saved.items()})
        again = sharded.forward_tokens(crops)
        np.testing.assert_array_equal(again[0], before[0])
        np.testing.assert_array_equal(again[1], before[1])
        fresh = par.shard_params(pm, par.parseq_param_shardings(pm, mesh))
        want = pm.forward_tokens(crops)
        got = fresh.forward_tokens(crops)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    finally:
        pm.load_state_dict(saved)


def test_rows_run_on_kept_workers(wide, monkeypatch):
    """Each row serves its slice of the batch (``shard_batch``) on a kept
    worker of its own; the replicas are the rows, and only on the mesh
    they were placed on."""
    pm = wide[1]
    mesh = par.make_mesh(devices=CPU8[:4], tp=2)
    sharded = par.shard_params(pm, par.parseq_param_shardings(pm, mesh))
    reps = sharded.replicas()
    assert reps.models == sharded.rows and reps.owner is pm
    assert par.DataParallel(mesh, PARSeq._tokens, sharded).replicas is reps
    with pytest.raises(ValueError, match="sharded over"):
        sharded.replicas(CPU8[:3])
    seen = []
    real = runner.Replicas.run

    def spy(self, fn, chunks, *static):
        seen.append([c.shape[0] for c in chunks])
        return real(self, fn, chunks, *static)

    monkeypatch.setattr(runner.Replicas, "run", spy)
    h, w = pm.img_size
    sharded.forward_tokens(np.zeros((5, h, w, 3), np.float32))
    assert seen == [[3, 3]]  # 5 lines padded to 6, three a row
    threads = [set(pool._threads) for pool in reps.workers]
    sharded.forward_tokens(np.zeros((2, h, w, 3), np.float32))
    assert [set(pool._threads) for pool in reps.workers] == threads


def test_shardings_must_fit_the_model(wide):
    pm = wide[1]
    mesh = par.make_mesh(devices=CPU8[:2], tp=2)
    rule = par.parseq_param_shardings(pm, mesh)
    with pytest.raises(ValueError, match="lacks"):
        par.shard_params(pm, {**rule, "nope.weight": rule["head.bias"]})
    bad = dict(rule)
    bad["decoder.layers.0.norm1.weight"] = par.mesh.Placement(mesh, ("tp",))
    with pytest.raises(ValueError, match="no tensor-parallel form"):
        par.shard_params(pm, bad)
    with pytest.raises(ValueError, match="does not split"):
        par.mesh.Placement(mesh, ("tp", None)).place_row(torch.zeros(7, 2), CPU8[:2])


@pytest.mark.parametrize("devices,one", [
    (["cuda:0", "cuda:0"], True),
    (["cuda:0"], True),
    (["cuda", "cuda:0"], True),
    (["cuda:0", "cuda:1"], False),
    (["cuda:0", "cuda:0", "cuda:1", "cuda:1"], False),
    (["cpu", "cpu"], False),
    (["cuda:0", "cpu"], False),
])
def test_graph_only_on_one_card(devices, one):
    """The AR loop captures its step as a CUDA graph only where the step's
    every device is one card; a row over distinct cards runs it eagerly."""
    assert runner.one_card(devices) is one


def test_ar_loop_asks_about_every_shard(wide, monkeypatch):
    """The AR loop's graph decision reads the devices of every parameter
    the step reads, the shards of the split head and embedding among them,
    and a loop that may not capture runs its steps eagerly."""
    pm = wide[1]
    mesh = par.make_mesh(devices=CPU8[:2], tp=2)
    row = par.shard_params(pm, par.parseq_param_shardings(pm, mesh)).rows[0]
    asked = []
    monkeypatch.setattr(port_parseq, "one_card", lambda devs: asked.append(list(devs)) or False)
    loop = port_parseq._CachedARLoop(row, 2, 9, torch.ones(9, 9, dtype=torch.bool).triu(1),
                                     False)
    assert not loop.capturable
    n_shards = len(row.head.weights) + len(row.head.biases) + len(row.text_embed.embedding.weights)
    assert len(asked) == 1 and len(asked[0]) == 1 + len(list(row.parameters()))
    assert n_shards == 6 and len(list(row.parameters())) == len(list(pm.parameters())) + 3
    h, w = pm.img_size
    ids, _ = row.forward_tokens(np.zeros((2, h, w, 3), np.float32))
    assert all(lp.graph is None for lp in row._ar_loops.values())
    want, _ = pm.forward_tokens(np.zeros((2, h, w, 3), np.float32))
    np.testing.assert_array_equal(ids, want)


def test_refine_switch_after_a_decode(wide):
    """Turning the refine pass off after a decode rebuilds the AR loop,
    which then keeps the per-step logits."""
    pm = wide[1]
    h, w = pm.img_size
    crops = np.random.RandomState(5).rand(3, h, w, 3).astype(np.float32)
    pm.forward_tokens(crops)
    try:
        pm.refine_iters = 0
        ids, probs = pm.forward_tokens(crops)
        loops = [lp for (b, _), lp in pm._ar_loops.items() if b == 3]
        assert len(loops) == 1 and loops[0].logits is not None
        assert ids.shape == (3, 9) and np.isfinite(probs).all()
    finally:
        pm.refine_iters = 1
