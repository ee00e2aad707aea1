"""The models' own requests (``baseVAE._request`` over
``pyroved_tpu_torch/trainers/_requests.py``) on the CPU, against the JAX
package's jitted model functions on the same weights: every request of the
five families (encode, decode, reconstruct, manifold2d, the heads,
``guide_probs``, ``VED.predict``) at ragged row counts, one and more
chunks, and under ``batch_size``, JAX's ``_chunked`` rule; a batchnorm
VED at exact rows against JAX's padded chunks; one decode under
``BF16_MATMUL`` against JAX's K1 in interpret mode. The bodies are forced
through ``trainers/_graph.py``'s ``Program``, as the card runs them, with a
stand-in for the graph whose replays write into the same static outputs,
as a CUDA graph's do, and held bit for bit to the eager bodies: results
that do not alias one another, a pose an input and not a key, the bound on
the programs and their key, an unlabeled ssiVAE encode with no host read,
``auxSVItrainer``'s metric with no request program inside it, and requests
after more training and after ``load_weights``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyroved_tpu.models as jmodels
import pyroved_tpu.ops.spatial_decoder as jsd
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.models.base as tbase
import pyroved_tpu_torch.utils.nn as tnn
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import _graph, _requests, auxSVItrainer
from pyroved_tpu_torch.utils.data import init_dataloader
from pyroved_tpu_torch.utils.nn import as_numpy

from test_torch_port_bf16 import OUT_ATOL

# the port's f32 bound against the JAX package (outputs, sums in another
# order)
ATOL = 1e-5
DATA = (8, 8)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))
VED_SMALL = dict(hidden_dim_e=((4,), (8,)), hidden_dim_d=((8,), (4,)))
#: row counts: one row, within the first bucket, at it, past it, and past
#: max_bucket (two chunks, the second in the first bucket)
SIZES = (1, 7, 8, 9, 1025)
N = max(SIZES)
#: the batch_size= cases: 1025 rows in 11 chunks, the last padded
BATCH = 100
S = 3  # VED.predict's samples
KEY = jax.random.PRNGKey(11)
POSE = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
# name -> (class, positional arguments, keywords)
FAMILIES = {
    "ivae": ("iVAE", (), dict(invariances=["r", "t"], **SMALL)),
    "cond": ("iVAE", (), dict(invariances=["r"], c_dim=2, **SMALL)),
    "plain": ("iVAE", (), dict(invariances=None, **SMALL)),
    "jivae": ("jiVAE", (2, 3), dict(invariances=["r"], **SMALL)),
    "ssivae": ("ssiVAE", (2, 3), dict(invariances=["r"], **SMALL)),
    "ss_reg": ("ss_reg_iVAE", (2, 1), dict(invariances=["r"], **SMALL)),
    "ved": ("VED", ((16,),), dict(latent_dim=2, **VED_SMALL)),
    "ved_bn": ("VED", ((16,),), dict(latent_dim=2, batchnorm=True,
                                     **VED_SMALL)),
}
REQUESTS = {
    "ivae": ("encode", "decode", "reconstruct"),
    "cond": ("encode", "decode", "reconstruct"),
    "plain": ("encode", "decode"),
    "jivae": ("encode", "encode_logits", "guide_probs", "decode"),
    "ssivae": ("classifier", "guide_probs", "encode", "encode_y", "decode"),
    "ss_reg": ("regressor", "encode", "encode_y", "decode"),
    "ved": ("encode", "decode", "predict"),
    "ved_bn": ("encode", "decode", "predict"),
}
UNBATCHED = ("guide_probs", "predict")  # no batch_size=, as in JAX


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX package's model
    functions compute them; one torch thread (small models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield
    torch.set_num_threads(n)


def _pair(family, seed=3):
    cls, args, kw = FAMILIES[family]
    jm = getattr(jmodels, cls)(DATA, *args, seed=seed, **kw)
    tm = getattr(tmodels, cls)(DATA, *args, device="cpu", **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    return {}


def _get(pairs, family):
    """The family's (JAX model, port model), made once for the module;
    the port model's programs dropped."""
    if family not in pairs:
        pairs[family] = _pair(family)
    jm, tm = pairs[family]
    tm._requests = None
    return jm, tm


def _data(family, n=N, seed=0):
    rng = np.random.default_rng(seed)
    k = FAMILIES[family][1][1] if family in ("jivae", "ssivae") else 0
    return {
        "x": rng.uniform(0, 1, (n,) + DATA).astype(np.float32),
        "z": rng.normal(size=(n, 2)).astype(np.float32),
        "c": rng.normal(size=(n, 2)).astype(np.float32),
        "y": (np.eye(k, dtype=np.float32)[rng.integers(0, k, n)] if k
              else rng.normal(size=(n, 1)).astype(np.float32)),
        "eps": np.asarray(jax.random.normal(KEY, (S, n, 2))),
    }


def _call(family, req, m, d, n, **kw):
    """``req`` of ``m`` (a JAX or a port model) on the first ``n`` rows."""
    x = d["x"][:n]
    cond = d["c"][:n] if family == "cond" else None
    labels = d["c" if family == "cond" else "y"][:n]
    if req == "encode":
        return m.encode(x, cond, **kw) if family == "cond" else m.encode(
            x, **kw)
    if req == "encode_logits":
        return m.encode(x, logits=True, **kw)
    if req == "encode_y":
        return m.encode(x, labels, **kw)
    if req in ("classifier", "regressor", "guide_probs"):
        return getattr(m, req)(x, **kw)
    if req == "reconstruct":
        return m.reconstruct(x, cond, **POSE, **kw)
    if req == "predict":
        if isinstance(m, tbase.baseVAE):
            return m.predict(x, num_samples=S, eps=d["eps"][:, :n])
        m.next_rng = lambda: KEY
        return m.predict(x, num_samples=S)
    z = d["z"][:n]
    if family in ("ved", "ved_bn"):
        return m.decode(z, **kw)
    if family == "plain":
        return m.decode(z, **kw)
    if family == "ivae":
        return m.decode(z, **POSE, **kw)
    return m.decode(z, labels, **POSE, **kw)


def _tuple(res):
    return res if isinstance(res, tuple) else (res,)


def _close(ours, ref, n=None, atol=ATOL):
    ours, ref = _tuple(ours), _tuple(ref)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o, r = as_numpy(o), np.asarray(r)
        r = r if n is None else r[:n]
        assert o.shape == r.shape, (o.shape, r.shape)
        np.testing.assert_allclose(o, r, atol=atol)


def _same(a, b):
    a, b = _tuple(a), _tuple(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture
def programs(monkeypatch):
    """Every request through its bucket's Program, whose runs stand in for
    the card's: the first eager, the second the capture (its outputs the
    graph's static outputs) and every later one a replay, which writes its
    outputs into those same tensors."""
    monkeypatch.setattr(tbase, "request_route", lambda model: True)

    def run(self, clone=True):
        self._steps()
        out = self.finish()
        if not self.warm:
            self.warm = True
            return out
        if self.outputs is None:
            self.outputs = out
        else:
            for static, o in zip(self.outputs, out):
                static.copy_(o)
        self.replays += 1
        return self.outputs if not clone else tuple(
            o.clone() for o in self.outputs)

    monkeypatch.setattr(_graph.Program, "run", run)


def _eager(monkeypatch, fn):
    """``fn()`` with the captured route cleared: the bucketed bodies run
    eagerly, as on the card with ``_graph.CAPTURE`` cleared."""
    with monkeypatch.context() as mp:
        mp.setattr(tbase, "request_route", lambda model: False)
        return fn()


def _by_kind(tm):
    """Each function's programs: function -> kind -> count."""
    out = {}
    for (name, _), prog in tm._requests.programs.items():
        kinds = out.setdefault(name[0], {})
        kinds[prog.kind] = kinds.get(prog.kind, 0) + 1
    return out


# ---------------------------------------------------------------------------
# Every request against JAX, through the programs and eagerly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,req", [
    (f, r) for f in FAMILIES for r in REQUESTS[f]],
    ids=lambda v: v)
def test_requests_match_jax(pairs, programs, monkeypatch, family, req):
    """Each request at 1, 7, 8, 9 and 1,025 rows (one and two chunks) and
    at 1,025 rows under ``batch_size=100`` through its programs: within
    the f32 bound of JAX's, and bitwise the eager bodies'. A batchnorm
    VED's rows are coupled, so JAX runs it at each row count, and pads
    every chunk of a batch size: the port runs exact rows and pads as JAX
    does. The programs stay within the bound a function."""
    jm, tm = _get(pairs, family)
    d = _data(family)
    coupled = family == "ved_bn"
    ref = None if coupled else _call(family, req, jm, d, N)
    for n in SIZES:
        if coupled:
            d_n = dict(d, eps=np.asarray(jax.random.normal(KEY, (S, n, 2))))
            ref = _call(family, req, jm, d_n, n)
            got = _call(family, req, tm, d_n, n)
            _close(got, ref)
            _same(got, _eager(monkeypatch, lambda: _call(
                family, req, tm, d_n, n)))
            continue
        got = _call(family, req, tm, d, n)
        _close(got, ref, n)
        _same(got, _eager(monkeypatch, lambda: _call(family, req, tm, d, n)))
    if req not in UNBATCHED:
        got = _call(family, req, tm, d, N, batch_size=BATCH)
        _close(got, _call(family, req, jm, d, N, batch_size=BATCH))
        _same(got, _eager(monkeypatch, lambda: _call(family, req, tm, d, N,
                                                     batch_size=BATCH)))
    assert tm._requests.programs
    for kinds in _by_kind(tm).values():
        assert kinds.get("bucket", 0) <= 8 and kinds.get("other", 0) <= 4
    if coupled:  # exact rows: no power-of-two program
        assert all(k == "other" for k in (p.kind for p in
                                          tm._requests.programs.values()))


@pytest.mark.parametrize("family", ["ivae", "jivae", "ssivae", "ss_reg",
                                    "ved"])
def test_manifold2d_matches_jax(pairs, programs, monkeypatch, family):
    """``manifold2d`` at d = 1, 3 and 33 (1,089 rows, two chunks), each
    family's conditioning as its own, through the decode programs."""
    jm, tm = _get(pairs, family)
    kw = {"ivae": {}, "jivae": dict(disc_idx=1), "ssivae": dict(label=2),
          "ss_reg": dict(y=np.float32([0.5])), "ved": {}}[family]
    for d in (1, 3, 33):
        got = tm.manifold2d(d, plot=False, **kw)
        _close(got, jm.manifold2d(d, plot=False, **kw))
        _same(got, _eager(monkeypatch, lambda: tm.manifold2d(
            d, plot=False, **kw)))


def test_bf16_decode_matches_jax_kernel(monkeypatch, programs):
    """One decode under ``BF16_MATMUL`` (both packages' default), 9 and
    1,025 rows through its programs, against JAX's K1 in interpret mode
    with bf16 products on the same weights and pose, within
    ``test_torch_port_bf16.py``'s bound of K1's outputs; the port with its
    flag clear fails it there."""
    jm, tm = _pair("ivae")
    d = _data("ivae")
    monkeypatch.setattr(jsd, "INTERPRET", True)
    monkeypatch.setattr(jsd, "BF16_MATMUL", True)
    monkeypatch.setattr(jsd, "ACT_DTYPE", jnp.float32)
    z = jnp.asarray(d["z"])
    ones = jnp.ones((N,), jnp.float32)
    ref = np.asarray(jsd._fwd(
        jm.grid, POSE["angle"] * ones,
        jnp.broadcast_to(jnp.asarray(POSE["shift"], jnp.float32), (N, 2)),
        POSE["scale"] * ones, z,
        *jsd._padded_sdecoder_weights(jm.params["decoder"]), "tanh",
        True)).reshape((N,) + DATA)
    errs = {}
    for on in (True, False):
        monkeypatch.setattr(tsd, "BF16_MATMUL", on)
        for n in (9, N):
            got = as_numpy(tm.decode(d["z"][:n], **POSE))
            errs[on, n] = float(np.abs(got - ref[:n]).max())
    assert max(errs[True, 9], errs[True, N]) <= OUT_ATOL, errs
    assert errs[False, N] > OUT_ATOL, errs
    assert {name[0] for name, _ in tm._requests.programs} == {"decode"}


# ---------------------------------------------------------------------------
# The programs: aliasing, pose, bound and key
# ---------------------------------------------------------------------------

def test_back_to_back_results_do_not_alias(pairs, programs, monkeypatch):
    """Requests on one bucket, each after the program's capture, return
    tensors of their own: the first is not overwritten by the second."""
    _, tm = _get(pairs, "ssivae")
    reqs = ("decode", "encode", "classifier")
    for req in reqs:
        first = [_call("ssivae", req, tm, _data("ssivae", 13, s), 13)
                 for s in (1, 2)]
        a = _call("ssivae", req, tm, _data("ssivae", 13, 1), 13)  # a replay
        kept = tuple(t.clone() for t in _tuple(a))
        b = _call("ssivae", req, tm, _data("ssivae", 13, 2), 13)
        _same(a, kept)
        _same(a, first[0])
        _same(b, first[1])
    assert len(tm._requests.programs) == len(reqs)
    assert all(p.replays == 3 for p in tm._requests.programs.values())


def test_pose_is_an_input_not_a_key(pairs, programs, monkeypatch):
    """Two poses on one bucket share one program: each pose's outputs are
    its own, the eager body's bits and within the bound of JAX's."""
    jm, tm = _get(pairs, "ivae")
    z = _data("ivae", 9)["z"]
    other = dict(angle=-1.2, shift=0.2, scale=0.8)
    outs = [tm.decode(z, **p) for p in (POSE, other, POSE, other)]
    assert list(tm._requests.programs) == [(("decode",), 16)]
    assert tm._requests.programs[("decode",), 16].replays == 3
    assert not torch.equal(outs[2], outs[3])
    for out, pose in zip(outs, (POSE, other, POSE, other)):
        _same(out, _eager(monkeypatch, lambda: tm.decode(z, **pose)))
        _close(out, jm.decode(z, **pose))


def test_programs_bounded_and_keyed(pairs, programs, monkeypatch):
    """Over requests of 1 to 3,000 rows a function holds one program a
    power-of-two bucket, 8 at most; batch sizes take at most 4 others,
    the least recently used freed; the weights' generation, the flag and
    ``logits`` each make new programs, the pose does not."""
    _, tm = _get(pairs, "jivae")
    d = _data("jivae", 3000)
    sizes = sorted({1, 3000, *[2 ** k + e for k in range(3, 12)
                               for e in (-1, 0, 1)]})
    for n in sizes:
        tm.encode(d["x"][:n])
    runner = tm._requests
    assert runner.made == 8
    assert sorted(runner.programs) == [(("encode", False), b)
                                       for b in runner.buckets()]
    for bs in (3, 5, 6, 7, 3, 9):
        tm.encode(d["x"][:20], batch_size=bs)
    others = [b for (name, b), p in runner.programs.items()
              if p.kind == "other"]
    assert others == [6, 7, 3, 9] and runner.made == 8 + 5
    made = runner.made
    lru = next(s for s, p in runner.programs.items() if p.kind == "bucket")
    tm.encode(d["x"][:20], logits=True)  # a key of its own, at bucket 32
    assert runner.made == made + 1
    assert (("encode", True), 32) in runner.programs
    bucket_progs = [s for s, p in runner.programs.items()
                    if p.kind == "bucket"]
    assert len(bucket_progs) == 8  # the least recently used one freed
    assert lru not in runner.programs
    for pose in (POSE, dict(angle=1.0), dict(shift=0.3, scale=0.7)):
        tm.decode(d["z"][:20], d["y"][:20], **pose)
    assert runner.made == made + 2  # one decode program for three poses
    tm.encode(d["x"][:20])
    assert runner.made == made + 2
    tm._weights_replaced()  # a new generation: every program made again
    tm.encode(d["x"][:20])
    assert runner.made == made + 3 and len(runner.programs) == 1
    monkeypatch.setattr(tsd, "BF16_MATMUL", True)
    tm.encode(d["x"][:20])
    assert runner.made == made + 4 and len(runner.programs) == 1


def test_num_samples_and_exact_rows_keyed(pairs, programs, monkeypatch):
    """``VED.predict`` keys its programs by ``num_samples``; without
    ``eps=`` it draws the noise on the host from the model's generator, as
    the eager body does; a batchnorm VED served from running statistics
    is row-independent again, and its bucketed programs replace the exact
    ones."""
    _, tm = _get(pairs, "ved")
    x = _data("ved", 10)["x"]
    tm.predict(x, num_samples=3)
    tm.predict(x, num_samples=4)
    tm.predict(x, num_samples=3)
    assert sorted(s for s in tm._requests.programs) == [
        (("predict", 3), 16), (("predict", 4), 16)]
    g = torch.Generator().set_state(tm.generator.get_state())
    got = tm.predict(x, num_samples=5)
    eps = torch.randn((5, 10, 2), generator=g)
    _same(got, _eager(monkeypatch, lambda: tm.predict(x, num_samples=5,
                                                      eps=eps)))
    assert torch.equal(g.get_state(), tm.generator.get_state())
    _, bn = _get(pairs, "ved_bn")
    bn.encode(x)
    assert list(bn._requests.programs) == [(("encode",), 10)]
    bn.use_running_stats = True
    got = bn.encode(x)
    assert list(bn._requests.programs) == [(("encode",), 16)]
    _same(got, _eager(monkeypatch, lambda: bn.encode(x)))
    bn.use_running_stats = False


class _BatchNormEncoder(torch.nn.Module):
    """An injected encoder with a torch batchnorm: in training mode (a
    module's default) it normalizes a call's rows by their statistics."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(64, 16)
        self.bn = torch.nn.BatchNorm1d(16)
        self.loc = torch.nn.Linear(16, 3)
        self.scale = torch.nn.Linear(16, 3)

    def forward(self, x):
        h = torch.tanh(self.bn(self.fc(x)))
        return self.loc(h), torch.nn.functional.softplus(self.scale(h))


def test_injected_batchnorm_runs_exact_rows(programs):
    """An injected net holding a torch batchnorm in training mode couples
    its rows: its requests run exact rows, as a direct call on them; in
    ``eval()`` it serves from running statistics, and its requests take
    the power-of-two buckets again (the mode is in the key)."""
    tm = tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=5,
                      **SMALL)
    tm.set_encoder(_BatchNormEncoder())
    x = torch.from_numpy(_data("ivae", 7, 8)["x"])
    xf = x.reshape(7, -1)
    got = tm.encode(x)
    assert list(tm._requests.programs) == [(("encode", False), 7)]
    assert tm._requests.programs[("encode", False), 7].kind == "other"
    with torch.no_grad():
        _same(got, tm.encoder_net(xf))
    tm.encoder_net.eval()
    got = tm.encode(x)
    assert list(tm._requests.programs) == [(("encode", False), 8)]
    with torch.no_grad():
        _same(got, tuple(o[:7] for o in tm.encoder_net(_requests.padded(
            xf, 8))))


def test_unlabeled_encode_makes_no_host_read(pairs, programs, monkeypatch):
    """ssiVAE's unlabeled encode labels its input with the classifier's
    argmax one-hot, made on the device: no host read in the request (the
    checked ``to_onehot`` is for users' labels)."""
    jm, tm = _get(pairs, "ssivae")
    x = _data("ssivae", 13, 4)["x"]
    ref = jm.encode(x)
    xt = torch.from_numpy(x)

    def no_read(*a, **k):
        raise AssertionError("a host read in a request's body")

    for target, attr in ((tnn, "as_numpy"), (tnn, "to_onehot"),
                         (torch.Tensor, "item"), (torch.Tensor, "numpy"),
                         (torch.Tensor, "tolist"), (torch.Tensor, "__int__"),
                         (torch.Tensor, "cpu")):
        monkeypatch.setattr(target, attr, no_read)
    outs = [tm.encode(xt) for _ in range(3)]
    monkeypatch.undo()
    for out in outs:
        _close(out, ref)
    assert tm._requests.programs[("encode", False), 16].replays == 2


def test_aux_metric_makes_no_nested_program(pairs, programs, monkeypatch):
    """``auxSVItrainer``'s labeled-set metric, a captured program of its
    own, calls the model's head body directly: with both routes forced it
    makes its one program and no request program, and its body runs the
    head once a batch, as before; the classifier request outside it makes
    its own."""
    import torch.optim.adam as adam
    listed = adam._get_capturable_supported_devices
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: listed(*a, **k) + ["cpu"])
    monkeypatch.setattr(_graph, "route", lambda *a, **k: True)
    for family in ("ssivae", "ss_reg"):
        _, tm = _get(pairs, family)
        d = _data(family, 40, 5)
        t = auxSVItrainer(tm, optimizer=torch.optim.Adam(
            tm.nets.parameters(), capturable=True, foreach=True))
        loader = init_dataloader(d["x"], d["y"], batch_size=16,
                                 shuffle=False, device="cpu")
        calls = []
        head = tm.encoder_y_net
        hook = head.register_forward_hook(lambda *a: calls.append(1))
        try:
            metric = [t.evaluate(loader) for _ in range(3)]
        finally:
            hook.remove()
        assert ("metric",) in t._graphs.programs
        assert tm._requests is None  # no request made a program
        assert len(calls) == 3 * 3  # three batches a pass
        predicted = (tm.classifier(d["x"]) if family == "ssivae"
                     else tm.regressor(d["x"]))
        assert tm._requests.made == 1
        if family == "ssivae":
            hits = (predicted == torch.from_numpy(d["y"]).argmax(1)).sum()
            assert metric[0] == pytest.approx(float(hits) / 40)
        assert metric[0] == metric[1] == metric[2]


def test_requests_follow_training_and_load_weights(pairs, programs,
                                                   monkeypatch, tmp_path):
    """A program reads the weights in place: after one more epoch of
    ``fit`` (Adam updates the parameters in place) a request replays the
    same program and equals the eager body on the new weights; after
    ``load_weights`` (a new generation) its programs are made again."""
    tm = tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=5,
                      **SMALL)
    d = _data("ivae", 32, 6)
    x = d["x"]
    tm.save_weights(str(tmp_path / "w"))
    before = tm.reconstruct(x)
    tm.reconstruct(x)
    made = tm._requests.made
    tm.fit(x, epochs=1, batch_size=16)
    after = tm.reconstruct(x)
    assert tm._requests.made == made == 2
    assert not torch.equal(after, before)
    _same(after, _eager(monkeypatch, lambda: tm.reconstruct(x)))
    tm.load_weights(str(tmp_path / "w"))
    loaded = tm.reconstruct(x)
    assert tm._requests.made == made + 2
    _same(loaded, before)


def test_guide_probs_probe_is_one_program(pairs, programs):
    """``enum_schedule="auto"``'s probe, the guide's probabilities of 512
    rows, is one program, replayed at each probe."""
    _, tm = _get(pairs, "jivae")
    x = torch.from_numpy(_data("jivae", 512)["x"])
    outs = [tm.guide_probs(x) for _ in range(3)]
    assert list(tm._requests.programs) == [(("guide_probs",), 512)]
    _same(outs[0], outs[2])


# ---------------------------------------------------------------------------
# The runner's rules and the route
# ---------------------------------------------------------------------------

def test_plan_and_bucket_cap():
    """The chunks and buckets of each rule, and the largest bucket capped
    by a buffer's bytes."""
    r = _requests.Requests("cpu")
    assert r.plan(9) == [(0, 9, 16)]
    assert r.plan(1025) == [(0, 1024, 1024), (1024, 1, 8)]
    assert r.plan(250, batch_size=100) == [(0, 100, 100), (100, 100, 100),
                                           (200, 50, 100)]
    assert r.plan(7, batch_size=100) == [(0, 7, 100)]
    assert r.plan(7, exact=True) == [(0, 7, 7)]
    assert r.plan(3000, exact=True) == [(0, 3000, 3000)]
    assert r.plan(7, batch_size=100, exact=True) == [(0, 7, 7)]
    assert r.plan(250, batch_size=100, exact=True) == r.plan(
        250, batch_size=100)
    assert r.plan(0) == [(0, 0, 8)]
    cap = _requests.capped_bucket
    assert cap(4 * 28 * 28) == cap(4 * 128 * 128) == 1024
    assert cap(4 * 512 * 512) == 256 and cap(1 << 40) == 8
    assert tmodels.iVAE((64, 64), invariances=["r"], device="cpu")._row_bytes(
    ) == 4 * 64 * 64


def test_route_by_configuration(monkeypatch):
    """Programs on a CUDA model while ``CAPTURE`` is set; the CPU, the
    flag cleared and a model whose parameters a mesh splits (its pixel
    grid here) keep the eager bodies."""
    tm = tmodels.iVAE(DATA, invariances=["r"], device="cpu", **SMALL)
    assert not tbase.request_route(tm)
    monkeypatch.setattr(tm, "device", torch.device("cuda"))
    assert tbase.request_route(tm)
    monkeypatch.setattr(_graph, "CAPTURE", False)
    assert not tbase.request_route(tm)
    monkeypatch.setattr(_graph, "CAPTURE", True)
    monkeypatch.setattr(tm, "_pixel_mesh", "a DeviceMesh")
    assert not tbase.request_route(tm)
