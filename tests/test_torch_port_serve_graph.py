"""The port's bucketed serving (``pyroved_tpu_torch/serving.py``) on the
CPU, against the JAX package's ``ServedModel`` on the same weights: the
chunks and power-of-two buckets each request runs (JAX's ``fn.call`` and
the port's bodies, spied), and the outputs, on ragged requests of both
archive kinds (any batch, and a fixed batch of 8), f32 and int8, for every
served function. Then the bodies forced through ``trainers/_graph.py``'s
``Program``, as the card runs them, with a stand-in for the graph whose
replays write into the same static outputs, as a CUDA graph's do: results
that do not alias one another, a pose a request, a labeled encode with no
host read, the bound on the programs and their key."""
import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
import pyroved_tpu.serving as jserving
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.serving as tserving
import pyroved_tpu_torch.utils.nn as tnn
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import _graph
from pyroved_tpu_torch.utils.nn import as_numpy

# the port's f32 bound against the JAX package (outputs, sums in another
# order)
ATOL = 1e-5
DATA = (8, 8)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))
SIZES = (1, 7, 8, 9, 13, 1024, 1025, 1100)
POSE = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
# name -> (JAX/port class, positional arguments, keywords, latent width,
# functions served)
MODELS = {
    "ssivae": ("ssiVAE", (2, 3), dict(invariances=["r"]), 5,
               ("encode", "classify", "decode")),
    "ss_reg": ("ss_reg_iVAE", (2, 1), dict(invariances=["r"]), 3,
               ("encode", "regress", "decode")),
    "cond": ("iVAE", (), dict(invariances=["r", "t"], c_dim=2), 4,
             ("encode", "decode")),
    "plain": ("iVAE", (), dict(invariances=None), 2, ("encode", "decode")),
}
# (model, batch size, quantize): both archive kinds; int8 on ssiVAE
ARCHIVES = [("ssivae", None, None), ("ssivae", 8, None),
            ("ssivae", None, "int8"), ("ssivae", 8, "int8"),
            ("ss_reg", None, None), ("ss_reg", 8, None),
            ("cond", None, None), ("plain", None, None), ("plain", 8, None)]


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX package's exported
    module path computes them; one torch thread (small models)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield
    torch.set_num_threads(n)


def _pair(name, seed=3):
    cls, args, kw, _, _ = MODELS[name]
    jm = getattr(jmodels, cls)(DATA, *args, seed=seed, **SMALL, **kw)
    tm = getattr(tmodels, cls)(DATA, *args, device="cpu", **SMALL, **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX ServedModel, port ServedModel, the port's archive) of every
    archive of ``ARCHIVES``."""
    d = tmp_path_factory.mktemp("served")
    pairs = {name: _pair(name) for name in MODELS}
    out = {}
    for name, bs, q in ARCHIVES:
        jm, tm = pairs[name]
        jpath, tpath = str(d / f"j_{name}_{bs}_{q}"), str(d / f"t_{name}_{bs}_{q}")
        jserving.export_model(jm, jpath, batch_size=bs, quantize=q)
        tserving.export_model(tm, tpath, batch_size=bs, quantize=q)
        out[name, bs, q] = (jserving.ServedModel(jpath),
                            tserving.ServedModel(tpath, device="cpu"), tpath)
    return out


def _fresh(served, archive):
    """The JAX ServedModel and a port ServedModel of its own (no
    programs yet)."""
    js, _, tpath = served[archive]
    return js, tserving.ServedModel(tpath, device="cpu")


def _inputs(name, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n,) + DATA).astype(np.float32)
    y = rng.normal(size=(n, 2)).astype(np.float32)
    z = rng.normal(size=(n, MODELS[name][3])).astype(np.float32)
    return x, y, z


def _request(name, fn, served, n, seed=0, pose=POSE):
    x, y, z = _inputs(name, n, seed)
    if fn == "decode":
        return served.decode(z, **(pose if MODELS[name][2]["invariances"]
                                   else {}))
    if fn == "encode" and name == "cond":
        return served.encode(x, y)
    return getattr(served, fn)(x)


def _close(ours, ref, atol=ATOL):
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o, r = as_numpy(o), np.asarray(r)
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, atol=atol)


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


class _JaxSpy:
    """Records the rows of each call of an exported JAX function."""

    def __init__(self, fn, calls):
        self.fn, self.calls = fn, calls

    def call(self, *args):
        self.calls.append(args[0].shape[0])
        return self.fn.call(*args)


def _spy_port(monkeypatch, calls):
    """Record the rows of each call of the port's bodies."""
    real = tserving.ServedModel._run

    def run(self, name, body, batched, extra=()):
        def spy(*a):
            calls.append(a[0].shape[0])
            return body(*a)
        return real(self, name, spy, batched, extra)

    monkeypatch.setattr(tserving.ServedModel, "_run", run)


@pytest.mark.parametrize("archive,fn", [
    (a, fn) for a in ARCHIVES for fn in MODELS[a[0]][4]],
    ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else v)
def test_buckets_and_outputs_match_jax(served, archive, fn, monkeypatch):
    """Each ragged request runs JAX's chunks at JAX's buckets (a fixed
    batch: its size), and its outputs agree with JAX's."""
    name = archive[0]
    js, ts, _ = served[archive]
    jcalls, tcalls = [], []
    monkeypatch.setitem(js._fns, fn, _JaxSpy(js._fns[fn], jcalls))
    _spy_port(monkeypatch, tcalls)
    for n in SIZES:
        jcalls.clear(), tcalls.clear()
        _close(_request(name, fn, ts, n), _request(name, fn, js, n))
        assert tcalls == jcalls, (n, tcalls, jcalls)
        assert tcalls == [ts.bucket(m) for _, m in ts.chunks(n)]
    assert not ts.programs  # the CPU runs the bodies eagerly


def test_bucket_rule():
    """JAX's rule: the power of two at or above the rows, at least 8, at
    most max_bucket; a fixed batch pads to its size; chunks of max_bucket
    (or of the fixed batch)."""
    s = tserving.ServedModel.__new__(tserving.ServedModel)
    s.batch_size = None
    assert [s.bucket(m) for m in (0, 1, 8, 9, 16, 17, 600, 1024, 5000)] == [
        8, 8, 8, 16, 16, 32, 1024, 1024, 1024]
    assert s.buckets() == (8, 16, 32, 64, 128, 256, 512, 1024)
    assert s.chunks(2500) == [(0, 1024), (1024, 1024), (2048, 452)]
    assert s.chunks(0) == [(0, 0)]
    s.max_bucket = 100
    assert s.buckets() == (8, 16, 32, 64, 100)
    assert {s.bucket(m) for m in range(1, 3001)} == set(s.buckets())
    s.max_bucket = 4
    assert s.buckets() == (4,) and s.bucket(3) == 4
    s.batch_size = 200
    assert s.buckets() == (200,) and s.bucket(3) == 200
    assert s.chunks(450) == [(0, 200), (200, 200), (400, 50)]


# ---------------------------------------------------------------------------
# The bodies forced through Program
# ---------------------------------------------------------------------------

@pytest.fixture
def programs(monkeypatch):
    """Every request through its bucket's Program, whose runs stand in for
    the card's: the first eager, the second the capture (its outputs the
    graph's static outputs) and every later one a replay, which writes its
    outputs into those same tensors."""
    monkeypatch.setattr(tserving, "route", lambda device: True)

    def run(self, clone=True):
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
    """``fn()`` with the captured route cleared."""
    with monkeypatch.context() as mp:
        mp.setattr(tserving, "route", lambda device: False)
        return fn()


def test_back_to_back_requests_do_not_alias(served, programs, monkeypatch):
    """Requests on one bucket, each after the program's capture, return
    tensors of their own: the first is not overwritten by the second."""
    js, ts = _fresh(served, ("ssivae", None, None))
    for fn in ("decode", "encode", "classify"):
        first = [_request("ssivae", fn, ts, 13, seed=s) for s in (1, 2)]
        a = _request("ssivae", fn, ts, 13, seed=1)  # a replay
        kept = tuple(t.clone() for t in (a if isinstance(a, tuple) else (a,)))
        b = _request("ssivae", fn, ts, 13, seed=2)  # another replay
        _same(a, kept)
        _same(a, first[0])
        _same(b, first[1])
        _same(b, _eager(monkeypatch, lambda: _request("ssivae", fn, ts, 13,
                                                      seed=2)))
        _close(a, _request("ssivae", fn, js, 13, seed=1))
    assert all(p.replays == 3 for p in ts.programs.values())


def test_two_poses_on_one_bucket(served, programs, monkeypatch):
    """The pose is a static input filled before each run: two poses on
    one bucket give their own outputs, each the eager body's bits and
    within the bound of JAX's."""
    js, ts = _fresh(served, ("ssivae", None, None))
    other = dict(angle=-1.2, shift=0.2, scale=0.8)
    outs = [_request("ssivae", "decode", ts, 9, pose=p)
            for p in (POSE, other, POSE, other)]
    assert ts.programs["decode", 16].replays == 3
    assert not torch.equal(outs[2], outs[3])
    for out, pose in zip(outs, (POSE, other, POSE, other)):
        _same(out, _eager(monkeypatch, lambda: _request(
            "ssivae", "decode", ts, 9, pose=pose)))
        _close(out, _request("ssivae", "decode", js, 9, pose=pose))


def test_labeled_encode_makes_no_host_read(served, programs, monkeypatch):
    """ssiVAE's served encode labels its input with the head's argmax
    one-hot, made on the device: no host read in the body (the checked
    ``to_onehot`` is for users' labels)."""
    js, ts = _fresh(served, ("ssivae", None, None))
    x = _inputs("ssivae", 13, seed=4)[0]
    ref = js.encode(x)

    def no_read(*a, **k):
        raise AssertionError("a host read in a served body")

    for target, attr in ((tnn, "as_numpy"), (tnn, "to_onehot"),
                         (tserving, "as_numpy"), (torch.Tensor, "item"),
                         (torch.Tensor, "numpy"), (torch.Tensor, "tolist"),
                         (torch.Tensor, "__int__")):
        monkeypatch.setattr(target, attr, no_read)
    outs = [ts.encode(x) for _ in range(3)]
    monkeypatch.undo()
    for out in outs:
        _close(out, ref)
    xf = torch.from_numpy(x.reshape(13, -1))
    y = tnn.to_onehot(torch.argmax(ts.head_net(xf), -1), 3)  # checked
    _same(outs[0], ts.encoder(xf, y))


def test_programs_bounded_and_keyed(served, programs, monkeypatch):
    """Over requests of 1 to 3,000 rows a function holds one program a
    bucket, at most 8 (a fixed batch: 1), made once each; a program's key
    is its function and bucket and the settings, max_bucket, the batch
    size and BF16_MATMUL, whose change drops every program and makes them
    again."""
    js, ts = _fresh(served, ("plain", None, None))
    sizes = sorted({1, 3000, *[2 ** k + d for k in range(3, 12)
                               for d in (-1, 0, 1)]})
    for n in sizes:
        _request("plain", "encode", ts, n)
    assert sorted(ts.programs) == [("encode", b) for b in ts.buckets()]
    assert len(ts.programs) == ts.made == 8
    key = ts.settings()
    assert key == (1024, None, False)
    monkeypatch.setattr(tsd, "BF16_MATMUL", True)
    assert ts.settings() != key
    _request("plain", "encode", ts, 40)  # the flag's own program
    assert list(ts.programs) == [("encode", 64)] and ts.made == 9
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)
    ts.max_bucket = 64
    monkeypatch.setattr(js, "max_bucket", 64)
    assert ts.settings() == (64, None, False)
    jcalls, tcalls = [], []
    monkeypatch.setitem(js._fns, "encode", _JaxSpy(js._fns["encode"], jcalls))
    _spy_port(monkeypatch, tcalls)
    for n in (100, 100, 100, 200):
        _close(_request("plain", "encode", ts, n),
               _request("plain", "encode", js, n))
    assert tcalls == jcalls == [64, 64] * 3 + [64, 64, 64, 8]
    assert sorted(ts.programs) == [("encode", 8), ("encode", 64)]
    assert ts.made == 11
    fixed = _fresh(served, ("plain", 8, None))[1]
    for n in sizes[:12]:
        _request("plain", "decode", fixed, n)
    assert list(fixed.programs) == [("decode", 8)] and fixed.made == 1


def test_programs_share_the_models_pool_untidied(served, programs):
    """Every program of a model is a ``Program.body`` in the model's one
    pool, captured without the trainers' tidy-up (no collect, synchronize
    or cache emptying); a settings change gives the programs made anew a
    pool of their own."""
    _, ts = _fresh(served, ("ssivae", None, None))
    for fn in ("encode", "classify", "decode"):
        for n in (5, 40, 1100):
            _request("ssivae", fn, ts, n)
    progs = list(ts.programs.values())
    assert len(progs) == 3 * 4
    assert all(p.pool is ts._pool and not p.tidy and p.nb == 0
               for p in progs)
    assert isinstance(ts._pool, _graph.Pool)
    old = ts._pool
    ts.max_bucket = 64
    _request("ssivae", "encode", ts, 5)
    assert ts._pool is not old
    assert [p.pool for p in ts.programs.values()] == [ts._pool]


@pytest.mark.parametrize("archive", [("ssivae", None, "int8"),
                                     ("ss_reg", 8, None),
                                     ("cond", None, None)],
                         ids=["ssivae_int8", "ss_reg_batch8", "cond"])
def test_program_bodies_equal_eager_bodies(served, programs, monkeypatch,
                                           archive):
    """Every function through its programs (a warm-up, a capture and
    replays) gives the eager bodies' bits at the same buckets, on a ragged
    request over max_bucket too (64 here, to keep it small), and agrees
    with JAX's at the same max_bucket."""
    name = archive[0]
    js, ts = _fresh(served, archive)
    ts.max_bucket = 64
    monkeypatch.setattr(js, "max_bucket", 64)
    for fn in MODELS[name][4]:
        for n in (13, 13, 100, 100):
            got = _request(name, fn, ts, n, seed=n)
            _same(got, _eager(monkeypatch, lambda: _request(name, fn, ts, n,
                                                            seed=n)))
        _close(got, _request(name, fn, js, 100, seed=100))
    assert all(p.replays >= 1 for p in ts.programs.values())


def test_concurrent_requests_are_serialized(served, programs, monkeypatch):
    """Threads sharing one model's static buffers, more threads than
    cores and a short switch interval: every result is its own request's
    (the model's lock holds each fill, run and copy out together)."""
    import os
    import sys
    import threading
    js, ts = _fresh(served, ("ssivae", None, None))
    seeds = range(4)
    refs = {s: _eager(monkeypatch, lambda s=s: _request(
        "ssivae", "decode", ts, 13, seed=s)) for s in seeds}
    errors = []

    def worker(i):
        try:
            for k in range(10):
                s = (i + k) % len(refs)
                _same(_request("ssivae", "decode", ts, 13, seed=s), refs[s])
        except AssertionError as e:  # noqa: PERF203
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2 * (os.cpu_count() or 1) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert ts.programs["decode", 16].replays >= 10
