"""The port's captured chunked streaming and gradient accumulation
(``pyroved_tpu_torch/trainers/_graph.py``) on the CPU: the chunk bodies
(``SVItrainer._chunked_epoch``, ``auxSVItrainer._chunked_epoch``) and the
bodies under ``grad_accum``, which the card captures and replays, run
eagerly here over their static tables (the routing forced to them). They
are held against the JAX package's ``_train_chunked_stream`` and its
``optax.MultiSteps`` ``train``/``run`` on the same weights and noise, and
against the port's eager loop bit for bit; the cache's variants (the full
and the short chunk, the labeled steps' places, the window's position) and
the order in which a chunk feed gathers.

Torch runs a capturable Adam only on devices it lists (CUDA among them,
not the CPU); the module lists the CPU too, so that the update the card
runs, its count and bias corrections in device tensors, runs here."""
import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import DataLoader as JDataLoader
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.utils.data as tdata
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer, _graph, auxSVItrainer
from pyroved_tpu_torch.utils.checkpoint import save_checkpoint
from pyroved_tpu_torch.utils.data import DataLoader
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

from test_torch_port_segmented import JaxNoiseAux, JaxNoiseSVI

# The existing bounds of the port's tests against the JAX trainers, f32 on
# both sides: per-epoch losses, and parameters after a few Adam updates
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
DATA = (12, 12)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))
# 7 batches of 8 an epoch, the last one short; chunks of 3: 3, 3 and 1
N, BS, CHUNKS = 52, 8, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: these small models run faster
    so, and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def f32_port(monkeypatch):
    """The port's hidden products in f32, as the JAX package's CPU path
    computes them; the bitwise cases set the flag themselves."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)


@pytest.fixture(autouse=True)
def capturable_on_cpu(monkeypatch):
    """``torch.optim.Adam(capturable=True)`` runs on the CPU: the CPU
    added to the devices torch's Adam accepts for it."""
    import torch.optim.adam as adam
    listed = adam._get_capturable_supported_devices
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda *a, **k: listed(*a, **k) + ["cpu"])


@pytest.fixture
def bodies(monkeypatch):
    """Every epoch of a DataLoader through the graph-ready bodies (the
    routing forced): on the CPU a program runs its body eagerly."""
    monkeypatch.setattr(_graph, "route", lambda *a, **k: True)


def _x(n=N, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + DATA).astype(
        np.float32)


def _labels(n):
    return np.eye(3, dtype=np.float32)[np.arange(n) % 3]


def _adam(model, lr=1e-3):
    """The card's default optimizer (foreach kernels, as torch picks on
    CUDA)."""
    return torch.optim.Adam(model.nets.parameters(), lr=lr, capturable=True,
                            foreach=True)


def _check_params(tm, jm):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    for name, p in tm.nets.named_parameters():
        np.testing.assert_allclose(as_numpy(p), ref[name].numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


def _adam_steps(optimizer):
    return sorted({int(s["step"]) for s in optimizer.state.values()})


def _streaming(x, *more, chunks=CHUNKS, bs=BS, seed=3, **kw):
    return DataLoader(x, *more, batch_size=bs, seed=seed, device="cpu",
                      device_resident=False, stream_chunks=chunks, **kw)


# ---------------------------------------------------------------------------
# the bodies against the JAX trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_svi_chunk_bodies_match_jax_chunked_stream(accum, bodies):
    """Three epochs of iVAE over a streaming loader in chunks of 3 batches
    (3, 3 and a short 1), the JAX trainer through ``_train_chunked_stream``
    (under ``MultiSteps`` with ``accum`` 2), the port through its chunk
    bodies, the JAX noise injected: per-epoch losses, the window's
    counters, Adam's count and the parameters; then a held-out evaluation
    over a chunked streaming loader."""
    X, Xt = _x(), _x(24, 5)
    jm = jmodels.iVAE(DATA, invariances=["r"], seed=3, **SMALL)
    tm = tmodels.iVAE(DATA, invariances=["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    jt = JSVItrainer(jm, seed=9, grad_accum=accum)
    tt = JaxNoiseSVI(tm, 9, grad_accum=accum, optimizer=_adam(tm))
    jl = JDataLoader(X, batch_size=BS, seed=3, device_resident=False,
                     stream_chunks=CHUNKS)
    tl = _streaming(X)
    for epoch in range(3):
        np.testing.assert_allclose(tt.train(tl), jt.train(jl),
                                   rtol=LOSS_RTOL)
        if accum > 1:
            assert tt.grad_accumulator.mini_step == int(
                jt.opt_state.mini_step) == 7 * (epoch + 1) % accum
            assert _adam_steps(tt.optimizer) == [
                int(jt.opt_state.gradient_step)]
    assert {s[2] for s in tt._graphs.programs} == {3, 1}  # chunk bodies
    np.testing.assert_allclose(
        tt.evaluate(_streaming(Xt, chunks=2)),
        jt.evaluate(JDataLoader(Xt, batch_size=BS, seed=3,
                                device_resident=False, stream_chunks=2)),
        rtol=LOSS_RTOL)
    _check_params(tm, jm)


@pytest.mark.parametrize("accum", [1, 2])
def test_aux_chunk_bodies_match_jax_chunked_stream(accum, bodies):
    """ssiVAE with a streaming unlabeled loader in chunks of 3 (6 batches,
    a labeled step after the 2nd and the 6th: one in each chunk, at
    different places) and a resident labeled loader, the JAX trainer
    through its ``_train_chunked_stream``: losses, the window, both
    optimizers' counts and the parameters over three epochs."""
    xu, xl = _x(48, 1), _x(16, 2)
    yl = _labels(16)
    jm = jmodels.ssiVAE(DATA, 2, 3, ["r"], seed=4, **SMALL)
    tm = tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    jt = JauxSVItrainer(jm, seed=2, grad_accum=accum)
    tt = JaxNoiseAux(tm, 2, grad_accum=accum, optimizer=_adam(tm, 5e-4))
    jlu = JDataLoader(xu, batch_size=BS, seed=1, device_resident=False,
                      stream_chunks=CHUNKS)
    jls = JDataLoader(xl, yl, batch_size=BS, seed=2)
    tlu = _streaming(xu, seed=1)
    tls = DataLoader(xl, yl, batch_size=BS, seed=2, device="cpu")
    for epoch in range(3):
        np.testing.assert_allclose(tt.train(tlu, tls, scale_factor=0.5),
                                   jt.train(jlu, jls, scale_factor=0.5),
                                   rtol=LOSS_RTOL)
        if accum > 1:
            assert tt.grad_accumulator.mini_step == int(
                jt.opt_state.mini_step)
            assert _adam_steps(tt.optimizer) == [
                int(jt.opt_state.gradient_step)] == [4 * (epoch + 1)]
        assert _adam_steps(tt.aux_optimizer) == [2 * (epoch + 1)]
    # one program for each place of a chunk's labeled step
    assert {s[1:3] for s in tt._graphs.programs} == {(3, (1,)), (3, (2,))}
    _check_params(tm, jm)


def test_multisteps_bodies_match_jax_train_and_run(bodies):
    """``grad_accum=2`` over a resident loader of 7 batches (the window
    crosses every epoch boundary): two ``train`` epochs, then ``run`` over
    3 epochs with a ``scale_schedule``, through the bodies (one program
    for each position of the window) against the JAX trainer's
    ``MultiSteps`` scans: losses, counters and parameters."""
    X = _x()
    jm = jmodels.iVAE(DATA, invariances=["r"], seed=3, **SMALL)
    tm = tmodels.iVAE(DATA, invariances=["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    jt = JSVItrainer(jm, seed=9, grad_accum=2)
    tt = JaxNoiseSVI(tm, 9, grad_accum=2, optimizer=_adam(tm))
    from pyroved_tpu.utils.data import init_dataloader as jinit
    from pyroved_tpu_torch.utils.data import init_dataloader as tinit
    jl = jinit(X, batch_size=BS, seed=1)
    tl = tinit(X, batch_size=BS, seed=1, device="cpu")
    for _ in range(2):
        np.testing.assert_allclose(tt.train(tl), jt.train(jl),
                                   rtol=LOSS_RTOL)
    schedule = [0.5, 1.0, 2.0]
    jt.run(jl, 3, scale_schedule=schedule)
    tt.run(tl, 3, scale_schedule=schedule)
    np.testing.assert_allclose(tt.loss_history["training_loss"],
                               jt.loss_history["training_loss"],
                               rtol=LOSS_RTOL)
    assert tt.grad_accumulator.mini_step == int(jt.opt_state.mini_step) == 1
    assert _adam_steps(tt.optimizer) == [int(jt.opt_state.gradient_step)]
    assert set(tt._graphs.programs) == {("svi", True, 0), ("svi", True, 1)}
    _check_params(tm, jm)


def test_aux_multisteps_bodies_match_jax_run(bodies):
    """auxSVItrainer at ``grad_accum=3`` over resident loaders through
    ``run`` (4 basic micro-steps an epoch: the window moves by one each
    epoch), against the JAX trainer's: losses, counters, parameters."""
    xu, xl = _x(48, 1), _x(32, 2)
    yl = _labels(32)
    jm = jmodels.ssiVAE(DATA, 2, 3, ["r"], seed=4, **SMALL)
    tm = tmodels.ssiVAE(DATA, 2, 3, ["r"], device="cpu", **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    jt = JauxSVItrainer(jm, seed=2, grad_accum=3)
    tt = JaxNoiseAux(tm, 2, grad_accum=3, optimizer=_adam(tm, 5e-4))
    from pyroved_tpu.utils.data import init_dataloader as jinit
    from pyroved_tpu_torch.utils.data import init_dataloader as tinit
    jt.run(jinit(xu, batch_size=16, seed=1),
           jinit(xl, yl, batch_size=16, seed=2), 4)
    tt.run(tinit(xu, batch_size=16, seed=1, device="cpu"),
           tinit(xl, yl, batch_size=16, seed=2, device="cpu"), 4)
    np.testing.assert_allclose(tt.history["training_loss"],
                               jt.history["training_loss"], rtol=LOSS_RTOL)
    assert tt.grad_accumulator.mini_step == int(jt.opt_state.mini_step) == 1
    assert _adam_steps(tt.optimizer) == [int(jt.opt_state.gradient_step)
                                         ] == [5]
    assert len(tt._graphs.programs) == 3  # window at 0, 1 and 2
    _check_params(tm, jm)


# ---------------------------------------------------------------------------
# the bodies against the port's eager loop, bit for bit
# ---------------------------------------------------------------------------

def _ivae(**kw):
    return tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=2,
                        **SMALL, **kw)


def _svi_case(loader, epochs=3, model=_ivae, test=None, **trainer_kw):
    """A run of ``epochs`` through ``SVItrainer.run`` over ``loader()``
    (and a held-out ``test()``)."""
    def go():
        m = model()
        t = SVItrainer(m, seed=5, optimizer=_adam(m), **trainer_kw)
        kw = {} if test is None else {"test_loader": test()}
        t.run(loader(), epochs, **kw)
        return m, t
    return go


def _aux_case(stream, accum=1, chunks=CHUNKS):
    def go():
        m = tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], device="cpu",
                           seed=1, **SMALL)
        t = auxSVItrainer(m, seed=5, optimizer=_adam(m, 5e-4),
                          grad_accum=accum)
        xu, xl = _x(48, 1), _x(16, 2)
        lu = (_streaming(xu, chunks=chunks, seed=1) if stream else
              DataLoader(xu, batch_size=BS, seed=1, device="cpu"))
        t.run(lu, DataLoader(xl, _labels(16), batch_size=BS, seed=2,
                             device="cpu"), 3,
              loader_val=DataLoader(xl, _labels(16), batch_size=BS, seed=3,
                                    device="cpu"),
              scale_schedule=[1.0, 0.5, 2.0])
        return m, t
    return go


X8 = np.rint(_x() * 255).astype(np.uint8)
CASES = {
    "chunks_not_dividing": _svi_case(lambda: _streaming(_x()),
                                     test=lambda: _streaming(_x(24, 5), chunks=2)),
    "chunks_uint8_scale": _svi_case(lambda: _streaming(X8, scale=1 / 255.0)),
    "chunks_bfloat16_store": _svi_case(
        lambda: _streaming(_x(), store_dtype="bfloat16")),
    "chunks_one_pass": _svi_case(lambda: _streaming(_x()),
                                 model=lambda: _ivae(one_pass_train=True)),
    "chunks_remat": _svi_case(lambda: _streaming(_x()), remat=True),
    "accum_resident_across_epochs": _svi_case(
        lambda: DataLoader(_x(), batch_size=BS, seed=3, device="cpu"),
        epochs=4, grad_accum=3),
    "accum_chunks": _svi_case(lambda: _streaming(_x()), epochs=4,
                              grad_accum=2),
    "aux_chunks": _aux_case(True),
    "aux_chunks_accum": _aux_case(True, accum=3),
    "aux_resident_accum": _aux_case(False, accum=3),
}


def _state(m, t):
    hist = getattr(t, "loss_history", None) or t.history
    opts = [t.optimizer] + ([t.aux_optimizer] if hasattr(t, "aux_optimizer")
                            else [])
    acc = t.grad_accumulator
    window = None if acc is None else (acc.mini_step, [a.clone()
                                                       for a in acc.acc])
    return (m.nets.state_dict(), hist, t.generator.get_state(),
            [o.state_dict()["state"] for o in opts], window)


def _assert_bitwise(a, b):
    (pa, ha, ga, oa, wa), (pb, hb, gb, ob, wb) = a, b
    assert list(pa) == list(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert ha == hb
    assert torch.equal(ga, gb)
    for sa, sb in zip(oa, ob):
        for i in sa:
            for k in sa[i]:
                assert torch.equal(torch.as_tensor(sa[i][k]),
                                   torch.as_tensor(sb[i][k])), (i, k)
    assert (wa is None) == (wb is None)
    if wa is not None:
        assert wa[0] == wb[0]
        assert all(torch.equal(p, q) for p, q in zip(wa[1], wb[1]))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bodies_equal_eager_loop(case, bf16, monkeypatch):
    """The same run through the chunk and window bodies and through the
    eager loop, under each ``BF16_MATMUL``: parameters, buffers, history,
    noise generator, optimizer states and the ``grad_accum`` window
    bitwise equal."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", bf16)
    go = CASES[case]
    eager = _state(*go())
    route = _graph.route
    monkeypatch.setattr(_graph, "route", lambda *a, **k: True)
    m, t = go()
    monkeypatch.setattr(_graph, "route", route)
    assert t._graphs.made
    _assert_bitwise(_state(m, t), eager)


@pytest.mark.parametrize("stream", [False, True], ids=["resident",
                                                       "chunks"])
def test_resume_mid_window_bitwise(stream, bodies, tmp_path):
    """``grad_accum=2`` over 7 batches an epoch: one epoch through the
    bodies (it ends mid-window), a checkpoint, a fresh model and trainer
    that resume (the window's ``acc`` and ``mini_step`` from the file, its
    programs dropped) and two more, against three in one go: bitwise."""
    x = _x()

    def make(seed):
        m = _ivae()
        if seed:
            for p in m.nets.parameters():
                p.data.add_(1.0)
        return m, SVItrainer(m, seed=7 + seed, grad_accum=2,
                             optimizer=_adam(m))

    def loader(epoch=0):
        ld = (_streaming(x) if stream else
              DataLoader(x, batch_size=BS, seed=3, device="cpu"))
        ld.set_epoch(epoch)
        return ld

    whole_model, whole = make(0)
    whole.run(loader(), 3)
    first_model, first = make(0)
    first.run(loader(), 1)
    assert first.grad_accumulator.mini_step == 1
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, first_model, first)
    model, trainer = make(1)
    trainer.run(loader(), 1)  # programs of its own, dropped by the resume
    own = dict(trainer._graphs.programs)
    assert trainer.resume(path) == 1
    assert trainer.grad_accumulator.mini_step == 1
    trainer.run(loader(1), 2)
    assert not set(own.values()) & set(trainer._graphs.programs.values())
    _assert_bitwise(_state(model, trainer), _state(whole_model, whole))


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_cache_keeps_the_full_and_short_chunk_programs(bodies, tmp_path):
    """A streamed epoch of 3, 3 and 1 batches makes two programs, which
    every later epoch runs again (none made anew), also from a fresh
    loader over other rows of the same shapes; another batch size
    replaces both; ``load_weights`` drops them."""
    m = _ivae()
    t = SVItrainer(m, optimizer=_adam(m))
    t.train(_streaming(_x()))
    progs = dict(t._graphs.programs)
    assert set(progs) == {("svi", True, 3), ("svi", True, 1)}
    assert t._graphs.made == 2
    t.train(_streaming(_x()))
    t.train(_streaming(_x(seed=4)))  # a fresh loader, other rows
    assert t._graphs.made == 2
    assert all(t._graphs.programs[s] is p for s, p in progs.items())
    t.train(_streaming(_x(), bs=4))  # 13 batches: 3 x 4 and 1
    assert set(t._graphs.programs) == {("svi", True, 3), ("svi", True, 1)}
    assert not set(progs.values()) & set(t._graphs.programs.values())
    assert t._graphs.made == 4
    m.save_weights(str(tmp_path / "w"))
    m.load_weights(str(tmp_path / "w"))
    t.train(_streaming(_x(), bs=4))
    assert t._graphs.made == 6


def test_cache_keeps_the_aux_patterns_and_window_positions(bodies):
    """auxSVItrainer over a chunked unlabeled loader: one program for each
    labeled-step pattern of a chunk, run again every epoch; under
    ``grad_accum=4`` one for each pattern and window position, those of
    ``_graph.variants`` of the schedule from the window's position: a window
    moved (as a resume mid-window moves it) takes programs of its own, and
    those of the old position, which its cycle never reaches, go."""
    m = tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], device="cpu", seed=1,
                       **SMALL)
    t = auxSVItrainer(m, optimizer=_adam(m, 5e-4))
    xu, xl = _x(48, 1), _x(16, 2)
    ls = DataLoader(xl, _labels(16), batch_size=BS, seed=2, device="cpu")
    for _ in range(3):
        t.train(_streaming(xu, seed=1), ls)
    assert set(t._graphs.programs) == {("aux", 3, (1,)), ("aux", 3, (2,))}
    assert t._graphs.made == 2
    m2 = tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], device="cpu", seed=1,
                        **SMALL)
    t2 = auxSVItrainer(m2, optimizer=_adam(m2, 5e-4), grad_accum=4)
    seen = []
    for _ in range(4):  # 8 basic micro-steps an epoch, 4 in each chunk
        t2.train(_streaming(xu, seed=1), ls)
        seen.append(list(t2._graphs.programs))
    assert seen[-1] == [("aux", 3, (1,), 0), ("aux", 3, (2,), 0)]
    assert t2._graphs.made == 2
    t2.grad_accumulator.mini_step = 1  # as a resume mid-window leaves it
    for _ in range(2):
        t2.train(_streaming(xu, seed=1), ls)
    assert list(t2._graphs.programs) == [("aux", 3, (1,), 1),
                                         ("aux", 3, (2,), 1)]
    assert t2._graphs.made == 4


def _window(k, m=0):
    """A trainer's part that ``_graph.variants`` reads: its window."""
    from types import SimpleNamespace
    acc = None if k == 1 else SimpleNamespace(k=k, mini_step=m)
    return SimpleNamespace(grad_accumulator=acc)


def _aux_runs(nb, c, p):
    """An auxSVItrainer epoch's runs over ``nb`` unlabeled batches in
    chunks of ``c`` at the cadence ``p`` (``_schedule``'s mask)."""
    mask = auxSVItrainer._schedule(None, None, nb, 1, p)[0]
    runs = []
    for start in range(0, nb, c):
        n = min(c, nb - start)
        labeled = tuple(np.flatnonzero(mask[start:start + n]))
        runs.append(((n, labeled), n + len(labeled)))
    return runs


@pytest.mark.parametrize("runs,k,start,expected", [
    ([((3,), 3), ((3,), 3), ((1,), 1)], 1, 0, 2),       # full, short
    ([((), 80)], 4, 0, 1),                              # nb % k == 0
    ([((), 82)], 4, 0, 2),                              # windows 0, 2
    ([((), 82)], 4, 1, 2),                              # windows 1, 3
    ([((), 81)], 4, 0, 4),                              # every window
    ([((24,), 24)] * 3 + [((8,), 8)], 4, 0, 2),         # chunks of 24
    ([((3,), 0), ((3,), 0), ((1,), 0)], 4, 2, 2),       # evaluation
    (_aux_runs(300, 64, 21), 1, 0, 5),                  # a program a chunk
    (_aux_runs(64 * 30 + 10, 64, 21), 1, 0, 22),        # p / gcd(c, p) + 1
    (_aux_runs(64 * 30 + 10, 64, 16), 1, 0, 2),         # p divides c
], ids=["chunks", "accum80", "accum82", "accum82_from1", "accum81",
        "accum_chunks", "eval", "aux_n300_p21", "aux_n1920_p21",
        "aux_p16"])
def test_variants_follow_the_schedule(runs, k, start, expected):
    """The programs a kind keeps follow from its epoch's chunks, the
    labeled cadence, the window and the batches an epoch: at a cadence of
    21 in chunks of 64, one a chunk up to the 21 patterns and the short
    chunk, and one where the cadence divides the chunk (and its short
    chunk)."""
    assert len(_graph.variants(_window(k, start), runs)) == expected


def test_cache_holds_every_variant_of_its_cycle():
    """A kind whose schedule takes more variants than any fixed bound
    (here 24 a cycle) keeps them all: three cycles make 24 programs, the
    later cycles run them again; a schedule of fewer drops the others."""
    m = _ivae()
    t = SVItrainer(m, optimizer=_adam(m))
    cache, ran = t._graphs, []
    cycle = frozenset((v,) for v in range(24))

    def make(v):
        return _graph.Program("cpu", 1, lambda i: ran.append(v),
                              lambda: (), None)

    for _ in range(3):
        for v in range(24):
            cache.run(t, ("k",), "key", lambda v=v: make(v), lambda t: None,
                      variant=(v,), keep=cycle)
    assert cache.made == 24 and len(cache.programs) == 24
    assert ran == list(range(24)) * 3
    cache.run(t, ("k",), "key", lambda: make(0), lambda t: None,
              variant=(0,), keep=frozenset({(0,), (5,)}))
    assert list(cache.programs) == [("k", 5), ("k", 0)]
    assert cache.made == 24


def test_aux_cadence_past_sixteen_patterns_makes_each_once(bodies):
    """auxSVItrainer at a cadence of 18 over 306 unlabeled batches in
    chunks of 17: every chunk of an epoch has a labeled-step pattern of
    its own (18 of them), each made once in the first epoch and run again
    in the second, none remade: ``_graph.variants``' 18."""
    m = tmodels.ssiVAE((6, 6), 2, 3, invariances=["r"], device="cpu",
                       seed=1, hidden_dim_e=(8,), hidden_dim_d=(8,))
    t = auxSVItrainer(m, optimizer=_adam(m, 5e-4))
    rng = np.random.default_rng(0)
    xu = rng.uniform(0, 1, (306 * 2, 6, 6)).astype(np.float32)
    lu = DataLoader(xu, batch_size=2, seed=1, device="cpu",
                    device_resident=False, stream_chunks=17)
    ls = DataLoader(xu[:8], _labels(8), batch_size=2, seed=2, device="cpu")
    t.train(lu, ls, sup_period=18)
    first = dict(t._graphs.programs)
    t.train(lu, ls, sup_period=18)
    assert t._graphs.made == len(first) == 18 == len(_graph.variants(
        t, _aux_runs(306, 17, 18)))
    assert all(t._graphs.programs[s] is p for s, p in first.items())


def test_replaced_window_takes_a_new_program(bodies):
    """A program under ``grad_accum`` reads the window's ``acc`` in place:
    replacing it (as a split onto a mesh does) makes the program again."""
    m = _ivae()
    t = SVItrainer(m, optimizer=_adam(m), grad_accum=2)
    ld = DataLoader(_x(48), batch_size=BS, seed=3, device="cpu")
    t.train(ld)
    (prog,) = t._graphs.programs.values()
    t.train(ld)
    assert t._graphs.programs[("svi", True, 0)] is prog
    t.grad_accumulator.acc = [a.clone() for a in t.grad_accumulator.acc]
    t.train(ld)
    assert t._graphs.programs[("svi", True, 0)] is not prog
    assert _graph._addresses(t)[-len(t.grad_accumulator.acc):] == tuple(
        a.data_ptr() for a in t.grad_accumulator.acc)


def test_chunk_feed_gathers_after_the_launch(monkeypatch):
    """``chunk_feed`` gathers a chunk's rows only when the consumer asks
    for it, after it has run the chunk before; ``put`` copies the rows in
    their stored dtype into the first rows of the tables; the tables'
    batches are the eager loop's."""
    events = []
    gather = tdata.gather_rows

    def recording(a, rows, out=None):
        events.append(("gather", len(rows)))
        return gather(a, rows, out=out)

    monkeypatch.setattr(tdata, "gather_rows", recording)
    ld = _streaming(X8, scale=0.5)
    idx, _ = ld.epoch_indices(0)
    tables = ld.chunk_tables(CHUNKS)
    assert [t.dtype for t in tables] == [torch.uint8]
    got = []
    for start, c, put in ld.chunk_feed(idx):
        events.append(("run", start, c))
        put(tables)
        got += [ld.chunk_batch(tables, i)[0] for i in range(c)]
    assert events == [("gather", 24), ("run", 0, 3), ("gather", 24),
                      ("run", 3, 3), ("gather", 8), ("run", 6, 1)]
    ref = list(ld.padded_batches(idx))
    assert len(got) == len(ref) == 7
    for a, (b,) in zip(got, ref):
        assert a.dtype == torch.float32
        assert torch.equal(a[:b.shape[0]], b)


def test_metric_route_takes_resident_loaders_only():
    """The labeled-set metric gathers from a resident loader's arrays:
    its route refuses a chunked streaming loader, which the training
    epoch's route takes as its first loader."""
    m = tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], device="cpu", **SMALL)
    t = auxSVItrainer(m, optimizer=_adam(m, 5e-4))
    ld = _streaming(_x(24), _labels(24))
    resident = DataLoader(_x(24), _labels(24), batch_size=BS, device="cpu")
    assert _graph.route(t, (ld, resident), "cuda")
    assert not _graph.route(t, (resident, ld), "cuda")
    assert not _graph.route(t, (ld,), "cuda", chunked=False)
    assert _graph.route(t, (resident,), "cuda", chunked=False)
