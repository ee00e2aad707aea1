"""The port's pixel-chunked captured epochs (``pixel_chunks=k`` under
``pyroved_tpu_torch/trainers/_graph.py``) on the CPU: the graph-ready epoch
bodies, which the card captures and replays with a step's k grid tiles
inside, run eagerly here over their static tables (the routing forced to
them). They are held against the JAX trainers' ``train``/``run`` and
``auxSVItrainer.run`` at the same ``pixel_chunks`` on the same weights and
noise, on the kernels' path (the wrappers' plain versions here) and on the
module path, and against the port's eager loop bit for bit (``remat``,
``grad_accum`` over a chunked streaming loader, the families, a resume).
The module path's tile checkpoint keeps no RNG state, which a capture
would refuse to read, and gives what a checkpoint that keeps it gives. A
``pixel_chunks`` flip between epochs makes a new program.

144 pixels over k = 5 tiles of 29: the last tile holds one padded, masked
pixel. Both sides compute in f32 (the port's ``BF16_MATMUL`` cleared)."""
import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.models.base as tbase
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer, _graph, auxSVItrainer
from pyroved_tpu_torch.utils.checkpoint import save_checkpoint
from pyroved_tpu_torch.utils.data import DataLoader, init_dataloader
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

from test_torch_port_segmented import JaxNoiseAux, JaxNoiseSVI

# The existing bounds of the port's tests against the JAX trainers, f32 on
# both sides: per-epoch losses, and parameters after a few Adam updates
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
ACC_RTOL = 1e-6
DATA = (12, 12)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))
K = 5  # 144 pixels: 5 tiles of 29, one pixel padded (3 would divide 144)
PATHS = {"kernels": True, "module": False}


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
    computes them."""
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


def _images(n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 12),
                         indexing="ij")
    th = rng.uniform(0, 2 * np.pi, n)[:, None, None]
    xr = xx[None] * np.cos(th) - yy[None] * np.sin(th)
    return np.exp(-(xr ** 2) / 0.05 - (yy[None] ** 2) / 0.3).astype(
        np.float32)


def _labels(n):
    return np.eye(3, dtype=np.float32)[np.arange(n) % 3]


def _adam(model, lr=1e-3):
    """The card's default optimizer (foreach kernels, as torch picks on
    CUDA)."""
    return torch.optim.Adam(model.nets.parameters(), lr=lr, capturable=True,
                            foreach=True)


def _pair(family, fused=True, seed=3):
    """A JAX model and the port's (its kernels' or its module path), both
    at ``pixel_chunks=K``, with the JAX model's weights."""
    args = {"iVAE": (), "ssiVAE": (2, 3)}[family]
    jm = getattr(jmodels, family)(DATA, *args, invariances=["r"], seed=seed,
                                  pixel_chunks=K, **SMALL)
    tm = getattr(tmodels, family)(DATA, *args, invariances=["r"],
                                  device="cpu", fused=fused, pixel_chunks=K,
                                  **SMALL)
    assert tm._fused == fused and tm._pixel_mode() == "chunk"
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _check_params(tm, jm):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    for name, p in tm.nets.named_parameters():
        np.testing.assert_allclose(as_numpy(p), ref[name].numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


def _count_tiles(monkeypatch):
    """Calls of the K1 and K2 wrappers (their plain versions on the
    CPU)."""
    calls = {"K1": 0, "K2": 0}
    for k, name in (("K1", "fused_spatial_decoder_forward"),
                    ("K2", "fused_spatial_decoder_backward")):
        fn = getattr(tsd, name)

        def counted(*a, _fn=fn, _k=k, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tsd, name, counted)
    return calls


# ---------------------------------------------------------------------------
# the bodies against the JAX trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", sorted(PATHS))
def test_svi_pixel_bodies_match_jax_train_and_run(path, bodies):
    """A ``train`` epoch, then ``run`` over 2 epochs with a
    ``scale_schedule`` and a held-out loader, at ``pixel_chunks=5`` in both
    packages: the port's captured bodies (capturable Adam, the JAX
    trainer's noise) against the JAX trainer's per-epoch losses, held-out
    losses and parameters."""
    x, xt = _images(32, 0), _images(16, 1)
    jm, tm = _pair("iVAE", PATHS[path])
    jt = JSVItrainer(jm, seed=9)
    tt = JaxNoiseSVI(tm, 9, optimizer=_adam(tm))
    jl, tl = (jinit_dataloader(x, batch_size=16, seed=3),
              init_dataloader(x, batch_size=16, seed=3, device="cpu"))
    np.testing.assert_allclose(tt.train(tl), jt.train(jl), rtol=LOSS_RTOL)
    schedule = [0.5, 2.0]
    jt.run(jl, 2, scale_schedule=schedule,
           test_loader=jinit_dataloader(xt, batch_size=16, seed=4))
    tt.run(tl, 2, scale_schedule=schedule,
           test_loader=init_dataloader(xt, batch_size=16, seed=4,
                                       device="cpu"))
    assert set(tt._graphs.programs) == {("svi", True), ("svi", False)}
    for key, ref in jt.loss_history.items():
        np.testing.assert_allclose(tt.loss_history[key], ref, rtol=LOSS_RTOL)
    _check_params(tm, jm)


def test_aux_pixel_body_matches_jax_run(bodies):
    """ssiVAE at ``pixel_chunks=5`` through ``auxSVItrainer.run`` over 2
    epochs with a ``scale_schedule`` and the labeled-set accuracy each
    epoch: the captured epoch and metric bodies against the JAX trainer's
    losses, accuracies and parameters."""
    xu, xl = _images(32, 7), _images(16, 8)
    y1h = _labels(16)
    jm, tm = _pair("ssiVAE", seed=4)
    jt = JauxSVItrainer(jm, seed=2)
    tt = JaxNoiseAux(tm, 2, optimizer=_adam(tm, 5e-4))
    jl = (jinit_dataloader(xu, batch_size=16, seed=1),
          jinit_dataloader(xl, y1h, batch_size=8, seed=2, random_sampler=True),
          jinit_dataloader(xl, y1h, batch_size=8, seed=3))
    tl = (init_dataloader(xu, batch_size=16, seed=1, device="cpu"),
          init_dataloader(xl, y1h, batch_size=8, seed=2, random_sampler=True,
                          device="cpu"),
          init_dataloader(xl, y1h, batch_size=8, seed=3, device="cpu"))
    schedule = [2.0, 0.5]
    jt.run(jl[0], jl[1], 2, loader_val=jl[2], scale_schedule=schedule)
    tt.run(tl[0], tl[1], 2, loader_val=tl[2], scale_schedule=schedule)
    assert set(tt._graphs.programs) == {("aux",), ("metric",)}
    np.testing.assert_allclose(tt.history["training_loss"],
                               jt.history["training_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.history["test"], jt.history["test"],
                               rtol=ACC_RTOL)
    _check_params(tm, jm)


# ---------------------------------------------------------------------------
# the bodies against the port's eager loop, bit for bit
# ---------------------------------------------------------------------------

def _streaming(x, chunks=2, bs=8, seed=3):
    return DataLoader(x, batch_size=bs, seed=seed, device="cpu",
                      device_resident=False, stream_chunks=chunks)


def _svi_case(fused=True, loader=None, test=True, **trainer_kw):
    """3 epochs of ``run`` at ``pixel_chunks=K`` (a ``scale_schedule``, a
    held-out loader unless ``test`` is False)."""
    def go():
        m = tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=2,
                         fused=fused, pixel_chunks=K, **SMALL)
        t = SVItrainer(m, seed=5, optimizer=_adam(m), **trainer_kw)
        x = _images(40, 2)
        ld = (init_dataloader(x, batch_size=16, seed=1, device="cpu")
              if loader is None else loader(x))
        kw = ({"test_loader": init_dataloader(_images(16, 3), batch_size=8,
                                              seed=2, device="cpu")}
              if test else {})
        t.run(ld, 3, scale_schedule=[0.5, 1.0, 2.0], **kw)
        return m, t
    return go


def _aux_case(family, fused=True, **trainer_kw):
    def go():
        args = {"ssiVAE": (2, 3), "ss_reg_iVAE": (2, 1)}[family]
        m = getattr(tmodels, family)(DATA, *args, invariances=["r"],
                                     device="cpu", seed=1, fused=fused,
                                     pixel_chunks=K, **SMALL)
        t = auxSVItrainer(m, seed=5, optimizer=_adam(m, 5e-4), **trainer_kw)
        xu, xl = _images(32, 7), _images(16, 8)
        y = _labels(16) if family == "ssiVAE" else _labels(16)[:, :1] - 0.5
        t.run(init_dataloader(xu, batch_size=16, seed=1, device="cpu"),
              init_dataloader(xl, y, batch_size=8, seed=2,
                              random_sampler=True, device="cpu"), 3,
              loader_val=init_dataloader(xl, y, batch_size=8, seed=3,
                                         device="cpu"),
              scale_schedule=[1.0, 0.5, 2.0])
        return m, t
    return go


CASES = {
    "kernels": _svi_case(),
    "module": _svi_case(fused=False),
    "kernels_remat": _svi_case(remat=True, test=False),
    "module_remat": _svi_case(fused=False, remat=True, test=False),
    "kernels_accum_chunks": _svi_case(loader=_streaming, grad_accum=2,
                                      test=False),
    "module_accum_chunks": _svi_case(fused=False, loader=_streaming,
                                     grad_accum=2, test=False),
    "jivae_topk": None,  # below: enum_topk is a model keyword
    "ssivae": _aux_case("ssiVAE"),
    "ss_reg_ivae_module": _aux_case("ss_reg_iVAE", fused=False),
}


def _jivae_topk():
    """jiVAE's two most probable classes enumerated over the tiles."""
    m = tmodels.jiVAE(DATA, 2, 3, invariances=["r"], device="cpu", seed=2,
                      enum_topk=2, pixel_chunks=K, **SMALL)
    t = SVItrainer(m, seed=5, optimizer=_adam(m))
    t.run(init_dataloader(_images(32, 2), batch_size=16, seed=1,
                          device="cpu"), 3, scale_factor=(0.5, 2.0))
    return m, t


CASES["jivae_topk"] = _jivae_topk


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


@pytest.mark.parametrize("case", sorted(CASES))
def test_pixel_bodies_equal_eager_loop(case, monkeypatch):
    """The same pixel-chunked run through the graph-ready bodies and
    through the eager loop: parameters, buffers, history, noise generator,
    optimizer states and the ``grad_accum`` window bitwise equal, and the
    same tiles decoded (k K1 and k K2 a training step on the kernels'
    path)."""
    go = CASES[case]
    calls = _count_tiles(monkeypatch)
    eager = _state(*go())
    eager_calls = dict(calls)
    calls.update(K1=0, K2=0)
    route = _graph.route
    monkeypatch.setattr(_graph, "route", lambda *a, **k: True)
    m, t = go()
    monkeypatch.setattr(_graph, "route", route)
    assert t._graphs.made
    _assert_bitwise(_state(m, t), eager)
    assert calls == eager_calls
    if m._fused:
        assert calls["K2"] > 0 and calls["K2"] % K == 0
    else:
        assert calls["K1"] == calls["K2"] == 0


def test_pixel_resume_bitwise(bodies, tmp_path):
    """The module path at ``pixel_chunks=5`` under ``remat=True``: 2 epochs
    through the bodies, a checkpoint, a fresh model and trainer that
    resume (their own program dropped) and 2 more, against 4 in one go:
    bitwise."""
    x = _images(40, 5)

    def make(seed):
        m = tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=2 + seed,
                         fused=False, pixel_chunks=K, **SMALL)
        return m, SVItrainer(m, seed=7 + seed, remat=True,
                             optimizer=_adam(m))

    def loader(epoch=0):
        ld = init_dataloader(x, batch_size=16, seed=1, device="cpu")
        ld.set_epoch(epoch)
        return ld

    whole_model, whole = make(0)
    whole.run(loader(), 4)
    first_model, first = make(0)
    first.run(loader(), 2)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, first_model, first)
    model, trainer = make(1)
    trainer.run(loader(), 1)  # a program of its own, dropped by the resume
    (own,) = trainer._graphs.programs.values()
    assert trainer.resume(path) == 2
    trainer.run(loader(2), 2)
    assert trainer._graphs.programs[("svi", True)] is not own
    _assert_bitwise(_state(model, trainer), _state(whole_model, whole))


# ---------------------------------------------------------------------------
# the tile checkpoint and the key
# ---------------------------------------------------------------------------

def test_tile_checkpoint_reads_no_rng_state(monkeypatch):
    """On the module path, a step's k tile checkpoints (and
    ``SVItrainer(remat=True)``'s checkpoint around them) read no RNG
    state: ``torch.get_rng_state`` raising changes nothing. The grads
    equal, bit for bit, those of tile checkpoints that keep the RNG
    state."""
    x = torch.from_numpy(_images(8, 9))
    eps = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))

    def grads(model):
        model.nets.zero_grad(set_to_none=True)
        model.loss_fn(x, eps=eps).sum().backward()
        return [p.grad.clone() for p in model.nets.parameters()]

    def model():
        return tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=2,
                            fused=False, pixel_chunks=K, **SMALL)

    checkpoint = tbase.checkpoint
    with monkeypatch.context() as mp:
        mp.setattr(tbase, "checkpoint", lambda *a, **k: checkpoint(
            *a, **{**k, "preserve_rng_state": True}))
        keeping = grads(model())

    def no_rng(*a, **k):
        raise RuntimeError("the RNG state was read")

    monkeypatch.setattr(torch, "get_rng_state", no_rng)
    with pytest.raises(RuntimeError, match="RNG state"):  # the check holds
        with monkeypatch.context() as mp:
            mp.setattr(tbase, "checkpoint", lambda *a, **k: checkpoint(
                *a, **{**k, "preserve_rng_state": True}))
            grads(model())
    got = grads(model())
    assert all(torch.equal(a, b) for a, b in zip(got, keeping))
    m = model()
    t = SVItrainer(m, seed=1, remat=True, optimizer=_adam(m))
    assert np.isfinite(t.train(init_dataloader(_images(16, 4), batch_size=8,
                                               device="cpu")))


def test_pixel_chunks_flip_makes_a_new_program(bodies):
    """``model.pixel_chunks`` set between epochs is part of the key (as the
    JAX trainers' ``_pixel_gate_key`` retraces their scans): the next
    epoch makes a new program, one more epoch at the same k keeps it, and
    going back to the full grid makes another."""
    m = tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=2,
                     pixel_chunks=3, **SMALL)
    t = SVItrainer(m, optimizer=_adam(m))
    ld = init_dataloader(_images(32, 0), batch_size=16, device="cpu")
    progs = []
    for k in (3, 3, K, K, 0):
        m.pixel_chunks = k
        t.train(ld)
        progs.append(t._graphs.programs[("svi", True)])
    a, b, c, d, e = progs
    assert a is b and b is not c and c is d and d is not e
    assert t._graphs.made == 3 and len(t._graphs.programs) == 1
    key = _graph.settings(t)
    m.pixel_chunks = 4
    assert _graph.settings(t) != key
