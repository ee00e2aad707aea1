"""The port's captured epochs (``pyroved_tpu_torch/trainers/_graph.py``) on
the CPU: the graph-ready epoch bodies, which the card captures and
replays, run eagerly here over their static tables (the routing forced
to them) and are held against the JAX package's trainers (``train``,
``run`` with ``scale_schedule`` and a held-out loader, ``auxSVItrainer.run``
with its labeled-set metric) on the same weights and noise, and against
the port's eager loop bit for bit; ``torch.optim.Adam(capturable=True)``,
the card's default, against ``optax.adam``; a resume of the bodies through
a checkpoint; the routing of every configuration; the static tables and
the programs' keys and invalidation.

Torch runs a capturable Adam only on devices it lists (CUDA among them,
not the CPU); the module lists the CPU too, so that the update the card
runs, its count and bias corrections in device tensors, runs here."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer, _graph, auxSVItrainer
from pyroved_tpu_torch.utils.checkpoint import save_checkpoint
from pyroved_tpu_torch.utils.data import (DataLoader, StaticTables,
                                          init_dataloader)
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

from test_torch_port_segmented import JaxNoiseAux, JaxNoiseSVI

# The existing bounds of the port's tests against the JAX trainers, f32 on
# both sides: per-epoch losses, parameters after a few Adam updates, and
# the optimizer's outputs
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
OUT_ATOL = 1e-5
ACC_RTOL = 1e-6
DATA = (12, 12)
SMALL = dict(hidden_dim_e=(32,), hidden_dim_d=(32,))


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
    """Every epoch of a resident DataLoader through the graph-ready body
    (the routing forced): on the CPU a program runs its body eagerly."""
    monkeypatch.setattr(_graph, "route", lambda *a, **k: True)


def _images(n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 12),
                         indexing="ij")
    th = rng.uniform(0, 2 * np.pi, n)[:, None, None]
    xr = xx[None] * np.cos(th) - yy[None] * np.sin(th)
    return np.exp(-(xr ** 2) / 0.05 - (yy[None] ** 2) / 0.3).astype(
        np.float32)


def _pair(family, seed=3, **kw):
    """A JAX model and the port's with the JAX model's weights."""
    args = {"ivae": (), "jivae": (2, 3), "ssivae": (2, 3)}[family]
    jcls = {"ivae": jmodels.iVAE, "jivae": jmodels.jiVAE,
            "ssivae": jmodels.ssiVAE}[family]
    tcls = {"ivae": tmodels.iVAE, "jivae": tmodels.jiVAE,
            "ssivae": tmodels.ssiVAE}[family]
    jm = jcls(DATA, *args, invariances=["r"], seed=seed, **SMALL, **kw)
    tm = tcls(DATA, *args, invariances=["r"], device="cpu", **SMALL, **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _capturable_adam(model, lr=1e-3):
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


# ---------------------------------------------------------------------------
# the bodies against the JAX trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["ivae", "jivae"])
def test_svi_body_matches_jax_train_and_run(family, bodies):
    """Two ``train`` epochs, then ``run`` over 3 epochs with a
    ``scale_schedule`` and a held-out loader: the port's captured bodies
    (capturable Adam, the JAX trainer's noise) against the JAX trainer's
    per-epoch losses, held-out losses and parameters."""
    x, xt = _images(48, 0), _images(32, 1)
    jm, tm = _pair(family)
    jt = JSVItrainer(jm, seed=9)
    tt = JaxNoiseSVI(tm, 9, optimizer=_capturable_adam(tm))
    jl, tl = (jinit_dataloader(x, batch_size=16, seed=3),
              init_dataloader(x, batch_size=16, seed=3, device="cpu"))
    for _ in range(2):
        np.testing.assert_allclose(tt.train(tl), jt.train(jl),
                                   rtol=LOSS_RTOL)
    schedule = [0.5, 1.0, 2.0]
    jt.run(jl, 3, scale_schedule=schedule,
           test_loader=jinit_dataloader(xt, batch_size=16, seed=4))
    tt.run(tl, 3, scale_schedule=schedule,
           test_loader=init_dataloader(xt, batch_size=16, seed=4,
                                       device="cpu"))
    assert tt._graphs.programs  # the bodies ran
    for key, ref in jt.loss_history.items():
        np.testing.assert_allclose(tt.loss_history[key], ref, rtol=LOSS_RTOL)
    _check_params(tm, jm)


def _ss_data():
    x = _images(64, 7)
    y = (np.arange(64) % 3).astype(np.int64)
    x = x * (1.0 + 0.5 * y[:, None, None]) / 2.0  # brightness by class
    return x[:48], x[48:], np.eye(3, dtype=np.float32)[y[48:]]


def test_aux_body_matches_jax_run(bodies):
    """ssiVAE through ``auxSVItrainer.run`` over 3 epochs with a
    ``scale_schedule`` and the labeled-set accuracy each epoch: the
    captured epoch and metric bodies against the JAX trainer's losses,
    accuracies and parameters."""
    xu, xl, y1h = _ss_data()
    jm, tm = _pair("ssivae", seed=4)
    jt = JauxSVItrainer(jm, seed=2)
    tt = JaxNoiseAux(tm, 2, optimizer=_capturable_adam(tm, 5e-4))
    assert _graph.graph_optimizer(tt.aux_optimizer)
    jl = (jinit_dataloader(xu, batch_size=16, seed=1),
          jinit_dataloader(xl, y1h, batch_size=8, seed=2, random_sampler=True),
          jinit_dataloader(xl, y1h, batch_size=8, seed=3))
    tl = (init_dataloader(xu, batch_size=16, seed=1, device="cpu"),
          init_dataloader(xl, y1h, batch_size=8, seed=2, random_sampler=True,
                          device="cpu"),
          init_dataloader(xl, y1h, batch_size=8, seed=3, device="cpu"))
    schedule = [1.0, 2.0, 0.5]
    jt.run(jl[0], jl[1], 3, loader_val=jl[2], scale_schedule=schedule)
    tt.run(tl[0], tl[1], 3, loader_val=tl[2], scale_schedule=schedule)
    assert set(tt._graphs.programs) == {("aux",), ("metric",)}
    np.testing.assert_allclose(tt.history["training_loss"],
                               jt.history["training_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.history["test"], jt.history["test"],
                               rtol=ACC_RTOL)
    _check_params(tm, jm)


# ---------------------------------------------------------------------------
# the bodies against the port's eager loop, bit for bit
# ---------------------------------------------------------------------------

def _ivae(**kw):
    return tmodels.iVAE(DATA, invariances=["r"], device="cpu", seed=2,
                        **SMALL, **kw)


def _svi_case(model, capturable, **run_kw):
    def go(force):
        m = model()
        kw = {"optimizer": _capturable_adam(m)} if capturable else {}
        t = SVItrainer(m, seed=5, **kw)
        x, xt = _images(56, 2), _images(24, 3)
        t.run(init_dataloader(x, batch_size=16, seed=1, device="cpu"), 4,
              test_loader=init_dataloader(xt, batch_size=16, seed=2,
                                          device="cpu"), **run_kw)
        return m, t
    return go


def _aux_case(family, capturable):
    def go(force):
        if family == "ssivae":
            m = tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], device="cpu",
                               seed=1, **SMALL)
        else:
            m = tmodels.ss_reg_iVAE(DATA, 2, 1, invariances=["r"],
                                    device="cpu", seed=1, **SMALL)
        kw = {"optimizer": _capturable_adam(m, 5e-4)} if capturable else {}
        t = auxSVItrainer(m, seed=5, **kw)
        xu, xl, y1h = _ss_data()
        y = y1h if family == "ssivae" else y1h[:, :1] * 2.0 - 0.5
        t.run(init_dataloader(xu, batch_size=16, seed=1, device="cpu"),
              init_dataloader(xl, y, batch_size=8, seed=2,
                              random_sampler=True, device="cpu"), 3,
              loader_val=init_dataloader(xl, y, batch_size=8, seed=3,
                                         device="cpu"),
              scale_schedule=[1.0, 0.5, 2.0])
        return m, t
    return go


CASES = {
    "ivae_schedule": _svi_case(_ivae, False,
                               scale_schedule=[0.5, 1.0, 2.0, 1.0]),
    "ivae_capturable_adam": _svi_case(_ivae, True),
    "ivae_lr_change": None,  # below: lr changed between epochs
    "ivae_one_pass": _svi_case(lambda: _ivae(one_pass_train=True), True),
    "ivae_remat": None,  # below: remat is a trainer keyword
    "jivae_enum_schedule": _svi_case(
        lambda: tmodels.jiVAE(DATA, 2, 3, invariances=["r"], device="cpu",
                              seed=2, enum_topk=2, **SMALL), True,
        enum_schedule=2, scale_factor=(0.5, 2.0)),
    "ssivae": _aux_case("ssivae", True),
    "ss_reg_ivae": _aux_case("ss_reg", False),
}


def _remat_case(force):
    m = _ivae()
    t = SVItrainer(m, seed=5, remat=True, optimizer=_capturable_adam(m))
    t.run(init_dataloader(_images(40, 4), batch_size=16, seed=1,
                          device="cpu"), 3)
    return m, t


def _lr_case(force):
    """Two epochs, the learning rate halved (as a scheduler writes it),
    two more: the second program reads the new rate."""
    m = _ivae()
    t = SVItrainer(m, seed=5, optimizer=_capturable_adam(m))
    ld = init_dataloader(_images(40, 4), batch_size=16, seed=1, device="cpu")
    t.run(ld, 2)
    for g in t.optimizer.param_groups:
        g["lr"] = 5e-4
    t.run(ld, 2)
    return m, t


CASES["ivae_remat"] = _remat_case
CASES["ivae_lr_change"] = _lr_case


def _state(m, t):
    hist = getattr(t, "loss_history", None) or t.history
    opts = [t.optimizer] + ([t.aux_optimizer] if hasattr(t, "aux_optimizer")
                            else [])
    return (m.nets.state_dict(), hist, t.generator.get_state(),
            [o.state_dict()["state"] for o in opts])


def _assert_bitwise(a, b):
    (pa, ha, ga, oa), (pb, hb, gb, ob) = a, b
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_body_equals_eager_loop(case, monkeypatch):
    """The same run through the graph-ready bodies and through the eager
    loop: parameters, buffers, history, noise generator and optimizer
    states bitwise equal."""
    go = CASES[case]
    eager = _state(*go(False))
    route = _graph.route
    monkeypatch.setattr(_graph, "route", lambda *a, **k: True)
    m, t = go(True)
    monkeypatch.setattr(_graph, "route", route)
    assert t._graphs.programs
    _assert_bitwise(_state(m, t), eager)


def test_captured_resume_bitwise(bodies, tmp_path):
    """2 epochs through the bodies, a checkpoint, a fresh model and trainer
    that resume (Adam's device step count and the generator from the
    file; the resume drops the trainer's programs) and 2 more, against 4
    in one go: bitwise."""
    x = _images(48, 5)

    def make(seed):
        m = _ivae(one_pass_train=False)
        return m, SVItrainer(m, seed=7 + seed, optimizer=_capturable_adam(m))

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
    steps = {int(s["step"]) for s in trainer.optimizer.state.values()}
    assert steps == {6}
    trainer.run(loader(2), 2)
    assert trainer._graphs.programs[("svi", True)] is not own
    _assert_bitwise(_state(model, trainer), _state(whole_model, whole))


def test_checkpoint_keeps_the_live_optimizers_implementation(tmp_path):
    """A file saved by a CPU trainer (``torch.optim.Adam``, its count on
    the host, ``capturable`` off) loads into a trainer stepping with a
    capturable Adam: the live optimizer keeps ``capturable``, its count
    becomes a float32 tensor, the moments are the file's, and the next
    epoch steps;
    the other way round, the CPU trainer's Adam stays as it was built."""
    x = _images(32, 6)
    src_model = _ivae()
    src = SVItrainer(src_model)
    src.train(init_dataloader(x, batch_size=16, device="cpu"))
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, src_model, src)
    m = _ivae()
    t = SVItrainer(m, optimizer=_capturable_adam(m))
    t.resume(path)
    assert all(g["capturable"] for g in t.optimizer.param_groups)
    for p, q in zip(m.nets.parameters(), src_model.nets.parameters()):
        st, ref = t.optimizer.state[p], src.optimizer.state[q]
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 2
        assert torch.equal(st["exp_avg"], ref["exp_avg"])
    t.train(init_dataloader(x, batch_size=16, device="cpu"))
    assert {float(s["step"]) for s in t.optimizer.state.values()} == {4.0}
    save_checkpoint(path, m, t)
    back_model = _ivae()
    back = SVItrainer(back_model)
    back.resume(path)
    assert not any(g["capturable"] for g in back.optimizer.param_groups)
    back.train(init_dataloader(x, batch_size=16, device="cpu"))


# ---------------------------------------------------------------------------
# the card's Adam against optax.adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("foreach", [True, False])
def test_capturable_adam_matches_optax(foreach):
    """Six updates of three leaves (one of them given zero grads, as
    ``fill_zero_grads`` does) at lr 1e-3 and 5e-4 through
    ``torch.optim.Adam(capturable=True)`` (its foreach kernels, the card's
    default, and its per-tensor loop): parameters, moments and the count
    against ``optax.adam``'s; the count a float32 tensor on the
    parameters' device."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    for lr in (1e-3, 5e-4):
        init = [rng.normal(size=s).astype(np.float32) for s in shapes]
        grads = [[rng.normal(size=s).astype(np.float32) * (i != 1)
                  for i, s in enumerate(shapes)] for _ in range(6)]
        params = [torch.nn.Parameter(torch.from_numpy(a.copy()))
                  for a in init]
        opt = torch.optim.Adam(params, lr=lr, capturable=True,
                               foreach=foreach)
        assert _graph.graph_optimizer(opt)
        tx = optax.adam(lr)
        jp = [jnp.asarray(a) for a in init]
        state = tx.init(jp)
        for g in grads:
            for p, gi in zip(params, g):
                p.grad = torch.from_numpy(gi)
            opt.step()
            upd, state = tx.update([jnp.asarray(gi) for gi in g], state, jp)
            jp = optax.apply_updates(jp, upd)
        for p, q in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       atol=OUT_ATOL, rtol=0)
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       atol=1e-6, rtol=1e-6)
        # torch's first moment is a lerp, optax's b1 mu + (1 - b1) g: the
        # two round apart by a few float32 ulps over six updates
        mu, nu = state[0].mu, state[0].nu
        for p, m, n in zip(params, mu, nu):
            st = opt.state[p]
            np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(m),
                                       rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                       np.asarray(n), rtol=1e-6, atol=1e-12)
            assert st["step"].dtype == torch.float32
            assert st["step"].device == p.device
            assert float(st["step"]) == int(state[0].count) == 6


def test_capturable_adam_loads_host_count_state():
    """A state dict of ``torch.optim.Adam`` without ``capturable`` (its
    count on the host), as a CPU trainer's checkpoint holds it, loads into
    the capturable Adam with the count as a float32 tensor on the
    parameters' device, and both then take the same update within float32
    rounding."""
    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(5))
    q = torch.nn.Parameter(p.detach().clone())
    ref = torch.optim.Adam([p], lr=1e-3)
    for _ in range(3):
        p.grad = torch.randn(5)
        ref.step()
    q.data.copy_(p.data)
    opt = torch.optim.Adam([q], lr=1e-3, capturable=True, foreach=True)
    opt.load_state_dict(copy.deepcopy(ref.state_dict()))  # state of its own
    step = opt.state[q]["step"]
    assert step.dtype == torch.float32 and step.device == q.device
    g = torch.randn(5)
    p.grad, q.grad = g, g.clone()
    ref.step()
    opt.step()
    np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                               atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _loader(**kw):
    return init_dataloader(_images(32, 0), batch_size=16, device="cpu", **kw)


def _svi(**kw):
    m = _ivae(**{k: kw.pop(k) for k in ("pixel_chunks", "fused") if k in kw})
    opt = kw.pop("optimizer", "capturable")
    if opt == "capturable":
        kw["optimizer"] = _capturable_adam(m)
    elif opt is not None:
        kw["optimizer"] = opt(m)
    return SVItrainer(m, **kw)


def _aux(**kw):
    m = tmodels.ssiVAE(DATA, 2, 3, invariances=["r"], device="cpu",
                       **SMALL, **kw)
    return auxSVItrainer(m, optimizer=_capturable_adam(m, 5e-4))


def _meshed(**kw):
    t = _svi(**kw)
    t.mesh = "a DeviceMesh"  # the trainer's configuration, as route reads it
    return t


def _sharded():
    t = _svi()
    t.model._pixel_mesh = "a DeviceMesh"  # as parallel.shard_pixels sets it
    return t


# (trainer, loaders, captured on a CUDA device)
ROUTES = {
    "resident": (_svi, lambda: (_loader(),), True),
    "resident_with_held_out": (_svi, lambda: (_loader(), _loader()), True),
    "streaming": (_svi, lambda: (_loader(device_resident=False),), False),
    "streaming_chunks": (_svi, lambda: (
        _loader(device_resident=False, stream_chunks=2),), True),
    "streaming_held_out": (_svi, lambda: (
        _loader(), _loader(device_resident=False)), False),
    "iterable_of_batches": (_svi, lambda: ([np.zeros((16,) + DATA,
                                                     np.float32)],), False),
    "mesh": (_meshed, lambda: (_loader(),), False),
    "grad_accum": (lambda: _svi(grad_accum=2), lambda: (_loader(),), True),
    "grad_accum_streaming_chunks": (lambda: _svi(grad_accum=2), lambda: (
        _loader(device_resident=False, stream_chunks=2),), True),
    "grad_accum_mesh": (lambda: _meshed(grad_accum=2), lambda: (_loader(),),
                        False),
    "remat": (lambda: _svi(remat=True), lambda: (_loader(),), True),
    "pixel_chunks": (lambda: _svi(pixel_chunks=3), lambda: (_loader(),),
                     True),
    "pixel_chunks_module": (lambda: _svi(pixel_chunks=3, fused=False),
                            lambda: (_loader(),), True),
    "pixel_chunks_remat_accum_chunks": (
        lambda: _svi(pixel_chunks=3, remat=True, grad_accum=2), lambda: (
            _loader(device_resident=False, stream_chunks=2),), True),
    "shard_pixels": (_sharded, lambda: (_loader(),), False),
    "torch_adam": (lambda: _svi(optimizer=lambda m: torch.optim.Adam(
        m.nets.parameters())), lambda: (_loader(),), False),
    "torch_adam_capturable": (lambda: _svi(optimizer=lambda m: torch.optim
                                           .Adam(m.nets.parameters(),
                                                 capturable=True)),
                              lambda: (_loader(),), True),
    "sgd": (lambda: _svi(optimizer=lambda m: torch.optim.SGD(
        m.nets.parameters(), lr=0.1)), lambda: (_loader(),), False),
    "aux_resident": (_aux, lambda: (_loader(), _loader()), True),
    "aux_streaming_labeled": (_aux, lambda: (
        _loader(), _loader(device_resident=False)), False),
    "aux_chunked_unlabeled": (_aux, lambda: (
        _loader(device_resident=False, stream_chunks=2), _loader()), True),
    "aux_chunked_labeled": (_aux, lambda: (
        _loader(), _loader(device_resident=False, stream_chunks=2)), False),
    "aux_pixel_chunks": (lambda: _aux(pixel_chunks=3), lambda: (
        _loader(), _loader()), True),
    "aux_pixel_chunks_module": (lambda: _aux(pixel_chunks=3, fused=False),
                                lambda: (_loader(), _loader()), True),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_routing_by_configuration(name, monkeypatch):
    """Each configuration maps to its path on a CUDA device; every one is
    eager on the CPU, and every one with ``CAPTURE`` cleared."""
    make, loaders, captured = ROUTES[name]
    trainer, lds = make(), loaders()
    assert _graph.route(trainer, lds, "cuda") is captured
    assert _graph.route(trainer, lds, "cpu") is False
    assert _graph.route(trainer, lds) is False  # the trainer's: the CPU
    monkeypatch.setattr(_graph, "CAPTURE", False)
    assert _graph.route(trainer, lds, "cuda") is False


def test_default_optimizers_by_device():
    """torch's Adam for both trainers and both optimizers, with the
    trainers' learning rates: ``capturable`` on CUDA (the captured path
    takes it), not on the CPU."""
    params = [torch.nn.Parameter(torch.zeros(2))]
    on_card = _graph.default_optimizer(params, 1e-3, "cuda")
    assert type(on_card) is torch.optim.Adam
    assert _graph.graph_optimizer(on_card)
    on_cpu = _graph.default_optimizer(params, 1e-3, "cpu")
    assert type(on_cpu) is torch.optim.Adam
    assert not _graph.graph_optimizer(on_cpu)
    t = SVItrainer(_ivae())
    assert type(t.optimizer) is torch.optim.Adam
    assert t.optimizer.defaults["lr"] == 1e-3
    assert not t.optimizer.defaults["capturable"]
    a = auxSVItrainer(tmodels.ssiVAE(DATA, 2, 3, invariances=["r"],
                                     device="cpu", **SMALL))
    for opt in (a.optimizer, a.aux_optimizer):
        assert type(opt) is torch.optim.Adam
        assert opt.defaults["lr"] == 5e-4


# ---------------------------------------------------------------------------
# static tables, the pass order, invalidation
# ---------------------------------------------------------------------------

def test_static_tables_fill_in_place():
    """A table keeps its address across fills from arrays, scalars and
    tensors, cast to its dtype."""
    t = StaticTables(torch.device("cpu"), idx=((2, 3), torch.int32),
                     beta=((), torch.float32), pair=((2,), torch.float32))
    ptrs = [t.idx.data_ptr(), t.beta.data_ptr(), t.pair.data_ptr()]
    t.fill(idx=np.arange(6, dtype=np.int64).reshape(2, 3), beta=0.3,
           pair=(0.5, 2.0))
    assert t.idx.dtype == torch.int32 and t.idx.tolist() == [[0, 1, 2],
                                                             [3, 4, 5]]
    assert t.beta.item() == np.float32(0.3)
    t.fill(pair=torch.tensor([1.0, 3.0]), beta=torch.tensor(4.0))
    assert t.pair.tolist() == [1.0, 3.0] and t.beta.item() == 4.0
    assert [t.idx.data_ptr(), t.beta.data_ptr(), t.pair.data_ptr()] == ptrs


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_order_is_the_iteration_order(shuffle):
    """``epoch_order`` gives the rows of the next pass in the order
    iterating visits them and advances the epoch as iterating does."""
    x = np.arange(40, dtype=np.float32).reshape(40, 1)
    a = DataLoader(x, batch_size=16, seed=3, shuffle=shuffle, device="cpu")
    b = DataLoader(x, batch_size=16, seed=3, shuffle=shuffle, device="cpu")
    for _ in range(2):
        order = a.epoch_order()
        rows = torch.cat([batch[0][:, 0] for batch in b]).long().tolist()
        assert order.tolist() == rows
    assert a._epoch == b._epoch


class _SpatialDecoder(torch.nn.Module):
    """A user's decoder of a spatial model: ``(coords, zc) -> [B, N]``."""

    def __init__(self):
        super().__init__()
        self.coords = torch.nn.Linear(2, 16)
        self.zc = torch.nn.Linear(2, 16, bias=False)
        self.out = torch.nn.Linear(16, 1)

    def forward(self, coords, zc):
        h = torch.tanh(self.coords(coords) + self.zc(zc)[..., None, :])
        return torch.sigmoid(self.out(h))[..., 0]


def test_programs_are_dropped_with_the_weights(bodies, tmp_path):
    """``load_weights``, ``set_encoder`` and ``set_decoder`` move the
    model's generation: the trainer's next epoch drops every program (the
    evaluation's too) and makes a new one."""
    m = _ivae()
    t = SVItrainer(m, optimizer=_capturable_adam(m))
    ld = _loader()
    m.save_weights(str(tmp_path / "w"))
    replace = [
        lambda: m.load_weights(str(tmp_path / "w")),
        lambda: m.set_encoder(tmodels.iVAE(DATA, invariances=["r"],
                                           device="cpu", **SMALL).encoder_net),
        lambda: m.set_decoder(_SpatialDecoder())]
    for swap in replace:
        t.train(ld)
        t.evaluate(ld)
        before = dict(t._graphs.programs)
        assert set(before) == {("svi", True), ("svi", False)}
        t.train(ld)
        assert t._graphs.programs[("svi", True)] is before[("svi", True)]
        swap()
        t.train(ld)
        assert set(t._graphs.programs) == {("svi", True)}
        assert t._graphs.programs[("svi", True)] is not before[("svi", True)]


def _programs_after(t, epochs):
    """The training program after each of ``epochs`` (callables run before
    the epoch, each returning its loader)."""
    out = []
    for before in epochs:
        t.train(before())
        out.append(t._graphs.programs[("svi", True)])
    return out


def test_hyperparameter_change_takes_a_new_program(bodies):
    """A learning rate (or any other hyperparameter that is not a tensor)
    written into a group between epochs is part of the key: the next epoch
    makes a new program, and one with the same rate keeps it; a tensor
    ``lr`` is read in place, and replacing it takes a new program too."""
    m = _ivae()
    t = SVItrainer(m, optimizer=_capturable_adam(m))
    ld = _loader()

    def set_lr(v):
        def go():
            for g in t.optimizer.param_groups:
                g["lr"] = v
            return ld
        return go

    a, b, c, d, e = _programs_after(t, [
        lambda: ld, lambda: ld, set_lr(5e-4), set_lr(5e-4),
        set_lr(torch.tensor(5e-4))])
    assert a is b and c is d and b is not c and d is not e
    key = _graph.settings(t)
    t.optimizer.param_groups[0]["betas"] = (0.8, 0.999)
    assert _graph.settings(t) != key
    t.optimizer.param_groups[0]["betas"] = (0.9, 0.999)
    assert _graph.settings(t) == key
    t.optimizer.param_groups[0]["lr"] = torch.tensor(1e-3)
    assert _graph.settings(t) == key  # a tensor: by address
    (f,) = _programs_after(t, [lambda: ld])
    assert f is not e


def test_loader_key_is_its_arrays_not_its_identity(bodies):
    """A fresh loader over the same arrays (on the CPU a resident loader
    reads the caller's float32 array in place) keeps the program; one over
    a copy of them, or with another batch size, replaces it, and the
    trainer holds one training program all along."""
    m = _ivae()
    t = SVItrainer(m, optimizer=_capturable_adam(m))
    x = _images(32, 0)
    same = lambda: init_dataloader(x, batch_size=16, device="cpu")
    copied = lambda: init_dataloader(x.copy(), batch_size=16, device="cpu")
    other = lambda: init_dataloader(x, batch_size=8, device="cpu")
    a, b, c, d = _programs_after(t, [same, same, copied, other])
    assert a is b and b is not c and c is not d
    assert _graph.loader_key(same()) == _graph.loader_key(same())
    assert _graph.loader_key(same()) != _graph.loader_key(copied())
    assert len(t._graphs.programs) == 1
