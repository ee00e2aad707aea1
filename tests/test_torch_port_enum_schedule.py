"""The port's ``enum_schedule`` (exact enumeration for the first epochs,
then the model's ``enum_topk``; or ``"auto"``, switching once the guide's
top-k mass passes a threshold) against the JAX package's, for jiVAE
through ``SVItrainer`` and ssiVAE through ``auxSVItrainer``, on the CPU
with the JAX trainers' noise injected into the port's."""
import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer
from pyroved_tpu_torch.utils.data import DataLoader, init_dataloader

from test_torch_port_segmented import JaxNoiseAux, JaxNoiseSVI

# Per-epoch losses, f32 on both sides, the same weights, noise and batches
LOSS_RTOL = 1e-5
# Accuracies: the JAX trainer's run divides the hit count in float32, its
# step in float64 (as the port does)
ACC_RTOL = 1e-6
# The guide's mean top-k mass on the probe rows: a mean of 48 sums of
# float32 softmax outputs after a few epochs of training
MASS_ATOL = 1e-5
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


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _x(n=60, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + DATA).astype(
        np.float32)


def _jivae_pair(topk=2, seed=0):
    jm = jmodels.jiVAE(DATA, 2, 4, ["r"], enum_topk=topk, seed=seed, **SMALL)
    tm = tmodels.jiVAE(DATA, 2, 4, ["r"], enum_topk=topk, device="cpu",
                       **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _params(model):
    return [p.detach().clone() for p in model.nets.parameters()]


def test_fixed_schedule_is_bitwise_a_manual_two_phase_run():
    """``run(4, enum_schedule=2)`` in the port equals, bit for bit, 2
    epochs with ``enum_topk=0`` then 2 with ``enum_topk=2`` on one loader,
    its KL schedule sliced across the phases; ``enum_topk`` is restored."""
    X = _x()
    sched = [0.25, 0.5, 0.75, 1.0]
    _, m1 = _jivae_pair()
    _, m2 = _jivae_pair()
    t1, t2 = SVItrainer(m1, seed=3), SVItrainer(m2, seed=3)
    a = t1.run(init_dataloader(X, batch_size=20, seed=1, device="cpu"), 4,
               enum_schedule=2, scale_schedule=sched)
    l2 = init_dataloader(X, batch_size=20, seed=1, device="cpu")
    m2.enum_topk = 0
    b = t2.run(l2, 2, scale_schedule=sched[:2])
    m2.enum_topk = 2
    b += t2.run(l2, 2, scale_schedule=sched[2:])
    assert a == b and m1.enum_topk == 2 and t1.current_epoch == 4
    assert all(torch.equal(p, q) for p, q in zip(_params(m1), _params(m2)))


@pytest.mark.parametrize("exact", [2, 10], ids=["E=2", "E>=epochs"])
def test_fixed_schedule_losses_match_jax(exact):
    """Per-epoch losses of ``run(4, enum_schedule=E)`` against the JAX
    trainer's (E >= epochs: the whole run exact)."""
    X = _x(seed=1)
    jm, tm = _jivae_pair(seed=2)
    jt = JSVItrainer(jm, seed=5)
    ref = jt.run(jinit_dataloader(X, batch_size=20, seed=2), 4,
                 enum_schedule=exact)
    tt = JaxNoiseSVI(tm, 5)
    got = tt.run(init_dataloader(X, batch_size=20, seed=2, device="cpu"), 4,
                 enum_schedule=exact)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert tm.enum_topk == jm.enum_topk == 2


# (threshold, JAX's switch epoch): top-2 of 4 classes always carries half
# the mass, so 0.5 switches at the first probe; on this data the probes
# read 0.5419 (epoch 5) and 0.5317 (epoch 10), so 0.54 switches at the
# first probe, 0.545 and 1.0 never
AUTO = [(0.5, 5), (0.54, 5), (0.545, None), (1.0, None)]


@pytest.mark.parametrize("thr,switch", AUTO, ids=[str(a) for a, _ in AUTO])
def test_auto_switch_epoch_and_probe_masses_match_jax(thr, switch):
    """``("auto", thr)`` over 14 epochs: the probes' epochs and masses, the
    switch epoch and the per-epoch losses equal the JAX trainer's."""
    X = _x(48, seed=3)
    jm, tm = _jivae_pair(seed=4)
    jt = JSVItrainer(jm, seed=6)
    ref = jt.run(jinit_dataloader(X, batch_size=16, seed=4), 14,
                 enum_schedule=("auto", thr))
    tt = JaxNoiseSVI(tm, 6)
    got = tt.run(init_dataloader(X, batch_size=16, seed=4, device="cpu"), 14,
                 enum_schedule=("auto", thr))
    assert jt.enum_switch_epoch == switch
    assert tt.enum_switch_epoch == switch
    (je, jmass), (te, tmass) = (list(zip(*h)) for h in (
        jt.enum_probe_history, tt.enum_probe_history))
    assert te == je
    np.testing.assert_allclose(tmass, jmass, atol=MASS_ATOL)
    assert all(abs(m - thr) > 1e-3 for m in jmass)  # no decision on a tie
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    assert tm.enum_topk == 2


def test_auto_rejects_bad_thresholds_and_streaming_loaders():
    X = _x(40, seed=5)
    _, tm = _jivae_pair()
    t = SVItrainer(tm)
    loader = init_dataloader(X, batch_size=20, device="cpu")
    for thr in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError, match="threshold"):
            t.run(loader, 2, enum_schedule=("auto", thr))
    streaming = DataLoader(X, batch_size=20, device_resident=False,
                           device="cpu")
    with pytest.raises(ValueError, match="device-resident"):
        t.run(streaming, 2, enum_schedule="auto")
    assert streaming.device_arrays is None and tm.enum_topk == 2
    assert t.current_epoch == 0
    # a model without enum_topk has nothing to schedule: a plain run
    iv = tmodels.iVAE(DATA, invariances=["r"], device="cpu", **SMALL)
    assert len(SVItrainer(iv).run(loader, 2, enum_schedule="auto")) == 2


def test_auto_patience_spans_the_probes_as_jax():
    """``patience`` longer than the 5-epoch probe interval still fires: the
    early-stop baseline carries across the probe sub-runs (threshold 1.0:
    all probes), and the port stops where the JAX trainer does."""
    X, Xt = _x(seed=14), _x(20, seed=15)
    out = {}
    for pkg in ("jax", "port"):
        jm, tm = _jivae_pair(seed=0)
        if pkg == "jax":
            t = JSVItrainer(jm, seed=3)
            ld = lambda a: jinit_dataloader(a, batch_size=20,  # noqa: E731
                                            seed=1)
        else:
            t = JaxNoiseSVI(tm, 3)
            ld = lambda a: init_dataloader(a, batch_size=20,  # noqa: E731
                                           seed=1, device="cpu")
        t.run(ld(X), 20, test_loader=ld(Xt), patience=7, min_delta=1e9,
              enum_schedule=("auto", 1.0))
        out[pkg] = (t.stopped_early, t.current_epoch, t.best_epoch)
    assert out["port"] == out["jax"]
    assert out["port"][0] and out["port"][1] < 20


def test_schedule_after_an_early_stopped_run_trains():
    """A stale ``stopped_early`` from an early-stopped run skips no phase
    of a later scheduled run."""
    X, Xt = _x(seed=11), _x(20, seed=12)
    _, tm = _jivae_pair()
    t = SVItrainer(tm, seed=3)
    loader = init_dataloader(X, batch_size=20, seed=1, device="cpu")
    tl = init_dataloader(Xt, batch_size=20, seed=1, device="cpu")
    t.run(loader, 10, test_loader=tl, patience=1, min_delta=1e9)
    assert t.stopped_early
    n0 = t.current_epoch
    assert len(t.run(loader, 3, enum_schedule=0)) == 3
    assert t.current_epoch == n0 + 3 and not t.stopped_early
    assert len(t.run(loader, 3, enum_schedule=("auto", 1.0))) == 3
    assert t.current_epoch == n0 + 6


def _ss_pair(topk=2, seed=0):
    jm = jmodels.ssiVAE(DATA, 2, 3, ["r"], enum_topk=topk, seed=seed,
                        **SMALL)
    tm = tmodels.ssiVAE(DATA, 2, 3, ["r"], enum_topk=topk, device="cpu",
                        **SMALL)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


@pytest.mark.parametrize("schedule", [1, ("auto", 0.7)],
                         ids=["E=1", "auto"])
def test_ssivae_schedule_matches_jax(schedule):
    """ssiVAE through auxSVItrainer: the unlabeled steps enumerate all 3
    classes, then the top 2 (the noise shape follows); per-epoch losses,
    accuracies and the switch against the JAX trainer's."""
    rng = np.random.default_rng(6)
    xu, xl = _x(40, 7), _x(12, 8)
    y1h = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    jm, tm = _ss_pair(seed=1)
    jt = JauxSVItrainer(jm, seed=4)
    ref = jt.run(jinit_dataloader(xu, batch_size=8, seed=1),
                 jinit_dataloader(xl, y1h, batch_size=6, seed=2,
                                  random_sampler=True), 7,
                 loader_val=jinit_dataloader(xl, y1h, batch_size=6),
                 enum_schedule=schedule)
    tt = JaxNoiseAux(tm, 4)
    got = tt.run(init_dataloader(xu, batch_size=8, seed=1, device="cpu"),
                 init_dataloader(xl, y1h, batch_size=6, seed=2,
                                 random_sampler=True, device="cpu"), 7,
                 loader_val=init_dataloader(xl, y1h, batch_size=6,
                                            device="cpu"),
                 enum_schedule=schedule)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    # the JAX trainer's run reads the accuracy as a float32 share
    np.testing.assert_allclose(tt.history["test"], jt.history["test"],
                               rtol=ACC_RTOL)
    assert tt.enum_switch_epoch == jt.enum_switch_epoch
    assert tm.enum_topk == 2


def test_fit_forwards_the_schedule_and_verbose_refuses_it():
    X = _x(seed=9)
    _, tm = _jivae_pair()
    tr = tm.fit(X, epochs=3, batch_size=20, enum_schedule=1)
    assert len(tr.loss_history["training_loss"]) == 3 and tm.enum_topk == 2
    with pytest.raises(ValueError, match="enum_schedule"):
        tm.fit(X, epochs=1, batch_size=20, enum_schedule=1, verbose=True)
    _, sm = _ss_pair()
    xl = X[:12]
    tr = sm.fit(X, (xl, np.arange(12) % 3), epochs=2, batch_size=6,
                enum_schedule=("auto", 0.99))
    assert len(tr.history["training_loss"]) == 2 and sm.enum_topk == 2
    with pytest.raises(ValueError, match="enum_schedule"):
        sm.fit(X, (xl, np.arange(12) % 3), epochs=1, batch_size=6,
               enum_schedule=1, verbose=True)
