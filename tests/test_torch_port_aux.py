"""Port parity for the semi-supervised trainer, ``auxSVItrainer``: an epoch
with labeled steps against the JAX trainer's on the same permutations,
noise and interleave, the interleave schedule itself, ``run`` against
sequential ``train`` calls, SWA and the evaluation metrics; and the golden
convergence bands of ``tests/test_golden_bands.py`` reached by the port
with its own noise, for jiVAE, ssiVAE and ss_reg_iVAE, on the CPU."""
import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer, auxSVItrainer
from pyroved_tpu_torch.utils.data import (init_dataloader,
                                          init_ssvae_dataloaders)
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

# Parameters after four Adam steps at lr 5e-4, f32 on both sides with sums
# in other orders; the acceptance bound of the port's trainers.
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
# The reported epoch loss: the JAX trainer's compiled scan against eager
# steps, sums of hundreds of pixel terms.
LOSS_RTOL = 1e-4

DATA = (12, 12)
K = 3


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX package's CPU module
    path computes them, for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


FAMILIES = {
    "ssivae": ("ssiVAE", dict(latent_dim=2, num_classes=K)),
    "ss_reg": ("ss_reg_iVAE", dict(latent_dim=2, reg_dim=1)),
}


def _labels(family, n, rng):
    if family == "ssivae":
        return np.eye(K, dtype=np.float32)[rng.integers(0, K, n)]
    return rng.uniform(-1, 1, (n, 1)).astype(np.float32)


def _jax_noise(family, jm, key, batch, labeled):
    """The noise the JAX model draws from ``key`` for one batch."""
    if family == "ssivae":
        shape = (batch, jm.z_dim) if labeled else (K, batch, jm.z_dim)
        return torch.from_numpy(np.array(jax.random.normal(key, shape)))
    key_y, key_z = jax.random.split(key)
    eps_z = torch.from_numpy(np.array(jax.random.normal(key_z,
                                                        (batch, jm.z_dim))))
    if labeled:
        return None, eps_z
    return (torch.from_numpy(np.array(jax.random.normal(key_y, (batch, 1)))),
            eps_z)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_epoch_with_labeled_steps_matches_jax_trainer(family):
    """Four unlabeled steps (the last batch padded) and, at p = (4 + 4) // 4
    = 2, labeled steps after steps 1 and 3, with the JAX trainer's noise
    (fold_in of its epoch key at 2i and 2i + 1) and permutations. Each
    labeled step moves ``encoder_y`` twice: by the basic Adam's momentum
    (its grad is zero there) and by the auxiliary Adam."""
    name, kw = FAMILIES[family]
    rng = np.random.default_rng(0)
    xu = rng.uniform(0, 1, (14,) + DATA).astype(np.float32)
    xl = rng.uniform(0, 1, (16,) + DATA).astype(np.float32)
    yl = _labels(family, 16, rng)
    jm = getattr(jmodels, name)(DATA, invariances=["r"], seed=4, **kw)
    tm = getattr(tmodels, name)(DATA, invariances=["r"], device="cpu", **kw)
    assert tm._fused  # K1/K2's plain versions on the CPU
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))

    jtrainer = JauxSVItrainer(jm, seed=9)
    ref_loss = jtrainer.train(jinit_dataloader(xu, batch_size=4, seed=3),
                              jinit_dataloader(xl, yl, batch_size=4, seed=5),
                              scale_factor=0.8, aux_loss_multiplier=15.0)

    _, epoch_key = jax.random.split(jax.random.PRNGKey(9))
    draws = []

    def jax_noise(batch, labeled):
        step = draws.count(False) - (1 if labeled else 0)
        draws.append(labeled)
        key = jax.random.fold_in(epoch_key, 2 * step + int(labeled))
        return _jax_noise(family, jm, key, batch, labeled)

    trainer = auxSVItrainer(tm)
    trainer.draw_noise = jax_noise
    loss = trainer.train(init_dataloader(xu, batch_size=4, seed=3,
                                         device="cpu"),
                         init_dataloader(xl, yl, batch_size=4, seed=5,
                                         device="cpu"),
                         scale_factor=0.8, aux_loss_multiplier=15.0)
    assert draws == [False, False, True, False, False, True]
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    ours = dict(tm.nets.named_parameters())
    assert sorted(ours) == sorted(ref)
    for n, r in ref.items():
        np.testing.assert_allclose(as_numpy(ours[n]), r.numpy(),
                                   atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=n)


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n_unsup,n_sup,sup_period", [
    (10, 2, None), (6, 2, None), (7, 3, None), (4, 4, None), (3, 5, None),
    (5, 1, None), (8, 2, 3), (8, 2, 1), (9, 4, None), (12, 5, 2)])
def test_schedule_matches_jax(n_unsup, n_sup, sup_period):
    """The interleave mask and the labeled batch of each step, including
    p == 1 (more labeled batches than unlabeled, or ``sup_period=1``),
    where every step is labeled."""
    args = (_Sized(n_unsup), _Sized(n_sup), n_unsup, n_sup, sup_period)
    mask, sup_j = auxSVItrainer._schedule(*args)
    ref_mask, ref_j = JauxSVItrainer._schedule(*args)
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(sup_j, ref_j)
    if n_sup > n_unsup or sup_period == 1:
        assert mask.all()


def _ss_setup(seed=2):
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (24,) + DATA).astype(np.float32)
    xl = rng.uniform(0, 1, (8,) + DATA).astype(np.float32)
    yl = rng.integers(0, K, 8)
    m = tmodels.ssiVAE(DATA, 2, K, invariances=["r"], device="cpu", seed=1)
    return m, xu, xl, yl


def test_run_is_bitwise_equal_to_sequential_train_calls():
    """``run`` (via ``fit``, with a validation loader) against ``step``s:
    the same parameters bit for bit, losses and accuracies."""
    m1, xu, xl, yl = _ss_setup()
    m2, *_ = _ss_setup()
    t1 = m1.fit(xu, (xl, yl), epochs=3, batch_size=8, scale_factor=0.5,
                aux_loss_multiplier=10.0)
    loaders = init_ssvae_dataloaders(
        xu, (xl, m2._labels(yl)), (xl, m2._labels(yl)), batch_size=8,
        device="cpu")
    t2 = auxSVItrainer(m2)
    for _ in range(3):
        t2.step(*loaders, scale_factor=0.5, aux_loss_multiplier=10.0)
    for (n, a), b in zip(m1.nets.named_parameters(), m2.nets.parameters()):
        assert torch.equal(a, b), n
    assert t1.history == t2.history
    assert len(t1.history["test"]) == 3
    assert all(0.0 <= a <= 1.0 for a in t1.history["test"])
    assert t1.current_epoch == 3


def test_swa_average_weights():
    """``average_weights`` loads the mean of the snapshots."""
    m, *_ = _ss_setup()
    t = auxSVItrainer(m)
    snaps = []
    for e in range(3):
        with torch.no_grad():
            for p in m.nets["encoder_y"].parameters():
                p.add_(0.1 * (e + 1))
        t.current_epoch = e
        t.save_running_weights()
        snaps.append({k: v.clone()
                      for k, v in m.nets["encoder_y"].state_dict().items()})
    with torch.no_grad():
        for p in m.nets["encoder_y"].parameters():
            p.zero_()
    t.average_weights()
    for k, v in m.nets["encoder_y"].state_dict().items():
        torch.testing.assert_close(v, sum(s[k] for s in snaps) / 3.0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_evaluate_matches_jax(family):
    """Accuracy (``evaluate_cls``) and per-batch mean squared error
    (``evaluate_reg``) over a shuffled loader with a partial last batch."""
    name, kw = FAMILIES[family]
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (21,) + DATA).astype(np.float32)
    y = _labels(family, 21, rng)
    jm = getattr(jmodels, name)(DATA, invariances=["r"], seed=5, **kw)
    tm = getattr(tmodels, name)(DATA, invariances=["r"], device="cpu", **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    ref = JauxSVItrainer(jm).evaluate(jinit_dataloader(x, y, batch_size=8,
                                                       seed=7))
    ours = auxSVItrainer(tm).evaluate(init_dataloader(x, y, batch_size=8,
                                                      seed=7, device="cpu"))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


# ---------------------------------------------------------------------------
# Golden bands (tests/test_golden_bands.py), reached with the port's noise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset():
    """The golden bands' data: rotated bars, their class and angle."""
    rng = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 12),
                         indexing="ij")
    th = rng.uniform(0, 2 * np.pi, 192)
    xr = (xx[None] * np.cos(th)[:, None, None]
          - yy[None] * np.sin(th)[:, None, None])
    X = np.exp(-(xr ** 2) / 0.05 - (yy[None] ** 2) / 0.3).astype(np.float32)
    y1h = np.eye(3, dtype=np.float32)[(th // (2 * np.pi / 3)).astype(int)]
    yreg = (th[:, None] / (2 * np.pi)).astype(np.float32)
    return X, y1h, yreg


def test_golden_jivae_band(dataset):
    X = dataset[0]
    m = tmodels.jiVAE(DATA, latent_dim=2, discrete_dim=3, invariances=["r"],
                      seed=1, device="cpu")
    t = SVItrainer(m, seed=1)
    losses = t.run(init_dataloader(X, batch_size=64, seed=1, device="cpu"), 5)
    assert 40.0 < losses[-1] < 75.0, losses
    assert losses[0] > losses[-1]


def test_golden_ssivae_band(dataset):
    X, y1h = dataset[0], dataset[1]
    loaders = init_ssvae_dataloaders(
        X, (X[:64], y1h[:64]), (X[:64], y1h[:64]), batch_size=32,
        device="cpu")
    m = tmodels.ssiVAE(DATA, latent_dim=2, num_classes=3, invariances=["r"],
                       seed=1, device="cpu")
    t = auxSVItrainer(m, seed=1)
    for _ in range(5):
        t.step(loaders[0], loaders[1])
    h = t.history["training_loss"]
    assert 40.0 < h[-1] < 70.0, h
    assert h[0] > h[-1]


def test_golden_ss_reg_ivae_band(dataset):
    X, yreg = dataset[0], dataset[2]
    m = tmodels.ss_reg_iVAE(DATA, latent_dim=2, reg_dim=1, invariances=["r"],
                            seed=1, device="cpu")
    t = auxSVItrainer(m, seed=1)
    lu = init_dataloader(X, batch_size=32, seed=1, device="cpu")
    ls = init_dataloader(X[:64], yreg[:64], batch_size=32, seed=1,
                         device="cpu")
    for _ in range(5):
        t.step(lu, ls)
    h = t.history["training_loss"]
    assert 40.0 < h[-1] < 70.0, h
    assert h[0] > h[-1]


def test_later_slice_trainer_features_raise_naming_roadmap():
    m, xu, xl, yl = _ss_setup()
    for kw in (dict(mesh=object()), dict(grad_accum=2),
               dict(log_file="log.jsonl")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            auxSVItrainer(m, **kw)
    loaders = init_ssvae_dataloaders(xu, (xl, m._labels(yl)),
                                     (xl, m._labels(yl)), batch_size=8,
                                     device="cpu")
    t = auxSVItrainer(m)
    for kw in (dict(patience=2), dict(on_segment=print),
               dict(enum_schedule=1)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t.run(loaders[0], loaders[1], 1, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.train(iter([]), loaders[1])
    with pytest.raises(NotImplementedError, match="ROADMAP.*Checkpoints"):
        t.resume("ckpt")
