"""A trained ssiVAE's classification accuracy in the port against the JAX
package's: the same weights, noise and batches, trained until the
classifier head leaves chance, with ``patience`` (which watches that
accuracy) stopping both runs at the same epoch, on the CPU."""
import numpy as np
import pytest
import torch

import jax

import pyroved_tpu.models as jmodels
from pyroved_tpu.trainers.auxsvi import auxSVItrainer as JauxSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.utils.data import init_dataloader

from test_torch_port_segmented import JaxNoiseAux

DATA = (12, 12)
K = 3
CHANCE = 1.0 / K
# A trained head must beat chance by this much on the validation set
MARGIN = 0.3
# Port against JAX: the same trajectory up to float32 rounding, so a
# validation image near a decision boundary may fall either way
ACC_GAP = 0.05


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
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)


def _bars(n, seed):
    """Bars at 0, 60 or 120 degrees (the class), jittered by up to 15
    degrees, with pixel noise."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, n)
    th = np.deg2rad(60.0 * y + rng.uniform(-15, 15, n))[:, None, None]
    yy, xx = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 12),
                         indexing="ij")
    d = -xx[None] * np.sin(th) + yy[None] * np.cos(th)
    x = np.exp(-(d ** 2) / 0.05) + 0.05 * rng.uniform(0, 1, (n, 12, 12))
    return np.clip(x, 0, 1).astype(np.float32), np.eye(K, dtype=np.float32)[y]


def test_trained_accuracy_and_its_early_stop_match_jax():
    """Up to 30 epochs of 64 unlabeled and 24 labeled bars (batch 8, a
    labeled step after every third unlabeled one) with ``patience=4`` on
    the accuracy of 60 held-out bars: both heads end well above chance
    and within ``ACC_GAP`` of each other, epoch by epoch, and both runs
    stop at the same epoch with the same best epoch."""
    xu, _ = _bars(64, 0)
    xl, yl = _bars(24, 1)
    xv, yv = _bars(60, 2)
    jm = jmodels.ssiVAE(DATA, 2, K, ["r"], seed=3)
    tm = tmodels.ssiVAE(DATA, 2, K, ["r"], device="cpu")
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    jt = JauxSVItrainer(jm, seed=5)
    jt.run(jinit_dataloader(xu, batch_size=8, seed=1),
           jinit_dataloader(xl, yl, batch_size=8, seed=2,
                            random_sampler=True), 30,
           loader_val=jinit_dataloader(xv, yv, batch_size=20),
           patience=4)
    tt = JaxNoiseAux(tm, 5)
    tt.run(init_dataloader(xu, batch_size=8, seed=1, device="cpu"),
           init_dataloader(xl, yl, batch_size=8, seed=2, random_sampler=True,
                           device="cpu"), 30,
           loader_val=init_dataloader(xv, yv, batch_size=20, device="cpu"),
           patience=4)
    ja, ta = jt.history["test"], tt.history["test"]
    assert len(ta) == len(ja)
    assert np.max(np.abs(np.subtract(ta, ja))) <= ACC_GAP, (ta, ja)
    for acc in (ja, ta):
        assert acc[0] < CHANCE + MARGIN  # the head starts near chance
        assert max(acc) >= CHANCE + MARGIN and acc[-1] >= CHANCE + MARGIN
    assert (tt.stopped_early, tt.current_epoch, tt.best_epoch) == (
        jt.stopped_early, jt.current_epoch, jt.best_epoch)
