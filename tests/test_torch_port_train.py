"""Port of the training slice: ``iVAE.weighted_loss_fn`` and its grads,
Adam, ``SVItrainer``, the device-resident ``DataLoader`` and ``fit``,
against the JAX package on the same weights, noise and batches, on the CPU
(where the port's decoder kernels run their plain versions)."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import pyroved_tpu.models as jmodels
from pyroved_tpu import native
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.infer import TraceELBO
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.trainers import SVItrainer
from pyroved_tpu_torch.utils.data import (DataLoader, init_dataloader,
                                          shuffle_indices)
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params

from torch_port_ranks import one_rank_mesh

# Losses: weighted sums of hundreds of f32 pixel terms, in another order.
LOSS_RTOL = 1e-5
# Grads: f32 on both sides, summed over the batch in another order; the
# JAX package's own gradient tolerance.
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX package's CPU module
    path computes them, for the whole module (before any module-scoped
    fixture computes)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield

CONFIGS = {
    "rot": dict(data_dim=(12, 12), invariances=["r"]),
    "rts": dict(data_dim=(12, 12), invariances=["r", "t", "s"]),
    "1d_t": dict(data_dim=(40,), invariances=["t"]),
    "rot_cond": dict(data_dim=(12, 12), invariances=["r"], c_dim=3),
}


def _pair(cfg, seed=3, **kw):
    """A JAX iVAE and the port's iVAE holding the same weights."""
    jm = jmodels.iVAE(seed=seed, **cfg, **kw)
    tm = tmodels.iVAE(device="cpu", **cfg, **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _data(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B,) + cfg["data_dim"]).astype(np.float32)
    c = cfg.get("c_dim", 0)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, B)] if c else None
    return x, y


def _batch(x, y):
    return (jnp.asarray(x),) if y is None else (jnp.asarray(x), jnp.asarray(y))


def _grads(tm):
    return {n: p.grad.clone() for n, p in tm.nets.named_parameters()}


def _check_tree(ours, ref_tree, atol, rtol):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_tree))
    assert sorted(ours) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(as_numpy(ours[name]), r.numpy(), atol=atol,
                                   rtol=rtol, err_msg=name)


def _check_adam_params(ours, ref_tree, ref_grads):
    """Parameters after Adam steps. Adam divides each grad by its own RMS,
    so a grad near zero turns a last-ulp difference into a step of up to
    lr: the tolerance is absolute, 1e-5 where the JAX grad is clear of
    zero (|g| > 1e-4) and 2 lr per step where it is not."""
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_tree))
    steps = len(ref_grads)
    for name, r in ref.items():
        o, r = as_numpy(ours[name]), r.numpy()
        small = np.zeros(r.shape, bool)
        for g in ref_grads:
            small |= np.abs(g[name].numpy()) <= 1e-4
        err = np.abs(o - r)
        assert (err[~small] <= 1e-5).all(), (name, err[~small].max())
        assert (err <= 2 * LR * steps).all(), (name, err.max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_step_matches_jax_value_grad_and_adam(name):
    cfg = CONFIGS[name]
    jm, tm = _pair(cfg)
    x, y = _data(cfg, 6)
    w = np.array([1, 1, 1, 1, 0.5, 0], np.float32)
    rng = jax.random.PRNGKey(5)
    eps = np.asarray(jax.random.normal(rng, (6, jm.z_dim)))
    beta = 0.7
    ref_loss, ref_grads = jax.value_and_grad(jm.weighted_loss_fn)(
        jm.params, rng, _batch(x, y), jnp.asarray(w), jnp.float32(beta))

    trainer = SVItrainer(tm)
    ty = None if y is None else torch.from_numpy(y)
    loss = trainer.train_step((torch.from_numpy(x),) + (() if y is None
                                                        else (ty,)),
                              torch.from_numpy(w), beta, torch.from_numpy(eps))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    _check_tree(_grads(tm), ref_grads, GRAD_ATOL, GRAD_RTOL)

    opt = optax.adam(LR)
    updates, _ = opt.update(ref_grads, opt.init(jm.params), jm.params)
    ref_params = optax.apply_updates(jm.params, updates)
    _check_adam_params(dict(tm.nets.named_parameters()), ref_params,
                       [from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                               ref_grads))])


def test_epoch_trajectory_matches_jax_trainer():
    """Four steps (the last batch padded) with the JAX trainer's own noise,
    fold_in(split(PRNGKey(seed))[1], step), and the same permutation."""
    cfg = CONFIGS["rot"]
    jm, tm = _pair(cfg, seed=4)
    x, _ = _data(cfg, 56, seed=2)
    jtrainer = JSVItrainer(jm, seed=9)
    jloader = jinit_dataloader(x, batch_size=16, seed=3)
    jparams0 = jax.tree_util.tree_map(np.array, jm.params)  # before donation
    ref_epoch = jtrainer.train(jloader)

    # the same chain by hand, for the per-step losses and grads
    _, epoch_key = jax.random.split(jax.random.PRNGKey(9))
    loader = init_dataloader(x, batch_size=16, seed=3, device="cpu")
    idx, w = loader.epoch_indices()
    np.testing.assert_array_equal(idx, jinit_dataloader(
        x, batch_size=16, seed=3).epoch_indices()[0])
    assert w[-1].tolist() == [1.0] * 8 + [0.0] * 8
    opt = optax.adam(LR)
    params, state = jparams0, opt.init(jparams0)
    trainer = SVItrainer(tm)
    ref_grads, total = [], 0.0
    for i in range(idx.shape[0]):
        step_rng = jax.random.fold_in(epoch_key, i)
        batch = (jnp.asarray(x[idx[i]]),)
        ref_loss, grads = jax.value_and_grad(jm.weighted_loss_fn)(
            params, step_rng, batch, jnp.asarray(w[i]), jnp.float32(1.0))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        ref_grads.append(from_jax_params(
            jax.tree_util.tree_map(np.asarray, grads)))
        eps = torch.from_numpy(np.asarray(jax.random.normal(step_rng, (16, 3))))
        rows = torch.as_tensor(idx[i])
        loss = trainer.train_step(loader.gather(rows),
                                  torch.from_numpy(w[i]), 1.0, eps)
        np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
        total += loss.item()
    # the hand-made chain is the JAX trainer's (its compiled scan rounds
    # differently from the eager steps, so the same Adam-aware check)
    _check_adam_params(from_jax_params(jax.tree_util.tree_map(
        np.asarray, params)), jm.params, ref_grads)
    np.testing.assert_allclose(total / 56, ref_epoch, rtol=1e-4)
    _check_adam_params(dict(tm.nets.named_parameters()), jm.params, ref_grads)


def _splitmix_reference(n, seed, epoch):
    """pvt_shuffle_indices, line by line."""
    mask = (1 << 64) - 1
    out = list(range(n))
    state = (seed * 0x9E3779B97F4A7C15 + epoch + 1) & mask
    for i in range(n - 1, 0, -1):
        state = (state + 0x9E3779B97F4A7C15) & mask
        z = state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        r = (z ^ (z >> 31)) % (i + 1)
        out[i], out[r] = out[r], out[i]
    return out


@pytest.mark.parametrize("n,seed,epoch", [(1, 0, 0), (257, 7, 3),
                                          (1000, 0, 1), (64, 2 ** 40, 9)])
def test_shuffle_is_the_jax_packages_permutation(n, seed, epoch):
    ours = shuffle_indices(n, seed, epoch)
    assert ours.dtype == np.int32
    assert ours.tolist() == _splitmix_reference(n, seed, epoch)
    if native.get_lib() is not None:  # the C++ library itself
        np.testing.assert_array_equal(ours, native.shuffle_indices(n, seed,
                                                                   epoch))


def test_partial_batch_padding_matches_dataset_size():
    """50 examples at batch 16: the fourth batch holds 2 rows and 14 pads of
    weight 0; the epoch loss is divided by 50, not by 64."""
    cfg = CONFIGS["rot"]
    x, _ = _data(cfg, 50, seed=1)
    loader = init_dataloader(x, batch_size=16, device="cpu")
    idx, w = loader.epoch_indices()
    assert idx.shape == (4, 16) and w.sum() == 50
    assert (idx[3, 2:] == 0).all() and (w[3, 2:] == 0).all()
    _, tm = _pair(cfg)
    eps = torch.randn(16, tm.z_dim, generator=torch.Generator().manual_seed(0))
    rows = torch.as_tensor(idx[3])
    batch = loader.gather(rows)[0]
    with torch.no_grad():
        padded = tm.weighted_loss_fn(batch, None, torch.from_numpy(w[3]),
                                     eps=eps)
        real = tm.loss_fn(batch[:2], eps=eps[:2]).sum()
    np.testing.assert_allclose(padded.item(), real.item(), rtol=1e-6)

    class Recording(SVItrainer):
        def train_step(self, batch, weights, beta=1.0, eps=None):
            return torch.tensor(float(weights.sum()))  # one per real row

    assert Recording(tm).train(loader) == 1.0


def test_loader_scale_and_device_rules():
    x8 = (np.arange(2 * 12 * 12) % 256).astype(np.uint8).reshape(2, 12, 12)
    loader = DataLoader(x8, batch_size=2, shuffle=False, scale=1 / 255.0,
                        device="cpu")
    assert loader.device_arrays[0].dtype == torch.uint8  # stays narrow
    batch = loader.gather(torch.arange(2))[0]
    assert batch.dtype == torch.float32
    np.testing.assert_allclose(batch.numpy(), x8.astype(np.float32) / 255.0,
                               rtol=1e-6)
    if not torch.cuda.is_available():  # without CUDA the default raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DataLoader(x8)
    # the streaming options are ported: each loader yields the same batch
    x16 = x8.astype(np.float16)  # exact: integers below 2048
    for arr, kw in ((x8, dict(device_resident=False, scale=1 / 255.0)),
                    (x8, dict(device_resident=False, stream_chunks=4,
                              scale=1 / 255.0)),
                    (x16, dict(store_dtype="float16", scale=1 / 255.0))):
        (got,) = next(iter(DataLoader(arr, batch_size=2, shuffle=False,
                                      device="cpu", **kw)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), batch.numpy())
    _, tm = _pair(CONFIGS["rot"])
    trainer = tm.fit(x8, epochs=1, batch_size=2, data_scale=1 / 255.0)
    assert trainer.generator.device == tm.device == torch.device("cpu")
    with pytest.raises(ValueError, match="data_scale"):
        tm.fit(x8, epochs=1)


def _golden_data():
    rng = np.random.default_rng(7)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 12), np.linspace(-1, 1, 12),
                         indexing="ij")
    th = rng.uniform(0, 2 * np.pi, 256)
    xr = (xx[None] * np.cos(th)[:, None, None]
          - yy[None] * np.sin(th)[:, None, None])
    return np.exp(-(xr ** 2) / 0.05 - (yy[None] ** 2) / 0.3).astype(np.float32)


def test_golden_rvae_loss_band_with_the_ports_rng():
    """The JAX package's golden config (12x12, 256 images, batch 64, 3
    epochs) with the port's own noise lands in the same 40-110 band, and
    its loss falls."""
    model = tmodels.iVAE((12, 12), latent_dim=2, invariances=["r"], seed=1,
                         device="cpu")
    trainer = SVItrainer(model, seed=1)
    loader = init_dataloader(_golden_data(), batch_size=64, seed=1,
                             device="cpu")
    for _ in range(3):
        trainer.step(loader)
    hist = trainer.loss_history["training_loss"]
    assert 40.0 < hist[-1] < 110.0, hist
    assert hist[0] > hist[-1]


def _trained(epochs, how, seed=2, **kw):
    cfg = CONFIGS["rot"]
    _, tm = _pair(cfg, seed=6)
    x, _ = _data(cfg, 40, seed=3)
    loader = init_dataloader(x, batch_size=16, seed=5, device="cpu")
    trainer = SVItrainer(tm, seed=seed)
    if how == "run":
        trainer.run(loader, epochs, **kw)
    else:
        for e in range(epochs):
            sf = kw["scale_schedule"][e] if "scale_schedule" in kw else 1.0
            trainer.step(loader, scale_factor=sf, sync=how != "async")
        trainer.sync_history()
    return trainer, {n: p.detach().clone() for n, p in tm.nets.named_parameters()}


def test_run_and_async_steps_equal_sequential_train_calls():
    t_seq, p_seq = _trained(3, "sync")
    for how, kw in (("run", {}), ("async", {})):
        t, p = _trained(3, how, **kw)
        assert t.loss_history == t_seq.loss_history, how
        assert t.current_epoch == 3 and len(t.epoch_times) == 3
        for n in p_seq:
            assert torch.equal(p[n], p_seq[n]), (how, n)
    sched = [0.5, 1.0, 2.0]
    t_run, p_run = _trained(3, "run", scale_schedule=sched)
    t_seq, p_seq = _trained(3, "sync", scale_schedule=sched)
    assert t_run.loss_history == t_seq.loss_history
    for n in p_seq:
        assert torch.equal(p_run[n], p_seq[n]), n


def test_evaluate_leaves_parameters_and_history_unchanged():
    cfg = CONFIGS["rot"]
    _, tm = _pair(cfg)
    x, _ = _data(cfg, 24)
    trainer = SVItrainer(tm)
    before = {n: p.detach().clone() for n, p in tm.nets.named_parameters()}
    loss = trainer.evaluate(init_dataloader(x, batch_size=10, device="cpu"))
    assert np.isfinite(loss) and trainer.loss_history["training_loss"] == []
    for n, p in tm.nets.named_parameters():
        assert torch.equal(p, before[n]), n
    pending = trainer.evaluate(init_dataloader(x, batch_size=10, device="cpu"),
                               sync=False)
    assert np.isfinite(float(pending))


def test_print_statistics_prints_the_jax_text(capsys):
    cfg = CONFIGS["rot"]
    _, tm = _pair(cfg)
    x, _ = _data(cfg, 16)
    loader = init_dataloader(x, batch_size=8, device="cpu")
    trainer = SVItrainer(tm)
    trainer.step(loader, sync=False)
    trainer.print_statistics()
    train = trainer.loss_history["training_loss"][-1]
    trainer.step(loader, loader)
    trainer.print_statistics()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Epoch: 1 Training loss: {:.4f}".format(train)
    hist = trainer.loss_history
    assert out[1] == "Epoch: 2 Training loss: {:.4f}, Test loss: {:.4f}".format(
        hist["training_loss"][-1], hist["test_loss"][-1])


def test_unported_options_raise_naming_the_roadmap_item(tmp_path):
    """The trainer surface is ported: every keyword runs (each keyword is
    held against the JAX package in tests/test_torch_port_segmented.py,
    _enum_schedule.py, _streaming.py and _accum.py); ``mesh`` takes a
    DeviceMesh (held against the JAX mesh in
    tests/test_torch_port_parallel.py): anything else is a TypeError
    naming it, and a one-rank mesh reaches the trainer."""
    _, tm = _pair(CONFIGS["rot"])
    x, _ = _data(CONFIGS["rot"], 8)
    loader = init_dataloader(x, batch_size=8, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        SVItrainer(tm, mesh=object())
    with one_rank_mesh() as mesh:
        t = SVItrainer(tm, mesh=mesh)
        assert t.mesh is mesh and t.data_axis.size == 1
        t.run(loader, 1)
        assert t.current_epoch == 1
    log = str(tmp_path / "log.jsonl")
    for kw in (dict(grad_accum=2), dict(remat=True), dict(log_file=log)):
        t = SVItrainer(tm, **kw)
        t.run(loader, 2)
        assert t.current_epoch == 2
    assert [json.loads(l)["epoch"] for l in open(log)] == [1, 2]
    # checkpoints are ported: the keywords are taken and a save happens
    ckpt = str(tmp_path / "ckpt.npz")
    saving = SVItrainer(tm, checkpoint_path=ckpt, checkpoint_every=1)
    saving.step(loader)
    assert SVItrainer(_pair(CONFIGS["rot"])[1]).resume(ckpt) == 1
    trainer = SVItrainer(tm, remat=False, grad_accum=1)  # the "off" values
    # no improvement counts (min_delta): the run stops one epoch after
    # its first, patience=1
    out = trainer.run(loader, 4, test_loader=loader, patience=1,
                      min_delta=1e9)
    assert trainer.stopped_early and len(out) == 2
    records = []
    trainer.run(loader, 2, on_segment=records.extend, enum_schedule=1)
    assert [r["epoch"] for r in records] == [3, 4]
    fitted = tm.fit(x, epochs=3, test_data=x, patience=1, min_delta=1e9,
                    on_segment=records.extend)
    assert fitted.stopped_early and fitted.current_epoch == 2
    with pytest.raises(ValueError, match="test_data"):
        tm.fit(x, epochs=1, patience=2)
    with pytest.raises(TypeError, match="bogus"):
        SVItrainer(tm, bogus=1)


def test_trace_elbo_and_fit_verbose(capsys):
    cfg = CONFIGS["rot"]
    _, tm = _pair(cfg)
    x, _ = _data(cfg, 16)
    SVItrainer(tm, loss=TraceELBO(num_particles=2, kl="analytic"))
    assert tm.num_particles == 2 and tm.kl_mode == "analytic"
    trainer = tm.fit(x, epochs=2, batch_size=8, verbose=True, test_data=x)
    assert len(trainer.loss_history["test_loss"]) == 2
    assert capsys.readouterr().out.count("Test loss") == 2


def test_one_pass_train_equals_generic_path(monkeypatch):
    """one_pass_train=True: the weighted loss and every parameter grad
    equal the generic path's on the same weights and noise."""
    cfg = CONFIGS["rts"]
    _, generic = _pair(cfg)
    one_pass = tmodels.iVAE(device="cpu", one_pass_train=True, **cfg)
    one_pass.nets.load_state_dict(generic.nets.state_dict())
    assert one_pass._one_pass() and not generic._one_pass()
    x, _ = _data(cfg, 6)
    w = torch.tensor([1, 1, 0.5, 1, 1, 0])
    eps = torch.randn(6, generic.z_dim, generator=torch.Generator().manual_seed(1))
    calls = []
    real = tsd.recon_loss_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tsd, "recon_loss_plain", spy)
    l1 = one_pass.weighted_loss_fn(x, None, w, 0.5, eps=eps)
    assert calls == [1]  # the one-pass kernel's wrapper ran
    l1.backward()
    l2 = generic.weighted_loss_fn(x, None, w, 0.5, eps=eps)
    l2.backward()
    np.testing.assert_allclose(l1.item(), l2.item(), rtol=LOSS_RTOL)
    g1, g2 = _grads(one_pass), _grads(generic)
    for n in g2:
        np.testing.assert_allclose(g1[n].numpy(), g2[n].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=n)


def test_fused_false_routes_every_decode_to_the_module_path(monkeypatch):
    calls = []
    for name in ("fused_spatial_decoder_forward",
                 "fused_spatial_decoder_backward",
                 "fused_bernoulli_recon_loss_kernel"):
        monkeypatch.setattr(tsd, name, lambda *a, **k: calls.append(a))
    cfg = CONFIGS["rot"]
    tm = tmodels.iVAE(device="cpu", fused=False, one_pass_train=True, **cfg)
    assert not tm._fused and not tm._one_pass()
    x, _ = _data(cfg, 8)
    tm.decode(np.zeros((3, 2), np.float32), angle=0.3)
    tm.reconstruct(x)
    tm.manifold2d(3, plot=False)
    with torch.no_grad():
        tm.loss_fn(x)
    tm.fit(x, epochs=1, batch_size=4)
    assert calls == []


def test_trace_matches_jax():
    cfg = CONFIGS["rts"]
    jm, tm = _pair(cfg)
    x, _ = _data(cfg, 4)
    rng = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(rng, (4, jm.z_dim)))
    ref = jm.trace(rng, (jnp.asarray(x),), beta=0.5)
    with torch.no_grad():
        ours = tm.trace(x, beta=0.5, eps=eps)
    pairs = [(ours["latent"][k], ref["latent"][k]) for k in ref["latent"]]
    pairs += [(ours["transform"][k], ref["transform"][k])
              for k in ("phi", "dx", "sc")]
    pairs += [(ours["coords"], ref["coords"]), (ours["obs"]["loc"],
                                                ref["obs"]["loc"])]
    for o, r in pairs:
        np.testing.assert_allclose(as_numpy(o), np.asarray(r), atol=1e-5)
    for k in ("recon_logp", "latent_term"):
        np.testing.assert_allclose(as_numpy(ours[k]), np.asarray(ref[k]),
                                   rtol=LOSS_RTOL)
