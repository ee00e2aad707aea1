"""Port parity for the discrete-latent and semi-supervised families:
``jiVAE`` (exact and ``enum_topk`` enumeration, fused and module paths),
``ssiVAE`` and ``ss_reg_iVAE`` (labeled and unlabeled losses, the auxiliary
losses and the heads) and their exports, against the JAX package on the
same weights (``load_jax_params``), inputs and noise, on the CPU.

Both sides compute in f32 unless a test says otherwise: the port's
``BF16_MATMUL`` is cleared and so is the JAX package's, whose fused path is
forced on and its Pallas kernels interpreted (the JAX gate wants a TPU).
On the CPU the port's kernel wrappers run their plain versions."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyroved_tpu.models as jmodels
import pyroved_tpu.ops.spatial_decoder as sd
import pyroved_tpu.serving as jserving
import pyroved_tpu_torch.models as tmodels
import pyroved_tpu_torch.serving as tserving
from pyroved_tpu_torch.trainers import auxSVItrainer
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.utils.nn import as_numpy
from pyroved_tpu_torch.weights import from_jax_params
from test_torch_port_bf16 import GRAD_ATOL as BF16_GRAD_ATOL
from test_torch_port_bf16 import GRAD_REL as BF16_GRAD_REL
from test_torch_port_bf16 import LOSS_RTOL as BF16_LOSS_RTOL
from test_torch_port_bf16 import MEAN_REL as BF16_MEAN_REL
from torch_port_ranks import one_rank_mesh

# The port's f32 tolerances: outputs f32 with sums in another order; losses
# sum hundreds of pixel terms (relative); grads sum over the batch and the
# branches in another order (the JAX package's own gradient tolerance).
ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3

DATA = (12, 12)
CFG = dict(invariances=["r"])  # hidden (128, 128), tanh, Bernoulli
K = 3
B = 4


@pytest.fixture(autouse=True, scope="module")
def f32_both():
    """Both packages in f32, the JAX package's Pallas kernels interpreted
    and taken at every size, for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        mp.setattr(sd, "BF16_MATMUL", False)
        mp.setattr(sd, "INTERPRET", True)
        mp.setattr(sd, "ACT_DTYPE", jnp.float32)
        mp.setattr(sd, "fused_profitable", lambda *a: True)
        mp.setattr(sd, "_forward", lambda *a: sd._fwd(*a))
        yield


def _pair(jcls, tcls, fused=True, seed=3, **kw):
    """A JAX model (its fused path forced on or off) and the port's,
    holding the same weights."""
    jm = getattr(jmodels, jcls)(DATA, seed=seed, **CFG, **kw)
    jm._fused = fused
    tm = getattr(tmodels, tcls)(DATA, device="cpu", fused=fused, **CFG, **kw)
    assert tm._fused == fused
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _x(n=B, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n,) + DATA).astype(
        np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _close(ours, ref, atol=ATOL):
    ours, ref = as_numpy(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, atol=atol)


def _grads(tm):
    """Every parameter's grad; zeros where the loss does not reach it (the
    classifier or regressor on a labeled batch), as JAX returns them."""
    return {n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in tm.nets.named_parameters()}


def _check_grads(ours, ref_tree, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_tree))
    assert sorted(ours) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(as_numpy(ours[name]), r.numpy(), atol=atol,
                                   rtol=rtol, err_msg=name)


def _loss_and_grads(jm, tm, batch, w, beta, key, eps):
    """The JAX per-example loss and the grads of its weighted sum; the
    port's, its grads left on the parameters."""
    def f(p):
        return jnp.sum(jm.loss_fn(p, key, batch, beta) * w)

    ref_per = jm.loss_fn(jm.params, key, batch, beta)
    ref_grads = jax.grad(f)(jm.params)
    tm.nets.zero_grad(set_to_none=True)
    y = _t(batch[1]) if len(batch) > 1 else None
    per = tm.loss_fn(_t(batch[0]), y, _t(np.asarray(beta)), eps=eps)
    torch.sum(per * _t(w)).backward()
    return per, ref_per, ref_grads


W = np.array([1.0, 1.0, 0.5, 0.0], np.float32)


# ---------------------------------------------------------------------------
# jiVAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "module"])
@pytest.mark.parametrize("topk", [0, 2], ids=["exact", "topk"])
def test_jivae_loss_and_grads_match_jax(fused, topk):
    """The enumerated loss through the kernels' path (K*B rows, leading
    [K, B]) or the module path (the coordinate head once, broadcast over
    the branches), exact or truncated to the top 2 classes. The inputs have
    no tied class probabilities (torch.topk's order among ties is not
    jax.lax.top_k's)."""
    jm, tm = _pair("jiVAE", "jiVAE", fused, latent_dim=2, discrete_dim=K,
                   enum_topk=topk)
    key = jax.random.PRNGKey(5)
    eps = _t(jax.random.normal(key, (B, jm.z_dim)))
    beta = jnp.asarray([0.7, 1.3], jnp.float32)
    per, ref, ref_grads = _loss_and_grads(jm, tm, (jnp.asarray(_x()),), W,
                                          beta, key, eps)
    np.testing.assert_allclose(as_numpy(per), np.asarray(ref),
                               rtol=LOSS_RTOL)
    _check_grads(_grads(tm), ref_grads)


def test_jivae_beta_forms_agree():
    """A KL scale given as numbers (floats on the host, so that a step does
    not wait for the device) or as a tensor gives the same loss."""
    tm = tmodels.jiVAE(DATA, 2, K, device="cpu", **CFG)
    assert tm.prep_beta(0.7) == (float(np.float32(0.7)),) * 2
    eps = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, tm.z_dim)).astype(np.float32))
    with torch.no_grad():
        ref = tm.loss_fn(_x(), beta=torch.tensor([0.7, 1.3]), eps=eps)
        for beta in ([0.7, 1.3], (0.7, 1.3), np.array([0.7, 1.3])):
            assert torch.equal(tm.loss_fn(_x(), beta=beta, eps=eps), ref)
        assert torch.equal(tm.loss_fn(_x(), beta=0.7, eps=eps),
                           tm.loss_fn(_x(), beta=torch.tensor(0.7), eps=eps))


def test_jivae_trace_encode_decode_match_jax():
    jm, tm = _pair("jiVAE", "jiVAE", latent_dim=2, discrete_dim=K)
    x = _x(5, seed=1)
    key = jax.random.PRNGKey(2)
    eps = _t(jax.random.normal(key, (5, jm.z_dim)))
    ref = jm.trace(key, (jnp.asarray(x),), beta=0.5)
    with torch.no_grad():
        ours = tm.trace(_t(x), beta=0.5, eps=eps)
    for site, field in (("latent_cont", "loc"), ("latent_cont", "scale"),
                        ("latent_cont", "value"), ("latent_disc", "probs"),
                        ("latent_disc", "enumerated"), ("transform", "phi"),
                        ("obs", "loc")):
        _close(ours[site][field], ref[site][field])
    _close(ours["coords"], ref["coords"])
    # the discrete term is a KL near 0 at these weights (alpha close to
    # uniform): terms of size ~0.4 cancel, so it is held absolutely too
    for name in ("recon_logp_k", "recon_logp", "latent_term", "disc_term"):
        np.testing.assert_allclose(as_numpy(ours[name]), np.asarray(ref[name]),
                                   rtol=LOSS_RTOL, atol=1e-6, err_msg=name)
    for logits in (False, True):
        for o, r in zip(tm.encode(x, logits=logits),
                        jm.encode(x, logits=logits)):
            _close(o, r)
    _close(tm.guide_probs(x), jm.guide_probs(x))
    z = np.random.default_rng(2).normal(size=(6, 2)).astype(np.float32)
    y = np.eye(K, dtype=np.float32)[[0, 1, 2, 2, 1, 0]]
    pose = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
    _close(tm.decode(z, y, **pose), jm.decode(z, y, **pose))
    _close(tm.manifold2d(3, disc_idx=1, plot=False), jm.manifold2d(3, disc_idx=1,
                                                      plot=False))
    _close(tm.manifold_traversal(3, 1, plot=False),
           jm.manifold_traversal(3, 1, plot=False))


# ---------------------------------------------------------------------------
# ssiVAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["labeled", "enumerated", "topk"])
def test_ssivae_loss_and_grads_match_jax(kind):
    """A labeled batch (y observed, B rows), an unlabeled one with every
    class enumerated (K branches, each with its own z: noise [K, B, z_dim],
    K*B rows through the kernels) and one truncated to the top 2."""
    jm, tm = _pair("ssiVAE", "ssiVAE", latent_dim=2, num_classes=K,
                   enum_topk=2 if kind == "topk" else 0)
    key = jax.random.PRNGKey(6)
    batch = (jnp.asarray(_x(seed=2)),)
    if kind == "labeled":
        batch += (jnp.asarray(np.eye(K, dtype=np.float32)[[0, 2, 1, 2]]),)
    (shape,) = tm.noise_shapes(B, labeled=kind == "labeled")
    eps = _t(jax.random.normal(key, shape))
    per, ref, ref_grads = _loss_and_grads(jm, tm, batch, W,
                                          jnp.float32(0.8), key, eps)
    np.testing.assert_allclose(as_numpy(per), np.asarray(ref),
                               rtol=LOSS_RTOL)
    _check_grads(_grads(tm), ref_grads)


def test_ssivae_aux_loss_classifier_trace_match_jax():
    jm, tm = _pair("ssiVAE", "ssiVAE", fused=False, latent_dim=2,
                   num_classes=K)
    x = _x(6, seed=3)
    y = np.eye(K, dtype=np.float32)[[0, 1, 2, 0, 1, 2]]
    ref = jm.aux_loss_fn(jm.params, None, (jnp.asarray(x), jnp.asarray(y)),
                         jnp.float32(20.0))
    np.testing.assert_allclose(as_numpy(tm.aux_loss_fn(_t(x), _t(y), 20.0)),
                               np.asarray(ref), rtol=LOSS_RTOL)
    assert as_numpy(tm.aux_loss_fn(_t(x), None)).tolist() == [0.0] * 6
    np.testing.assert_array_equal(as_numpy(tm.classifier(x)),
                                  np.asarray(jm.classifier(x)))
    _close(tm.guide_probs(x), jm.guide_probs(x))
    for labels in (None, y, np.array([2, 1, 0, 0, 1, 2])):
        for o, r in zip(tm.encode(x, labels), jm.encode(x, labels)):
            _close(o, r)
    key = jax.random.PRNGKey(4)
    ref = jm.trace(key, (jnp.asarray(x),), beta=0.6)
    with torch.no_grad():
        ours = tm.trace(_t(x), beta=0.6,
                        eps=_t(jax.random.normal(key, (K, 6, jm.z_dim))))
    for site, field in (("y", "probs"), ("y", "enumerated"), ("z", "loc"),
                        ("z", "scale"), ("z", "value")):
        _close(ours[site][field], ref[site][field])
    np.testing.assert_allclose(as_numpy(ours["branch_elbo"]),
                               np.asarray(ref["branch_elbo"]), rtol=LOSS_RTOL)
    z = np.random.default_rng(5).normal(size=(4, 2)).astype(np.float32)
    _close(tm.decode(z, y[:4], angle=0.4), jm.decode(z, y[:4], angle=0.4))
    _close(tm.manifold2d(3, label=2, plot=False),
           jm.manifold2d(3, label=2, plot=False))
    _close(tm.manifold_traversal(3, 0, plot=False),
           jm.manifold_traversal(3, 0, plot=False))


# ---------------------------------------------------------------------------
# ss_reg_iVAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("labeled", [True, False],
                         ids=["labeled", "unlabeled"])
def test_ss_reg_loss_and_grads_match_jax(labeled):
    """The JAX package splits the key into the label noise and the latent
    noise; both are injected (a labeled batch draws no label noise)."""
    jm, tm = _pair("ss_reg_iVAE", "ss_reg_iVAE", latent_dim=2, reg_dim=1)
    key = jax.random.PRNGKey(8)
    batch = (jnp.asarray(_x(seed=4)),)
    if labeled:
        batch += (jnp.asarray([0.1, -0.4, 0.7, 0.2], jnp.float32),)
    key_y, key_z = jax.random.split(key)
    shape_y, shape_z = tm.noise_shapes(B, labeled)
    assert (shape_y is None) == labeled
    eps = (None if labeled else _t(jax.random.normal(key_y, shape_y)),
           _t(jax.random.normal(key_z, shape_z)))
    per, ref, ref_grads = _loss_and_grads(jm, tm, batch, W,
                                          jnp.float32(0.9), key, eps)
    np.testing.assert_allclose(as_numpy(per), np.asarray(ref),
                               rtol=LOSS_RTOL)
    _check_grads(_grads(tm), ref_grads)


def test_ss_reg_aux_loss_regressor_match_jax():
    jm, tm = _pair("ss_reg_iVAE", "ss_reg_iVAE", fused=False, latent_dim=2,
                   reg_dim=1)
    x = _x(5, seed=5)
    y = np.array([0.3, -0.2, 0.9, 0.0, 0.5], np.float32)
    ref = jm.aux_loss_fn(jm.params, None, (jnp.asarray(x), jnp.asarray(y)),
                         jnp.float32(7.0))
    np.testing.assert_allclose(as_numpy(tm.aux_loss_fn(_t(x), _t(y), 7.0)),
                               np.asarray(ref), rtol=LOSS_RTOL)
    _close(tm.regressor(x), jm.regressor(x))
    for labels in (None, y):
        for o, r in zip(tm.encode(x, labels), jm.encode(x, labels)):
            _close(o, r)
    z = np.random.default_rng(6).normal(size=(5, 2)).astype(np.float32)
    _close(tm.decode(z, y[:, None], scale=0.9),
           jm.decode(z, y[:, None], scale=0.9))
    y0 = np.array([0.4], np.float32)
    _close(tm.manifold2d(3, y0, plot=False), jm.manifold2d(3, y0, plot=False))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

FAMILIES = {
    "jivae": ("jiVAE", dict(latent_dim=2, discrete_dim=K), K),
    "ssivae": ("ssiVAE", dict(latent_dim=2, num_classes=K), K),
    "ss_reg": ("ss_reg_iVAE", dict(latent_dim=2, reg_dim=1), 1),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_served_families_match_jax(family, tmp_path):
    """Exports of both packages: the encode (with the class probabilities
    for jiVAE, labelled by the model's own head for the semi-supervised
    ones), the classify or regress head, and the posed decode whose latents
    add the classes or labels, at ragged and fixed batch sizes."""
    name, kw, extra = FAMILIES[family]
    jm, tm = _pair(name, name, **kw)  # the port serves through K1
    x = _x(13, seed=6)
    z = np.random.default_rng(7).normal(size=(13, 2 + extra)).astype(
        np.float32)
    pose = dict(angle=0.3, shift=(0.1, -0.05), scale=1.1)
    for bs in (None, 8):
        jpath, tpath = str(tmp_path / f"j{bs}.pvtx"), str(tmp_path / f"t{bs}")
        jserving.export_model(jm, jpath, batch_size=bs)
        tserving.export_model(tm, tpath, batch_size=bs)
        js, ts = jserving.ServedModel(jpath), tserving.ServedModel(tpath,
                                                                    device="cpu")
        ours, ref = ts.encode(x), js.encode(x)
        assert len(ours) == len(ref) == (3 if family == "jivae" else 2)
        for o, r in zip(ours, ref):
            _close(o, r)
        if family == "ssivae":
            _close(ts.classify(x), js.classify(x))
        if family == "ss_reg":
            _close(ts.regress(x), js.regress(x))
        _close(ts.decode(z, **pose), js.decode(z, **pose))


def test_later_slice_features_raise_naming_roadmap(tmp_path, monkeypatch):
    """The later slices' features run in the families (``pixel_chunks``,
    the trainer surface, checkpoints, the default plot); ``fit(mesh=...)``
    takes a DeviceMesh (held against the JAX mesh in
    tests/test_torch_port_parallel.py): anything else is a TypeError
    naming it, and a one-rank mesh reaches the trainer."""
    import matplotlib.pyplot as plt
    j = tmodels.jiVAE(DATA, 2, K, device="cpu", pixel_chunks=2, **CFG)
    assert j._pixel_mode() == "chunk"
    assert np.isfinite(as_numpy(j.loss_fn(_x()))).all()
    m = tmodels.ssiVAE(DATA, 2, K, device="cpu", enum_topk=2, **CFG)
    x = _x(8)
    # the trainer surface is ported: patience and enum_schedule run
    tr = m.fit(x, (x, np.arange(8) % K), epochs=3, batch_size=4, patience=1,
               min_delta=1e9)
    assert tr.stopped_early and tr.current_epoch == 2
    tr = m.fit(x, (x, np.arange(8) % K), epochs=2, batch_size=4,
               enum_schedule=1)
    assert tr.current_epoch == 2 and m.enum_topk == 2
    with pytest.raises(ValueError, match="enum_schedule"):
        m.fit(x, (x, np.arange(8) % K), epochs=1, batch_size=4,
              enum_schedule=1, verbose=True)
    with pytest.raises(TypeError, match="DeviceMesh"):
        m.fit(x, (x, np.arange(8) % K), epochs=1, batch_size=4,
              mesh=object())
    with one_rank_mesh() as mesh:
        tr = m.fit(x, (x, np.arange(8) % K), epochs=1, batch_size=4,
                   mesh=mesh)
        assert tr.mesh is mesh and tr.current_epoch == 1
    # checkpoints are ported: the keywords reach the trainer and work
    ckpt = str(tmp_path / "ckpt.npz")
    tr = m.fit(x, (x, np.arange(8) % K), epochs=2, batch_size=4,
               checkpoint_path=ckpt, checkpoint_every=2)
    assert (tr.checkpoint_path, tr.checkpoint_every) == (ckpt, 2)
    fresh = auxSVItrainer(tmodels.ssiVAE(DATA, 2, K, device="cpu", **CFG))
    assert fresh.resume(ckpt) == 2
    assert fresh.history == tr.history
    monkeypatch.setattr(plt, "show", lambda: None)
    assert m.manifold2d(3, plot=True).shape == (9,) + DATA
    assert plt.get_fignums()
    plt.close("all")
    j = tmodels.jiVAE(DATA, 2, K, device="cpu", enum_topk=2, **CFG)
    tr = j.fit(x, epochs=2, batch_size=4, enum_schedule=1)
    assert tr.current_epoch == 2 and j.enum_topk == 2


# ---------------------------------------------------------------------------
# bf16
# ---------------------------------------------------------------------------

def _bf16_misses(ours, ref_tree):
    """The grads beyond the bf16 bounds of ``test_torch_port_bf16.py``:
    the largest error over 1e-4 + 2.5e-3 of the tensor's largest entry, or
    the mean error over 1.5e-3 of its mean magnitude."""
    ref = from_jax_params(jax.tree_util.tree_map(np.asarray, ref_tree))
    misses = []
    for name, r in ref.items():
        o = as_numpy(ours[name]).astype(np.float64)
        r = r.numpy().astype(np.float64)
        err = np.abs(o - r)
        if (err.max() > BF16_GRAD_ATOL + BF16_GRAD_REL * np.abs(r).max()
                or err.mean() > BF16_MEAN_REL * np.abs(r).mean()):
            misses.append((name, err.max(), err.mean()))
    return misses


def test_jivae_enumerated_loss_and_grads_match_jax_bf16(monkeypatch):
    """The enumerated jiVAE loss at the flagship's width and grid (28 x 28,
    K*B = 12 rows) with both packages' BF16_MATMUL set (their default):
    the JAX kernels in interpret mode against the port's plain versions,
    held to the bf16 bounds; the port with its flag cleared fails them."""
    monkeypatch.setattr(sd, "BF16_MATMUL", True)
    monkeypatch.setattr(tsd, "BF16_MATMUL", True)
    jm = jmodels.jiVAE((28, 28), 2, K, seed=3, **CFG)
    jm._fused = True
    key = jax.random.PRNGKey(9)
    eps = _t(jax.random.normal(key, (B, jm.z_dim)))
    x = np.random.default_rng(8).uniform(0, 1, (B, 28, 28)).astype(
        np.float32)
    beta = jnp.asarray([1.0, 0.5], jnp.float32)

    def f(p):
        return jnp.sum(jm.loss_fn(p, key, (jnp.asarray(x),), beta) * W)

    ref_loss, ref_grads = jax.value_and_grad(f)(jm.params)

    def ours():
        tm = tmodels.jiVAE((28, 28), 2, K, device="cpu", **CFG)
        tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
        loss = tm.weighted_loss_fn(_t(x), None, _t(W), _t(np.asarray(beta)),
                                   eps=eps)
        loss.backward()
        return loss, _grads(tm)

    loss, grads = ours()
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=BF16_LOSS_RTOL)
    assert _bf16_misses(grads, ref_grads) == []
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)
    assert _bf16_misses(ours()[1], ref_grads)

