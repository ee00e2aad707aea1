"""The port's plotting and GP surrogate against the JAX package's, on the
CPU: ``make_img_grid`` array for array; the GP's hyperparameters after 20
Adam steps and its predictions; every model's ``plot=True`` (the default
of ``manifold2d`` and ``manifold_traversal``) calling the same plotting
function with the same arguments; ``predict_on_latent``; and the plots
themselves under matplotlib's Agg backend with ``plt.show`` patched out."""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402

import pyroved_tpu.models as jmodels  # noqa: E402
import pyroved_tpu.utils.gp as jgp  # noqa: E402
import pyroved_tpu.utils.viz as jviz  # noqa: E402
import pyroved_tpu_torch.models as tmodels  # noqa: E402
import pyroved_tpu_torch.utils.gp as tgp  # noqa: E402
import pyroved_tpu_torch.utils.viz as tviz  # noqa: E402
from pyroved_tpu_torch.ops import spatial_decoder as tsd  # noqa: E402
from pyroved_tpu_torch.utils.nn import as_numpy  # noqa: E402

# Decoded images: f32 on both sides, sums in another order
ATOL = 1e-5
# The GP: 20 Adam steps of a Cholesky-based loss in f32, then predictions
# through the factor, in another library's order of operations
GP_RTOL = 1e-4
PLOTS = ("plot_img_grid", "plot_spect_grid", "plot_grid_traversal",
         "plot_latent_predictions")


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


@pytest.fixture
def no_show(monkeypatch):
    monkeypatch.setattr(plt, "show", lambda: None)
    yield
    plt.close("all")


def _spy(monkeypatch, module):
    """Replace the plotting functions of ``module`` by recorders: the list
    of (name, positional arguments as numpy, keywords) of the calls."""
    calls = []
    for name in PLOTS:
        def record(*args, _name=name, **kw):
            calls.append((_name, [as_numpy(a) if hasattr(a, "shape") else a
                                  for a in args], kw))
        monkeypatch.setattr(module, name, record)
    return calls


def _same_calls(ours, ref):
    assert [c[0] for c in ours] == [c[0] for c in ref]
    for (name, args, kw), (_, rargs, rkw) in zip(ours, ref):
        assert len(args) == len(rargs), name
        for a, r in zip(args, rargs):
            if isinstance(r, np.ndarray):
                assert a.shape == r.shape, name
                np.testing.assert_allclose(a, r, atol=ATOL, err_msg=name)
            else:
                assert tuple(np.atleast_1d(a)) == tuple(np.atleast_1d(r))
        assert sorted(kw) == sorted(rkw), name
        for k, v in rkw.items():
            if isinstance(v, str):
                assert kw[k] == v, (name, k)
            else:
                np.testing.assert_allclose(np.asarray(kw[k], np.float64),
                                           np.asarray(v, np.float64),
                                           rtol=1e-6, err_msg=f"{name} {k}")


def test_make_img_grid_matches_jax():
    rng = np.random.default_rng(0)
    for shape, kw in (((9, 5, 5), {}), ((7, 4, 6), dict(padding=1,
                                                        pad_value=-1.0)),
                      ((4, 3, 3, 3), dict(padding=0)), ((4, 3, 3, 1), {}),
                      ((4, 1, 3, 3), {}), ((5, 2, 2, 4), dict(pad_value=2.0))):
        imgs = rng.uniform(0, 1, shape).astype(np.float32)
        ref = jviz.make_img_grid(imgs, 3, **kw)
        for inp in (imgs, torch.from_numpy(imgs)):
            got = tviz.make_img_grid(inp, 3, **kw)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    bad = np.zeros((4, 3, 3, 2), np.float32)
    with pytest.raises(ValueError, match="channel"):
        jviz.make_img_grid(bad, 2)
    with pytest.raises(ValueError, match="channel"):
        tviz.make_img_grid(torch.from_numpy(bad), 2)


def test_gp_fit_and_predictions_match_jax():
    """20 Adam steps at lr 5e-3 from unit hyperparameters, then the
    predictive mean and variance at new points."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (48, 2)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)
    Xnew = rng.uniform(-2, 2, (10, 2)).astype(np.float32)
    jg, tg = jgp.GPRegression(X, y), tgp.GPRegression(torch.from_numpy(X), y)
    np.testing.assert_allclose(tg.fit(20), jg.fit(20), rtol=GP_RTOL)
    for ours, ref in zip(tg.params, jg.params):
        np.testing.assert_allclose(as_numpy(ours), np.asarray(ref),
                                   rtol=GP_RTOL)
    for ours, ref in zip(tg.predict(Xnew), jg.predict(Xnew)):
        np.testing.assert_allclose(as_numpy(ours), np.asarray(ref),
                                   rtol=GP_RTOL, atol=1e-6)
    assert float(tgp.gp_model(2, X, y, gp_iterations=3).fit(1)) == \
        pytest.approx(float(jgp.gp_model(2, X, y, gp_iterations=3).fit(1)),
                      rel=GP_RTOL)


def test_plot_functions_run(no_show):
    imgs = torch.rand(9, 8, 8)
    tviz.plot_img_grid(imgs, 3, extent=[-1, 1, -1, 1], cmap="viridis")
    tviz.plot_spect_grid(torch.rand(9, 16), 3, ylim=(0, 1))
    tviz.plot_grid_traversal(imgs, 3, (8, 8), 3)
    tviz.plot_latent_predictions(torch.randn(9), 3)
    with pytest.raises(AssertionError, match="3D or 4D"):
        tviz.plot_img_grid(torch.rand(8, 8), 3)


def _family(name):
    """(JAX model, port model on the same weights, manifold2d arguments,
    whether it has a manifold_traversal)."""
    spec = {
        "iVAE": ((12, 12), (2, ["r"]), {}, (), False),
        "iVAE_1d": ((24,), (2, ["t"]), {}, (), False),
        "jiVAE": ((12, 12), (2, 3, ["r"]), {}, (), True),
        "ssiVAE": ((12, 12), (2, 3, ["r"]), {}, (), True),
        "ss_reg_iVAE": ((12, 12), (2, 1, ["r"]), {}, (np.array([0.4],
                                                               np.float32),),
                        False),
        "VED": ((16, 16), ((32,),), dict(hidden_dim_e=((4,), (8,)),
                                         hidden_dim_d=((8,), (4,))), (),
                False),
    }[name]
    data, args, kw, margs, traversal = spec
    cls = "iVAE" if name == "iVAE_1d" else name
    jm = getattr(jmodels, cls)(data, *args, seed=0, **kw)
    tm = getattr(tmodels, cls)(data, *args, device="cpu", **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm, margs, traversal


@pytest.mark.parametrize("name", ["iVAE", "iVAE_1d", "jiVAE", "ssiVAE",
                                  "ss_reg_iVAE", "VED"])
def test_models_plot_as_jax(name, monkeypatch):
    """``manifold2d`` (and ``manifold_traversal``) with the default
    ``plot=True`` call the JAX package's plotting function with the same
    images and arguments (the grid's extent, or the spectra, or the
    traversal's strip), passing keywords such as ``cmap`` through."""
    jm, tm, margs, traversal = _family(name)
    ref, ours = _spy(monkeypatch, jviz), _spy(monkeypatch, tviz)
    out = tm.manifold2d(3, *margs, cmap="viridis")
    jout = jm.manifold2d(3, *margs, cmap="viridis")
    np.testing.assert_allclose(as_numpy(out), np.asarray(jout), atol=ATOL)
    if traversal:
        tm.manifold_traversal(3, 0)
        jm.manifold_traversal(3, 0)
    assert len(ref) == (2 if traversal else 1)
    _same_calls(ours, ref)
    tm.manifold2d(3, *margs, plot=False)
    assert len(ours) == len(ref)


def test_manifold_plots_render(no_show):
    """The default plot of a model's manifold renders under Agg."""
    tm = tmodels.jiVAE((12, 12), 2, 3, ["r"], device="cpu")
    assert tm.manifold2d(3).shape == (9, 12, 12)
    assert tm.manifold_traversal(3, 1).shape == (9, 12, 12)
    assert plt.get_fignums()


def test_predict_on_latent_matches_jax(monkeypatch):
    """The GP on the encoded latents of a model without invariances
    (z_dim = 2), its predictions over the 4 x 4 latent grid and the grid
    decoded; with ``plot=True`` the same two plots as the JAX package's.
    With invariances the encoded latents are 3-D against the 2-D grid:
    both packages refuse."""
    data = (12, 12)
    jm = jmodels.iVAE(data, 2, None, seed=0)
    tm = tmodels.iVAE(data, 2, None, device="cpu")
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    x = np.random.default_rng(0).uniform(0, 1, (24,) + data).astype(
        np.float32)
    labels = np.random.default_rng(1).normal(size=24).astype(np.float32)
    ref, ours = _spy(monkeypatch, jviz), _spy(monkeypatch, tviz)
    (jz, jdec), jpred = jm.predict_on_latent(x, labels, gp_iterations=5, d=4,
                                             plot=True)
    (z, dec), pred = tm.predict_on_latent(x, labels, gp_iterations=5, d=4,
                                          plot=True)
    np.testing.assert_allclose(as_numpy(z), np.asarray(jz), atol=1e-6)
    np.testing.assert_allclose(as_numpy(dec), np.asarray(jdec), atol=ATOL)
    assert pred.shape == (16,)
    np.testing.assert_allclose(as_numpy(pred), np.asarray(jpred), rtol=1e-4,
                               atol=1e-4)
    _same_calls(ours, ref)
    jr = jmodels.iVAE(data, 2, ["r"], seed=0)
    with pytest.raises(Exception):
        jr.predict_on_latent(x, labels, d=4)
    with pytest.raises(ValueError, match="z_dim"):
        tmodels.iVAE(data, 2, ["r"], device="cpu").predict_on_latent(
            x, labels, d=4)
