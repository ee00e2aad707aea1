"""The port's pixel sharding (``parallel.shard_pixels``: the decoder's
grid split over a mesh axis, the per-example partial terms summed over it)
on CPU ranks joined over gloo, against the JAX package's sharded loss on
as many of the 8 virtual CPU devices (tests/test_pixel_parallel.py).

Each rank must hold the loss and every grad whole, encoder's and
decoder's alike: a sum whose backward all-reduced the cotangent again, or
grads summed over the axis twice or not at all, would show here as a grad
2x too large or half its size. So every case holds both ranks' grads to
the JAX package's, here for iVAE (rotation; rotation, translation and
scale; three channels; on the kernels' path, whose plain versions run
here, and on the module path) on 81 pixels that 2 does not divide (padded
and masked); tests/test_torch_port_pixel_shard_families.py holds the other
families. Then through the trainer: composed with data parallelism on 4
ranks, and turned off after a step. The port's hidden products are f32
(its flag cleared)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import pyroved_tpu.models as jmodels
import pyroved_tpu.ops.spatial_decoder as sd
from pyroved_tpu.parallel import shard_pixels as jshard_pixels
from pyroved_tpu.trainers.svi import SVItrainer as JSVItrainer
from pyroved_tpu.utils.data import init_dataloader as jinit_dataloader
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.parallel import shard_pixels

from test_torch_port_parallel import _state, _svi_noise
from torch_port_ranks import Ranks, one_rank_mesh

# f32 on both sides, the pixels' sums split over ranks (devices) in
# another order: losses relative, grads as the JAX package's own bound for
# its sharded grads (tests/test_pixel_parallel.py: atol 1e-4, rtol 1e-4;
# the port's grad tolerance adds rtol 1e-3), trained parameters as its DP
# tests hold them
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
PARAM_ATOL = 1e-5
# Parameters after a run whose grids were split in another order than the
# JAX package's: Adam divides each update by the root of its grad's second
# moment, so an entry whose grad is at rounding level moves by up to lr
# (1e-3) a step either way. The JAX package holds its own
# pixel-partitioned trajectory at atol 2e-3 (tests/test_pixel_parallel.py,
# test_pixel_chunks_training_matches_trajectory).
PIXEL_PARAM_ATOL = 2e-3
DATA = (9, 9)  # 81 pixels: 2 ranks of 41, one padded
B = 6


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _np(a):
    return np.array(a, np.float32)


def _y3(n):
    return np.eye(3, dtype=np.float32)[np.arange(n) % 3]


# the noise the JAX models' losses draw from key, in the port's shapes
def _ivae_noise(key, shapes):
    return _np(jax.random.normal(key, shapes[0]))


def _ss_reg_noise(key, shapes):
    ky, kz = jax.random.split(key)
    return tuple(None if s is None else _np(jax.random.normal(k, s))
                 for k, s in zip((ky, kz), shapes))


# name: (class, args, model keywords, labels, beta)
CASES = {
    "ivae_r_kernels": ("iVAE", (DATA, 2, ["r"]), {}, None, 1.0),
    "ivae_r_module": ("iVAE", (DATA, 2, ["r"]), {"fused": False}, None, 1.0),
    "ivae_rts_kernels": ("iVAE", (DATA, 2, ["r", "t", "s"]), {}, None, 1.0),
    "ivae_rts_module": ("iVAE", (DATA, 2, ["r", "t", "s"]),
                        {"fused": False}, None, 1.0),
    "ivae_channels": ("iVAE", (DATA, 2, ["r"]), {"channels": 3}, None, 1.0),
    "jivae_exact": ("jiVAE", (DATA, 2, 3, ["r"]), {}, None, [1.0, 0.5]),
    "jivae_topk": ("jiVAE", (DATA, 2, 5, ["r"]), {"enum_topk": 2}, None,
                   [1.0, 0.5]),
    "ssivae_unlabeled": ("ssiVAE", (DATA, 2, 3, ["r"]), {}, None, 0.8),
    "ssivae_labeled": ("ssiVAE", (DATA, 2, 3, ["r"]), {}, "onehot", 0.8),
    "ss_reg_unlabeled": ("ss_reg_iVAE", (DATA, 2, 2, ["r"]), {}, None, 0.9),
    "ss_reg_labeled": ("ss_reg_iVAE", (DATA, 2, 2, ["r"]), {}, "reg", 0.9),
}


def _case(name):
    """(JAX model, key, the port's case) of ``name``; the two paths of one
    configuration share their inputs (the JAX package has one path)."""
    cls, args, kw, labels, beta = CASES[name]
    i = sorted({_base(n) for n in CASES}).index(_base(name))
    kw = {k: v for k, v in kw.items() if k != "fused"}
    jm = getattr(jmodels, cls)(*args, seed=0, **kw)
    shape = (B,) + DATA + ((3,) if kw.get("channels") else ())
    batch = (_x(shape, 20 + i),)
    if labels == "onehot":
        batch += (_y3(B),)
    elif labels == "reg":
        batch += (np.random.default_rng(9).normal(size=(B, 2)).astype(
            np.float32),)
    tm = getattr(tmodels, cls)(*args, device="cpu", **kw)
    key = jax.random.PRNGKey(7 + i)
    shapes = tm.noise_shapes(B, len(batch) > 1)
    eps = (_ss_reg_noise(key, shapes) if cls == "ss_reg_iVAE"
           else _ivae_noise(key, shapes))
    return jm, key, dict(cls=cls, args=args, kw=CASES[name][2],
                         state=_state(jm), batch=batch, eps=eps, beta=beta)


def _base(name):
    return name.replace("_kernels", "").replace("_module", "")


def _pixel_mesh(n, extra=None):
    devs = jax.devices()[:n if extra is None else n * extra]
    if extra is None:
        return Mesh(np.array(devs).reshape(n), ("pixels",))
    return Mesh(np.array(devs).reshape(extra, n), ("data", "pixels"))


def _jax_loss_and_grads(jm, key, batch, beta):
    beta = (jm.prep_beta(beta) if hasattr(jm, "prep_beta")
            else jnp.asarray(beta, jnp.float32))
    batch = tuple(jnp.asarray(b) for b in batch)

    def total(p):
        per = jm.loss_fn(p, key, batch, beta)
        return jnp.sum(per), per

    grads, per = jax.grad(total, has_aux=True)(jm.params)
    return np.asarray(per), _state_of(grads)


def _state_of(tree):
    from pyroved_tpu_torch.weights import from_jax_params
    return {k: v.numpy() for k, v in from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


FLIP = dict(seed=2, rows=30, batch=10, loader=1)
DP = dict(seed=4, rows=32, batch=8, loader=0, epochs=2)


def launch_cases(tmp, names, extra=()):
    """2 ranks on the loss-and-grads cases ``names`` (and ``extra``
    bodies): (the ranks, the cases, their JAX models and keys)."""
    models, cases = {}, {}
    for name in names:
        jm, key, cases[name] = _case(name)
        models[name] = (jm, key)
    two = Ranks(tmp, 2, [("loss", "shard_loss", {"cases": cases}),
                         *extra])
    return two, cases, models


def check_case(two, cases, models, name, cache=True):
    """Both ranks' per-example losses and grads of case ``name`` against
    the JAX package's sharded ones on 2 devices (computed once per
    configuration, or afresh without ``cache``); returns the ranks'
    results."""
    jm, key = models[name]
    c = cases[name]
    jshard_pixels(jm, _pixel_mesh(2))
    ref = _JAX.get(_base(name)) if cache else None
    if ref is None:
        ref = _jax_loss_and_grads(jm, key, c["batch"], c["beta"])
        if cache:
            _JAX[_base(name)] = ref
    ref_loss, ref_grads = ref
    for r, out in enumerate(two.all("loss")):
        got = out[name]
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=LOSS_RTOL,
                                   err_msg=f"rank {r}")
        assert sorted(got["grads"]) == sorted(ref_grads)
        for k, g in ref_grads.items():
            np.testing.assert_allclose(got["grads"][k], g, atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL,
                                       err_msg=f"rank {r}: {k}")
    return two.all("loss")


_JAX = {}  # a configuration's JAX loss and grads, computed once


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The iVAE cases on 2 ranks and the 4-rank data x pixels run, started
    once; the JAX models and keys ride along for the references."""
    tmp = tmp_path_factory.mktemp("pixel_shard")
    jm = jmodels.iVAE(DATA, 2, ["r"], seed=FLIP["seed"])
    x = _x((FLIP["rows"],) + DATA, 5)
    steps = FLIP["rows"] // FLIP["batch"]
    flip = dict(state=_state(jm), x=x, batch_size=FLIP["batch"],
                seed=FLIP["loader"],
                noise=_svi_noise(FLIP["seed"], 2, steps, (FLIP["batch"], 3)))
    two, cases, models = launch_cases(
        tmp, [n for n in CASES if n.startswith("ivae")],
        [("flip", "shard_flip", flip)])
    models["flip"] = jm
    jd = jmodels.iVAE((8, 8), 2, ["r"], seed=DP["seed"])
    dp = dict(cls="iVAE", args=((8, 8), 2, ["r"]), kw={}, state=_state(jd),
              x=(_x((DP["rows"], 8, 8), 6),), batch_size=DP["batch"],
              seed=DP["loader"], epochs=DP["epochs"], how="run",
              axes={"data": 2, "pixels": 2}, pixels="pixels",
              noise=_svi_noise(DP["seed"], DP["epochs"],
                               DP["rows"] // DP["batch"], (DP["batch"], 3)))
    models["dp"] = jd
    four = Ranks(tmp, 4, [("dp", "train", dp)])
    return two, four, models, cases, flip, dp


def _check_case(ranks, name):
    two, _, models, cases, _, _ = ranks
    return check_case(two, cases, models, name)


@pytest.mark.parametrize("path", ["kernels", "module"])
@pytest.mark.parametrize("inv", ["r", "rts"])
def test_ivae_shard_pixels_loss_and_grads_match_jax(ranks, inv, path):
    """tests/test_pixel_parallel.py:156-169 on 2 ranks: the kernels' path
    runs one K1 and one K2 on each rank's 41 pixels."""
    outs = _check_case(ranks, f"ivae_{inv}_{path}")
    calls = outs[0][f"ivae_{inv}_{path}"]["calls"]
    assert calls == ({"K1": 1, "K2": 1, "K3": 0} if path == "kernels"
                     else {"K1": 0, "K2": 0, "K3": 0})


def test_ivae_shard_pixels_three_channels(ranks):
    _check_case(ranks, "ivae_channels")


def test_shard_pixels_validation():
    """tests/test_pixel_parallel.py:194-205: an axis the mesh lacks and a
    model without a grid raise; the mode turns on and off."""
    m = tmodels.iVAE((8, 8), 2, ["r"], device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        shard_pixels(m, object())
    with one_rank_mesh({"pixels": 1}) as mesh:
        with pytest.raises(ValueError, match="no axis"):
            shard_pixels(m, mesh, axis="nope")
        with pytest.raises(ValueError, match="spatial decoder"):
            shard_pixels(tmodels.iVAE((8, 8), 2, None, device="cpu"), mesh)
        assert shard_pixels(m, mesh) is m and m._pixel_mode() == "shard"
        x = torch.from_numpy(_x((4, 8, 8), 1))
        eps = torch.zeros(4, 3)
        with torch.no_grad():  # one rank: the whole grid, the same loss
            sharded = m.loss_fn(x, eps=eps)
            shard_pixels(m, None)
            assert m._pixel_mode() is None
            np.testing.assert_allclose(m.loss_fn(x, eps=eps), sharded,
                                       rtol=LOSS_RTOL)


def test_shard_pixels_turned_off_after_a_step(ranks):
    """tests/test_pixel_parallel.py:284-308: an epoch sharded, then
    ``shard_pixels(model, None)`` and an epoch on the full grid, against
    the JAX trainer doing the same (it retraces; the port reads the mode
    at every loss)."""
    two, _, models, _, flip, _ = ranks
    jm = models["flip"]
    jt = JSVItrainer(jm, seed=FLIP["seed"])
    ld = jinit_dataloader(flip["x"], batch_size=FLIP["batch"],
                          seed=FLIP["loader"])
    jshard_pixels(jm, _pixel_mesh(2))
    ref = [jt.train(ld)]
    jshard_pixels(jm, None)
    ref.append(jt.train(ld))
    for out in two.all("flip"):
        assert out["modes"] == [None]
        np.testing.assert_allclose(out["losses"], ref, rtol=LOSS_RTOL)
        for k, v in _state(jm).items():
            np.testing.assert_allclose(out["params"][k], v,
                                       atol=PIXEL_PARAM_ATOL, err_msg=k)


def test_shard_pixels_composes_with_data_parallel(ranks):
    """tests/test_pixel_parallel.py:228-241: {'data': 2, 'pixels': 2} on 4
    ranks, each decoding its 32 pixels of its 4 rows (one K1 and one K2 a
    step), against the JAX trainer on the same mesh of 4 devices; every
    rank's parameters bitwise equal."""
    _, four, models, _, _, dp = ranks
    jm = models["dp"]
    mesh = _pixel_mesh(2, extra=2)
    jshard_pixels(jm, mesh)
    jt = JSVItrainer(jm, seed=DP["seed"], mesh=mesh)
    ref = jt.run(jinit_dataloader(dp["x"][0], batch_size=DP["batch"],
                                  seed=DP["loader"]), DP["epochs"])
    outs = four.all("dp")
    steps = DP["epochs"] * DP["rows"] // DP["batch"]
    for out in outs:
        np.testing.assert_allclose(out["losses"], ref, rtol=LOSS_RTOL)
        assert out["calls"] == {"K1": steps, "K2": steps, "K3": 0}
        for k, v in outs[0]["params"].items():
            assert np.array_equal(out["params"][k], v), k
    for k, v in _state(jm).items():
        np.testing.assert_allclose(outs[0]["params"][k], v, atol=PARAM_ATOL,
                                   err_msg=k)
