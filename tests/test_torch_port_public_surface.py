"""The public calls the port took over from the JAX package last: each held
against the JAX package's own on the same numpy inputs, or, for a
signature, on the same call. ``native``'s ``num_threads`` and
``shuffle_indices``, ``parallel.create_mesh(devices=)``,
``nets.coord_latent``, the one-hot categorical of ``infer.dists``,
``ops.spatial_decoder_reference`` and ``ops.fused_spatial_decoder``,
``utils.gp.GPParams`` and ``baseVAE.fixed_transform_grid``."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import pyroved_tpu.infer.dists as jdists
import pyroved_tpu.models as jmodels
import pyroved_tpu.native as jnative
import pyroved_tpu.ops.spatial_decoder as jsd
import pyroved_tpu.parallel as jpar
from pyroved_tpu.nets.fc import coord_latent as jcoord_latent
from pyroved_tpu.utils import gp as jgp
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch import native as tnative
from pyroved_tpu_torch import ops as tops
from pyroved_tpu_torch.infer import dists as tdists
from pyroved_tpu_torch.nets import coord_latent
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.parallel import create_mesh, initialize_multihost
from pyroved_tpu_torch.utils import gp as tgp
from pyroved_tpu_torch.utils.data import shuffle_indices
from pyroved_tpu_torch.weights import from_jax_params

# f32 on the CPU on both sides, sums in another order
ATOL = 1e-5
# grads: the JAX package's own tolerance (tests/test_ops_fused.py)
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# native
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gather_rows_third_argument_is_num_threads(dtype):
    """``gather_rows(src, idx, 4)`` gathers in both packages: the third
    argument is the worker count, which changes nothing; ``out`` is
    keyword-only and fills the given buffer."""
    rng = np.random.default_rng(0)
    src = (rng.uniform(0, 200, (50, 3, 4))).astype(dtype)
    idx = rng.integers(0, 50, 17)
    ref = jnative.gather_rows(src, idx, 4)
    got = tnative.gather_rows(src, idx, 4)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, ref)
    out = np.empty((17, 3, 4), dtype)
    assert tnative.gather_rows(src, idx, 2, out=out) is out
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(TypeError):
        tnative.gather_rows(src, idx, 0, out)


def test_u8_to_f32_takes_num_threads():
    src = np.random.default_rng(1).integers(0, 256, (9, 7)).astype(np.uint8)
    for scale in (1.0 / 255.0, 0.5):
        ref = jnative.u8_to_f32(src, scale, num_threads=3)
        np.testing.assert_array_equal(
            tnative.u8_to_f32(src, scale, num_threads=3), ref)
        np.testing.assert_array_equal(tnative.u8_to_f32(src, scale, 1), ref)


@pytest.mark.parametrize("n,seed,epoch", [(1, 0, 0), (10, 3, 1),
                                          (257, 12345, 7)])
def test_native_shuffle_indices(n, seed, epoch):
    """The JAX package's native permutation, and the one the port's data
    loaders use."""
    assert tnative.shuffle_indices is shuffle_indices
    got = tnative.shuffle_indices(n, seed, epoch)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jnative.shuffle_indices(n, seed, epoch))


# ---------------------------------------------------------------------------
# parallel.create_mesh(devices=)
# ---------------------------------------------------------------------------

def test_create_mesh_devices_mean_what_jax_means():
    """``devices`` are the mesh's participants in order: ranks, or devices
    mapped to their ranks; the same layout as ``ranks=``, the JAX mesh's
    shape; both at once raise."""
    ref = dict(jpar.create_mesh({"data": -1}, jax.devices()[:1]).shape)
    initialize_multihost(device="cpu")
    try:
        for devices in ([0], [torch.device("cpu")], ["cpu"], range(1)):
            mesh = create_mesh({"data": -1}, devices)
            assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == ref
            assert mesh.mesh.tolist() == create_mesh(
                {"data": -1}, ranks=[0]).mesh.tolist() == [0]
        mesh = create_mesh(devices=[torch.device("cpu")])
        assert mesh.mesh_dim_names == ("data",)
        with pytest.raises(ValueError, match="not both"):
            create_mesh({"data": 1}, devices=[0], ranks=[0])
        with pytest.raises(ValueError, match="held by ranks"):
            create_mesh({"data": 1}, devices=[torch.device("cuda", 0)])
        with pytest.raises(ValueError, match="do not cover"):
            create_mesh({"data": 2}, devices=[0])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# nets.coord_latent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("activation_out", [True, False])
def test_coord_latent_matches_jax(activation_out):
    """The same weights, carried across by ``weights.from_jax_params``
    under the JAX names ``fc_coord`` / ``fc_latent``, give the same
    output."""
    rng = np.random.default_rng(2)
    xc = rng.uniform(-1, 1, (4, 30, 2)).astype(np.float32)
    z = rng.normal(size=(4, 3)).astype(np.float32)
    jm = jcoord_latent(latent_dim=3, out_dim=16, activation_out=activation_out)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xc), jnp.asarray(z))
    ref = np.asarray(jm.apply(params, jnp.asarray(xc), jnp.asarray(z)))
    tm = coord_latent(3, 16, activation_out=activation_out)
    state = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   params["params"]))
    assert set(state) == {"fc_coord.weight", "fc_coord.bias",
                          "fc_latent.weight"}
    tm.load_state_dict(state)
    got = tm(torch.from_numpy(xc), torch.from_numpy(z))
    assert got.shape == ref.shape == (4, 30, 16)
    np.testing.assert_allclose(_np(got), ref, atol=ATOL)


# ---------------------------------------------------------------------------
# infer.dists one-hot categorical
# ---------------------------------------------------------------------------

def test_one_hot_categorical_log_prob_matches_jax():
    rng = np.random.default_rng(3)
    p = rng.uniform(0.1, 1.0, (6, 4)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    p[0] = [0.0, 1.0, 0.0, 0.0]  # a zero probability off the drawn class
    x = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    x[0] = [0.0, 1.0, 0.0, 0.0]
    ref = np.asarray(jdists.one_hot_categorical_log_prob(jnp.asarray(x),
                                                         jnp.asarray(p)))
    got = tdists.one_hot_categorical_log_prob(torch.from_numpy(x),
                                              torch.from_numpy(p))
    np.testing.assert_allclose(_np(got), ref, atol=ATOL)


def test_one_hot_categorical_sample_matches_jax_in_distribution():
    """Random bits differ between the packages, so the draws are compared
    in distribution: one-hot rows, a class of probability 0 never drawn,
    class frequencies of 20,000 draws each within 0.015 of the JAX
    sampler's and of the probabilities (a binomial's standard deviation
    is at most 0.0036 here). The draw follows the torch.Generator."""
    sure = tdists.one_hot_categorical_sample(
        torch.tensor([[0.0, 1.0, 0.0]] * 4), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(_np(sure), np.eye(3)[[1, 1, 1, 1]])
    p = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    probs = np.broadcast_to(p, (20000, 4))
    ref = np.asarray(jdists.one_hot_categorical_sample(
        jax.random.PRNGKey(1), jnp.asarray(probs)))
    got = _np(tdists.one_hot_categorical_sample(
        torch.from_numpy(probs.copy()), torch.Generator().manual_seed(1)))
    assert got.dtype == np.float32 and got.shape == (20000, 4)
    np.testing.assert_array_equal(got.sum(-1), np.ones(20000))
    assert got[:, 1].sum() == 0
    np.testing.assert_allclose(got.mean(0), ref.mean(0), atol=0.015)
    np.testing.assert_allclose(got.mean(0), p, atol=0.015)
    again = tdists.one_hot_categorical_sample(
        torch.from_numpy(probs.copy()), torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(_np(again), got)


# ---------------------------------------------------------------------------
# ops.spatial_decoder_reference and ops.fused_spatial_decoder
# ---------------------------------------------------------------------------

def _decoder_inputs(B=3, N=40, H=128, L=2, nl=2, seed=4):
    rng = np.random.default_rng(seed)
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)  # noqa: E731
    return dict(grid=rng.uniform(-1, 1, (N, 2)).astype(np.float32),
                phi=f(B), dx=f(B, 2, k=0.1), sc=1 + f(B, k=0.1), z=f(B, L),
                Wc=f(2, H, k=0.5), bc=f(H, k=0.1), Wz=f(L, H, k=0.5),
                hw=f(nl, H, H, k=1.2 / H ** 0.5), hb=f(nl, H, k=0.1),
                wout=f(H, 1, k=1.0 / H ** 0.5), bout=f(1, k=0.1))


@pytest.mark.parametrize("bf16_flag", [True, False])
def test_spatial_decoder_reference_matches_jax(monkeypatch, bf16_flag):
    """The JAX reference decode (tanh, sigmoid head, ``hidden`` as (W, b)
    pairs) in f32 whatever the port's BF16_MATMUL says."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", bf16_flag)
    a = _decoder_inputs()
    hidden = [(a["hw"][i], a["hb"][i]) for i in range(2)]
    args = [a[k] for k in ("grid", "phi", "dx", "sc", "z", "Wc", "bc", "Wz")]
    ref = np.asarray(jsd.spatial_decoder_reference(
        *map(jnp.asarray, args),
        [(jnp.asarray(W), jnp.asarray(b)) for W, b in hidden],
        jnp.asarray(a["wout"]), jnp.asarray(a["bout"])))
    got = tops.spatial_decoder_reference(
        *map(torch.from_numpy, args),
        [(torch.from_numpy(W), torch.from_numpy(b)) for W, b in hidden],
        torch.from_numpy(a["wout"]), torch.from_numpy(a["bout"]))
    assert got.shape == ref.shape == (3, 40)
    np.testing.assert_allclose(_np(got), ref, atol=ATOL)


@pytest.mark.parametrize("act,sigmoid_out", [("tanh", True),
                                             ("softplus", False)])
def test_fused_spatial_decoder_matches_jax(monkeypatch, act, sigmoid_out):
    """Output and the grads of every input but the grid, in the JAX
    argument order, against the JAX custom VJP (its Pallas backward in
    interpret mode, f32); a scalar ``bout`` as the JAX docstring has it."""
    monkeypatch.setattr(tsd, "BF16_MATMUL", False)
    monkeypatch.setattr(jsd, "INTERPRET", True)
    monkeypatch.setattr(jsd, "BF16_MATMUL", False)
    monkeypatch.setattr(jsd, "ACT_DTYPE", jnp.float32)
    a = _decoder_inputs()
    names = list(a)
    g = np.random.default_rng(5).normal(size=(3, 40)).astype(np.float32)

    def jfn(*xs):
        return jsd.fused_spatial_decoder(*xs, act, sigmoid_out)

    out, vjp = jax.vjp(jfn, *(jnp.asarray(a[k]) for k in names))
    ref_grads = vjp(jnp.asarray(g))
    ts = {k: torch.from_numpy(a[k]).requires_grad_(k != "grid")
          for k in names}
    got = tops.fused_spatial_decoder(*ts.values(), act, sigmoid_out)
    np.testing.assert_allclose(_np(got), np.asarray(out), atol=ATOL)
    got.backward(torch.from_numpy(g))
    for k, r in zip(names[1:], ref_grads[1:]):
        np.testing.assert_allclose(_np(ts[k].grad), np.asarray(r),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)
    scalar = tops.fused_spatial_decoder(
        *(t.detach() for t in list(ts.values())[:-1]),
        ts["bout"].detach()[0], act, sigmoid_out)
    np.testing.assert_array_equal(_np(scalar), _np(got))


# ---------------------------------------------------------------------------
# utils.gp.GPParams
# ---------------------------------------------------------------------------

def test_gp_params_structure():
    """tests/test_utils_api.py's structure test, and the fields in the JAX
    order."""
    p = tgp.GPParams(torch.zeros(()), torch.zeros(()), torch.zeros(()))
    assert p.log_variance.shape == ()
    assert tgp.GPParams._fields == jgp.GPParams._fields


def test_gp_takes_gp_params():
    """A GP holds a GPParams, takes one assigned, and predicts as the JAX
    GP with the same parameters; after fitting it holds a GPParams."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(20, 2)).astype(np.float32)
    y = np.sin(X[:, 0]).astype(np.float32)
    Xn = rng.normal(size=(7, 2)).astype(np.float32)
    logs = (0.3, -0.2, -1.5)
    jg = jgp.GPRegression(X, y)
    jg.params = jgp.GPParams(*(jnp.float32(v) for v in logs))
    tg = tgp.GPRegression(X, y)
    assert isinstance(tg.params, tgp.GPParams)
    tg.params = tgp.GPParams(*(torch.tensor(v) for v in logs))
    for ours, ref in zip(tg.predict(Xn), jg.predict(Xn)):
        np.testing.assert_allclose(_np(ours), np.asarray(ref), atol=ATOL)
    tg.fit(2)
    assert isinstance(tg.params, tgp.GPParams)
    assert all(p.shape == () for p in tg.params)


# ---------------------------------------------------------------------------
# baseVAE.fixed_transform_grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,pose", [
    (dict(data_dim=(8, 8), invariances=["r", "t", "s"]),
     dict(angle=0.3, shift=(0.1, -0.2), scale=1.2)),
    (dict(data_dim=(8, 8), invariances=["r"]), dict(angle=-1.1)),
    (dict(data_dim=(8, 8), invariances=["r"]), {}),
    (dict(data_dim=(24,), invariances=["t"]), dict(shift=0.25)),
    (dict(data_dim=(8, 8), invariances=None), dict(angle=0.3)),
])
def test_fixed_transform_grid_method_matches_jax(cfg, pose):
    """The method on every model: the grid under one pose, None without
    a coordinate transform."""
    ref = jmodels.iVAE(seed=0, **cfg).fixed_transform_grid(**pose)
    got = tmodels.iVAE(device="cpu", **cfg).fixed_transform_grid(**pose)
    if ref is None:
        assert got is None
        return
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=ATOL)
