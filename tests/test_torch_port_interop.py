"""Reference pyroVED weights in the port (``pyroved_tpu_torch/interop.py``,
``load_torch_weights``) against the JAX package's interop, on the CPU:
the reference-shaped torch modules of ``test_interop.py`` (an iVAE, a VED
and a batchnorm VED whose running statistics have drifted) loaded into
both packages give bitwise the same weights (the JAX tree carried across
by ``from_jax_params``) and the same running statistics; the port's
forwards match the torch modules' (and, with the running statistics, the
JAX model's); ``params_to_torch`` equals the JAX package's and
round-trips; the strict, shape and ``weights_only`` errors raise as in
JAX."""
import pickle

import numpy as np
import pytest
import torch

import jax

import pyroved_tpu as pv
from pyroved_tpu import interop as jinterop
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch import interop
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.weights import from_jax_params
from test_interop import TorchBNVED, TorchIVAE, TorchVED

# Forward parity against the torch modules, as tests/test_interop.py holds
# the JAX package: 1e-5 for the fc nets, 1e-4 (rel and abs) for the conv
# VED; against the JAX model, the port's f32 tolerance.
ATOL = 1e-5
VED_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX package's CPU path
    computes them, for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _np(t):
    return t.detach().cpu().numpy()


def _drifted_bn_ved(seed=6):
    """TorchBNVED in eval() after three train-mode forwards moved its
    running statistics off their init."""
    torch.manual_seed(seed)
    tm = TorchBNVED()
    rng = np.random.default_rng(2)
    tm.train()
    for _ in range(3):
        tm.encode(torch.from_numpy(rng.random((16, 1, 8, 8), np.float32)))
        tm.decode(torch.from_numpy(rng.normal(size=(16, 2)).astype(
            np.float32)))
    return tm.eval()


BN_DIMS = dict(hidden_dim_e=((8,), (16, 16)), hidden_dim_d=((16, 16), (8,)))

# name: (reference module factory, model args, model keywords)
CASES = {
    "ivae": (lambda: (torch.manual_seed(3), TorchIVAE(64, 6, 2))[1],
             ((8, 8),), dict(latent_dim=2, invariances=["r", "t", "s"])),
    "ved": (lambda: (torch.manual_seed(4), TorchVED(2, 128 * 2 * 2, 16))[1],
            ((8, 8), (16,)), dict(latent_dim=2)),
    "bn_ved": (_drifted_bn_ved, ((8, 8), (16,)),
               dict(latent_dim=2, batchnorm=True, **BN_DIMS)),
}


def _load_both(name):
    make, args, kw = CASES[name]
    ref = make()
    Model = pv.models.iVAE if name == "ivae" else pv.models.VED
    jm = Model(*args, **kw)
    jm.load_torch_weights(ref.state_dict())
    TModel = tmodels.iVAE if name == "ivae" else tmodels.VED
    tm = TModel(*args, device="cpu", **kw)
    tm.load_torch_weights(ref.state_dict())
    return ref, jm, tm


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_equals_jax_carried_across(name):
    """The port's loaded state_dict is bitwise the JAX package's loaded
    tree through ``from_jax_params``; the running statistics are bitwise
    JAX's ``state`` and switch on ``use_running_stats`` in both."""
    _, jm, tm = _load_both(name)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    got = tm.nets.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)
    if name == "bn_ved":
        assert jm.use_running_stats and tm.use_running_stats
        flat = {}
        for top, tree in jm.state.items():
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
                keys = ".".join(p.key for p in path)
                flat[f"{top}.{keys}"] = np.asarray(leaf)
        assert sorted(flat) == sorted(tm.state)
        for k, v in flat.items():
            np.testing.assert_array_equal(_np(tm.state[k]), v, err_msg=k)
    else:
        assert not tm.state if name == "ved" else not hasattr(tm, "state")


def test_ivae_forward_matches_torch_module():
    ref, _, tm = _load_both("ivae")
    x = np.random.default_rng(0).random((5, 8, 8)).astype(np.float32)
    mu_t, sig_t = ref.encoder_z(torch.from_numpy(x))
    z_loc, z_scale = tm.encode(x)
    np.testing.assert_allclose(_np(z_loc), _np(mu_t), atol=ATOL)
    np.testing.assert_allclose(_np(z_scale), _np(sig_t), atol=ATOL)
    z = np.random.default_rng(1).normal(size=(4, 2)).astype(np.float32)
    dec = tm.decode(z)  # the kernel's plain version on the CPU
    grid = tm.grid.expand(4, -1, -1)
    dec_t = ref.decoder(grid, torch.from_numpy(z)).reshape(4, 8, 8)
    np.testing.assert_allclose(_np(dec), _np(dec_t), atol=ATOL)


def test_ved_forward_matches_torch_module():
    ref, _, tm = _load_both("ved")
    x = np.random.default_rng(0).random((3, 8, 8)).astype(np.float32)
    mu_t, sig_t = ref.encoder_z(torch.from_numpy(x).unsqueeze(1))
    z_loc, z_scale = tm.encode(x)
    np.testing.assert_allclose(_np(z_loc), _np(mu_t), rtol=VED_TOL,
                               atol=VED_TOL)
    np.testing.assert_allclose(_np(z_scale), _np(sig_t), rtol=VED_TOL,
                               atol=VED_TOL)
    z = np.random.default_rng(1).normal(size=(3, 2)).astype(np.float32)
    dec_t = ref.decoder(torch.from_numpy(z))[:, 0, :]
    np.testing.assert_allclose(_np(tm.decode(z)), _np(dec_t), rtol=VED_TOL,
                               atol=VED_TOL)


def test_batchnorm_running_stats_match_torch_eval_and_jax():
    """Inference with the imported running statistics: the torch module's
    eval() forward (1e-4) and the JAX VED's with ``use_running_stats``
    (1e-5), whatever the batch; training still normalizes with the
    batch's own statistics (the port's loss with autograd on equals the
    loss of a model without the statistics)."""
    ref, jm, tm = _load_both("bn_ved")
    rng = np.random.default_rng(2)
    x = rng.random((5, 8, 8), np.float32)
    with torch.no_grad():
        mu_t, sig_t = ref.encode(torch.from_numpy(x).unsqueeze(1))
    z_loc, z_scale = tm.encode(x)
    np.testing.assert_allclose(_np(z_loc), _np(mu_t), rtol=VED_TOL,
                               atol=VED_TOL)
    np.testing.assert_allclose(_np(z_scale), _np(sig_t), rtol=VED_TOL,
                               atol=VED_TOL)
    jz_loc, jz_scale = jm.encode(x)
    np.testing.assert_allclose(_np(z_loc), np.asarray(jz_loc), atol=ATOL)
    np.testing.assert_allclose(_np(z_scale), np.asarray(jz_scale), atol=ATOL)
    # one row alone normalizes as it does among others
    np.testing.assert_allclose(_np(tm.encode(x[:1])[0]), _np(z_loc[:1]),
                               atol=ATOL)
    z = rng.normal(size=(4, 2)).astype(np.float32)
    with torch.no_grad():
        dec_t = ref.decode(torch.from_numpy(z))[:, 0, :]
    dec = tm.decode(z)
    np.testing.assert_allclose(_np(dec), _np(dec_t), rtol=VED_TOL,
                               atol=VED_TOL)
    np.testing.assert_allclose(_np(dec), np.asarray(jm.decode(z)), atol=ATOL)

    # with autograd on, the batch's statistics
    y = rng.random((5, 16), np.float32)
    eps = rng.normal(size=(5, 2)).astype(np.float32)
    batch_stats = tmodels.VED((8, 8), (16,), latent_dim=2, batchnorm=True,
                              device="cpu", **BN_DIMS)
    batch_stats.nets.load_state_dict(tm.nets.state_dict())
    np.testing.assert_array_equal(_np(tm.loss_fn(x, y, eps=eps)),
                                  _np(batch_stats.loss_fn(x, y, eps=eps)))
    with torch.no_grad():
        assert not np.allclose(_np(tm.loss_fn(x, y, eps=eps)),
                               _np(batch_stats.loss_fn(x, y, eps=eps)))


def test_running_stats_stay_out_of_the_state_dict(tmp_path):
    """The statistics are the model's ``state``, not parameters: weights
    files and ``from_jax_params`` keep their keys."""
    _, jm, tm = _load_both("bn_ved")
    keys = set(tm.nets.state_dict())
    assert not any("running" in k or k.endswith((".mean", ".var"))
                   for k in keys)
    assert keys == set(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    tm.save_weights(str(tmp_path / "w"))
    fresh = tmodels.VED((8, 8), (16,), latent_dim=2, batchnorm=True,
                        device="cpu", **BN_DIMS)
    fresh.load_weights(str(tmp_path / "w"))
    assert not fresh.use_running_stats


def test_load_from_pt_file(tmp_path):
    torch.manual_seed(5)
    ref = TorchIVAE(64, z_out=3, latent_dim=2)
    path = tmp_path / "ref_weights.pt"
    torch.save(ref.state_dict(), str(path))
    tm = tmodels.iVAE((8, 8), latent_dim=2, invariances=["r"], device="cpu")
    assert tm.load_torch_weights(str(path)) is tm
    x = np.random.default_rng(0).random((2, 8, 8)).astype(np.float32)
    mu_t, _ = ref.encoder_z(torch.from_numpy(x))
    np.testing.assert_allclose(_np(tm.encode(x)[0]), _np(mu_t), atol=ATOL)


# the model list of test_interop.py's round trips
ROUND_TRIPS = {
    "ivae_rt_c3": ("iVAE", ((8, 8),), dict(latent_dim=2, invariances=["r", "t"],
                                           c_dim=3)),
    "jivae_t": ("jiVAE", ((8, 8),), dict(latent_dim=2, discrete_dim=4,
                                         invariances=["t"])),
    "ssivae_r": ("ssiVAE", ((8, 8),), dict(latent_dim=2, num_classes=3,
                                           invariances=["r"])),
    "ss_reg": ("ss_reg_iVAE", ((8, 8),), dict(latent_dim=2, reg_dim=1)),
    "ved": ("VED", ((8, 8), (16,)), dict(latent_dim=2)),
    "ivae_1d": ("iVAE", ((24,),), dict(latent_dim=2, invariances=["t"])),
    "ivae_widths": ("iVAE", ((8, 8),), dict(latent_dim=3, invariances=["r"],
                                            hidden_dim_e=(96, 64, 32),
                                            hidden_dim_d=(64, 64))),
    "ved_2d_out": ("VED", ((8, 8), (16, 16)),
                   dict(latent_dim=2, hidden_dim_e=((16,), (32, 32)),
                        hidden_dim_d=((32,), (16, 16)))),
    "ved_3d_in": ("VED", ((8, 8, 8), (16,)),
                  dict(latent_dim=2, hidden_dim_e=((8,), (16, 16)))),
    "ivae_c3": ("iVAE", ((8, 8),), dict(latent_dim=2, invariances=["r"],
                                        channels=3)),
    "bn_ved": ("VED", ((8, 8), (16,)), dict(latent_dim=2, batchnorm=True)),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIPS))
def test_params_to_torch_equals_jax_and_round_trips(name):
    """With JAX's weights carried across, the port's reference-keyed
    state_dict is bitwise JAX's (keys, values and the BatchNorm counters),
    and ``torch_to_params`` gives the port's state_dict back bitwise."""
    model, args, kw = ROUND_TRIPS[name]
    jm = getattr(pv.models, model)(*args, **kw)
    tm = getattr(tmodels, model)(*args, device="cpu", **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    sd = interop.params_to_torch(tm)
    jsd = jinterop.params_to_torch(jm)
    assert sorted(sd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(sd[k], np.asarray(jsd[k]), err_msg=k)
        assert sd[k].dtype == np.asarray(jsd[k]).dtype, k
    params, stats = interop.torch_to_params(tm, sd)
    own = tm.nets.state_dict()
    assert sorted(params) == sorted(own)
    for k in own:
        np.testing.assert_array_equal(_np(params[k]), _np(own[k]), err_msg=k)
    if name == "bn_ved":
        assert sorted(stats) == sorted(tm.state)
    else:
        assert stats == {}


def test_quirk_pool_config_rejected():
    tm = tmodels.VED((8, 8), (16,), latent_dim=2, device="cpu",
                     hidden_dim_e=((8,), (16,)))
    with pytest.raises(ValueError, match="maxpool"):
        interop.params_to_torch(tm)


def test_custom_injected_net_rejected():
    class Enc(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(64, 6)

        def forward(self, x):
            h = self.lin(x)
            return h[:, :3], torch.nn.functional.softplus(h[:, 3:])

    tm = tmodels.iVAE((8, 8), latent_dim=2, invariances=["r"], device="cpu")
    tm.set_encoder(Enc())
    with pytest.raises(ValueError, match="custom injected nets"):
        interop.params_to_torch(tm)


def _ivae():
    return tmodels.iVAE((8, 8), latent_dim=2, invariances=["r"], device="cpu")


def test_missing_key_strict_raises():
    tm = _ivae()
    sd = interop.params_to_torch(tm)
    sd.pop("encoder_z.fc11.weight")
    with pytest.raises(KeyError, match="missing"):
        interop.torch_to_params(tm, sd)
    with pytest.raises(KeyError, match="missing"):
        tm.load_torch_weights(sd)
    # non-strict: skipped, the model's own value stays
    other = _ivae()
    other.load_torch_weights({k: v * 2 for k, v in sd.items()}, strict=False)
    own = _ivae().nets.state_dict()
    got = other.nets.state_dict()
    np.testing.assert_array_equal(_np(got["encoder_z.fc11.weight"]),
                                  _np(own["encoder_z.fc11.weight"]))
    np.testing.assert_array_equal(_np(got["decoder.out.bias"]),
                                  2 * _np(own["decoder.out.bias"]))


def test_extra_key_strict_raises():
    tm = _ivae()
    sd = interop.params_to_torch(tm)
    sd["decoder.bogus.weight"] = np.zeros((2, 2), np.float32)
    with pytest.raises(KeyError, match="extra"):
        interop.torch_to_params(tm, sd)
    interop.torch_to_params(tm, sd, strict=False)


def test_shape_mismatch_raises():
    tm = _ivae()
    other = tmodels.iVAE((8, 8), latent_dim=3, invariances=["r"],
                         device="cpu")
    sd = interop.params_to_torch(other)
    with pytest.raises(ValueError, match="shape"):
        interop.torch_to_params(tm, sd)
    with pytest.raises(ValueError, match="shape"):
        interop.torch_to_params(tm, sd, strict=False)


def test_batchnorm_stats_shape_mismatch_raises():
    tm = tmodels.VED((8, 8), (16,), latent_dim=2, batchnorm=True,
                     device="cpu")
    sd = interop.params_to_torch(tm)
    key = next(k for k in sd if k.endswith("running_mean"))
    sd[key] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        interop.torch_to_params(tm, sd)


def test_torch_load_rejects_code(tmp_path):
    """A pickled payload carrying arbitrary objects is refused by the
    ``weights_only`` load, in the port as in JAX, and not executed."""
    ran = []

    class Evil:
        def __reduce__(self):
            return (ran.append, ("ran",))

    path = tmp_path / "evil.pt"
    with open(path, "wb") as f:
        pickle.dump({"encoder_z.fc11.weight": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError):
        _ivae().load_torch_weights(str(path))
    with pytest.raises(pickle.UnpicklingError):
        pv.models.iVAE((8, 8), latent_dim=2,
                       invariances=["r"]).load_torch_weights(str(path))
    assert ran == []
