"""The discrete-latent and semi-supervised families at more configurations
than ``test_torch_port_families.py``'s one (12x12, ['r'], tanh, Bernoulli,
hidden (128, 128), one particle, MC KL): each setting below changes it in
one way, and jiVAE, ssiVAE and ss_reg_iVAE are held against the JAX
package on the same weights, inputs and noise, on the CPU. A file of its
own so that each file stays within about a minute.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pyroved_tpu.models as jmodels
import pyroved_tpu.ops.spatial_decoder as sd
import pyroved_tpu_torch.models as tmodels
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.utils.nn import as_numpy
from test_torch_port_families import (B, DATA, K, LOSS_RTOL, W, _check_grads,
                                      _grads, _t)


@pytest.fixture(autouse=True, scope="module")
def f32_both():
    """Both packages' hidden products in f32 for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        mp.setattr(sd, "BF16_MATMUL", False)
        yield


# Each setting changes the flagship-like configuration above in one way.
# (data_dim, model keywords); the port takes its kernel path wherever the
# configuration supports one (gelu at (96, 160) pads to 256; no invariances
# and relu at 3 layers go to the module path).
SETTINGS = {
    "rts_priors": (DATA, dict(invariances=["r", "t", "s"], dx_prior=0.2,
                              dy_prior=0.15, sc_prior=0.3)),
    "particles2": (DATA, dict(invariances=["r"], num_particles=2)),
    "analytic_kl": (DATA, dict(invariances=["r"], kl="analytic")),
    "gaussian": (DATA, dict(invariances=["r"], sampler_d="gaussian",
                            decoder_sig=0.3)),
    "cont_bernoulli": (DATA, dict(invariances=["r"],
                                  sampler_d="continuous_bernoulli")),
    "gelu_96_160": (DATA, dict(invariances=["r"], activation="gelu",
                               hidden_dim_e=[96, 160],
                               hidden_dim_d=[96, 160])),
    "relu_3_layers": (DATA, dict(invariances=["r"], activation="relu",
                                 hidden_dim_d=[128, 128, 128])),
    "no_invariances": (DATA, dict(invariances=None)),
    "1d_t": ((40,), dict(invariances=["t"])),
    "channels2": (DATA, dict(invariances=["r"], channels=2)),
}
FAMILY_ARGS = {"jiVAE": dict(latent_dim=2, discrete_dim=K),
               "ssiVAE": dict(latent_dim=2, num_classes=K),
               "ss_reg_iVAE": dict(latent_dim=2, reg_dim=1)}
# The continuous Bernoulli's per-example losses sit near zero (|loss| 0.02
# to 1.2 in the reviewer probe, absolute error <= 3.1e-6), where a relative
# bound means nothing: they are held to an absolute one as well.
CB_LOSS_ATOL = 2e-5


@pytest.mark.parametrize("family", list(FAMILY_ARGS))
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_families_match_jax_across_settings(setting, family):
    """An unlabeled batch of each family (jiVAE's exact enumeration,
    ssiVAE's every class enumerated, ss_reg_iVAE's label noise drawn) at
    each setting: per-example losses and grads. The JAX side runs its
    module path under ``jax.jit`` (its fused path equals it in f32, as the
    JAX package's own tests hold); the port runs its kernel path's plain
    versions wherever the configuration supports them."""
    data_dim, kw = SETTINGS[setting]
    kw = dict(kw, **FAMILY_ARGS[family])
    jm = getattr(jmodels, family)(data_dim, seed=3, **kw)
    jm._fused = False
    tm = getattr(tmodels, family)(data_dim, device="cpu", **kw)
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    shape = (B,) + data_dim + ((2,) if kw.get("channels") == 2 else ())
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    batch = (jnp.asarray(x),)
    key = jax.random.PRNGKey(4)
    beta = (jnp.asarray([0.7, 1.3], jnp.float32) if family == "jiVAE"
            else jnp.float32(0.8))
    shapes = tm.noise_shapes(B)
    if family == "ss_reg_iVAE":
        keys = jax.random.split(key)
        eps = tuple(_t(jax.random.normal(k, s)) for k, s in zip(keys, shapes))
    else:
        eps = _t(jax.random.normal(key, shapes[0]))
    def weighted(p):
        per = jm.loss_fn(p, key, batch, beta)
        return jnp.sum(per * W), per

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(weighted, has_aux=True))(
        jm.params)
    tm.nets.zero_grad(set_to_none=True)
    per = tm.loss_fn(_t(x), None, _t(np.asarray(beta)), eps=eps)
    torch.sum(per * _t(W)).backward()
    atol = CB_LOSS_ATOL if setting == "cont_bernoulli" else 0.0
    np.testing.assert_allclose(as_numpy(per), np.asarray(ref),
                               rtol=LOSS_RTOL, atol=atol)
    _check_grads(_grads(tm), ref_grads)
