"""The port's typed configs (``pyroved_tpu_torch/config.py``) against the
JAX package's (``pyroved_tpu/config.py``): the same fields and defaults,
the same configs accepted and rejected with the same exception types, and
each accepted config's built model holding the keys and shapes of the
JAX model's parameters carried across (``from_jax_params``)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from pyroved_tpu import config as jconfig
from pyroved_tpu_torch import config as tconfig
from pyroved_tpu_torch.ops import spatial_decoder as tsd
from pyroved_tpu_torch.weights import from_jax_params

CLASSES = ("iVAEConfig", "jiVAEConfig", "ssiVAEConfig", "ssRegiVAEConfig",
           "VEDConfig", "TrainConfig")

SMALL = dict(hidden_dim_e=(16,), hidden_dim_d=(16,))
VED_SMALL = dict(hidden_dim_e=((4,), (8,)), hidden_dim_d=((8,), (4,)))

# (config class, keywords, the exception both packages raise or None)
TABLE = [
    # iVAE
    ("iVAEConfig", dict(data_dim=(8, 8)), None),
    ("iVAEConfig", dict(data_dim=(8, 8), latent_dim=3, invariances=("r", "t"),
                        dx_prior=0.2, **SMALL), None),
    ("iVAEConfig", dict(data_dim=(8, 8), invariances=("r", "t", "s"),
                        dy_prior=0.3, sc_prior=0.2, **SMALL), None),
    ("iVAEConfig", dict(data_dim=(24,), invariances=("t",), **SMALL), None),
    ("iVAEConfig", dict(data_dim=(8, 8), c_dim=3, **SMALL), None),
    ("iVAEConfig", dict(data_dim=(8, 8), invariances=("r",), channels=3,
                        **SMALL), None),
    ("iVAEConfig", dict(data_dim=(8, 8), invariances=("r",), pixel_chunks=4,
                        **SMALL), None),
    ("iVAEConfig", dict(data_dim=(8, 8), activation="gelu",
                        sampler_d="gaussian", decoder_sig=0.3, kl="analytic",
                        **SMALL), None),
    ("iVAEConfig", dict(data_dim=(8, 8), activation="relu",
                        sampler_d="continuous_bernoulli", sigmoid_d=False,
                        hidden_dim_e=(32, 16), hidden_dim_d=(16, 16, 16)),
     None),
    ("iVAEConfig", dict(data_dim=(8, 8), invariances=("r",), fused=False,
                        activation="softplus", seed=7, **SMALL), None),
    ("iVAEConfig", dict(data_dim=(8, 8), invariances=("r",), activation="lrelu",
                        extra={"one_pass_train": True}, **SMALL), None),
    ("iVAEConfig", dict(data_dim=(16,), invariances=("r",)), ValueError),
    ("iVAEConfig", dict(data_dim=(8, 8), invariances=("q",)), ValueError),
    ("iVAEConfig", dict(data_dim=(8, 8), activation="swish"), ValueError),
    ("iVAEConfig", dict(data_dim=(8, 8), sampler_d="poisson"), ValueError),
    ("iVAEConfig", dict(data_dim=(8, 8), kl="exact"), ValueError),
    ("iVAEConfig", dict(data_dim=(8, 8), cord=1), TypeError),
    ("iVAEConfig", dict(data_dim=(8, 8), channels=0), ValueError),
    ("iVAEConfig", dict(data_dim=(8, 8), pixel_chunks=2), ValueError),
    ("iVAEConfig", dict(data_dim=(8, 8), invariances=("r",), pixel_chunks=-1),
     ValueError),
    ("iVAEConfig", dict(latent_dim=2), TypeError),
    # jiVAE
    ("jiVAEConfig", dict(data_dim=(8, 8), discrete_dim=3, invariances=("r",),
                         **SMALL), None),
    ("jiVAEConfig", dict(data_dim=(8, 8), discrete_dim=5, enum_topk=2,
                         **SMALL), None),
    ("jiVAEConfig", dict(data_dim=(8, 8), discrete_dim=3, invariances=("r",),
                         pixel_chunks=3, **SMALL), None),
    ("jiVAEConfig", dict(data_dim=(8, 8), discrete_dim=3, enum_topk=4),
     ValueError),
    ("jiVAEConfig", dict(data_dim=(8, 8), discrete_dim=3, kl="exact"),
     ValueError),
    # ssiVAE
    ("ssiVAEConfig", dict(data_dim=(8, 8), num_classes=4, **SMALL), None),
    ("ssiVAEConfig", dict(data_dim=(8, 8), num_classes=4, enum_topk=3,
                          invariances=("r",), hidden_dim_cls=(8, 8), **SMALL),
     None),
    ("ssiVAEConfig", dict(data_dim=(8, 8), num_classes=3, invariances=("r",),
                          pixel_chunks=2, **SMALL), None),
    ("ssiVAEConfig", dict(data_dim=(8, 8), num_classes=3, enum_topk=-1),
     ValueError),
    ("ssiVAEConfig", dict(data_dim=(8, 8), num_classes=3, classes=3),
     TypeError),
    # ss_reg_iVAE
    ("ssRegiVAEConfig", dict(data_dim=(8, 8), reg_dim=2, regressor_sig=0.2,
                             **SMALL), None),
    ("ssRegiVAEConfig", dict(data_dim=(8, 8), reg_dim=1, invariances=("t",),
                             hidden_dim_reg=(8,), **SMALL), None),
    ("ssRegiVAEConfig", dict(data_dim=(8, 8), reg_dim=1,
                             invariances=("t", "x")), ValueError),
    # VED
    ("VEDConfig", dict(input_dim=(16, 16), output_dim=(32,), **VED_SMALL),
     None),
    ("VEDConfig", dict(input_dim=(32,), output_dim=(16, 16), batchnorm=True,
                       latent_dim=3, activation="tanh", **VED_SMALL), None),
    ("VEDConfig", dict(input_dim=(16, 16), output_dim=(16, 16),
                       input_channels=2, output_channels=3,
                       compute_dtype="bfloat16", pool="avg", **VED_SMALL),
     None),
    ("VEDConfig", dict(input_dim=(16, 16), output_dim=(32,), pool="stride",
                       sampler_d="gaussian", **VED_SMALL), None),
    ("VEDConfig", dict(input_dim=(16, 16), output_dim=(32,),
                       compute_dtype="float16"), ValueError),
    ("VEDConfig", dict(input_dim=(16, 16), output_dim=(32,), pool="min"),
     ValueError),
    ("VEDConfig", dict(input_dim=(16, 16), output_dim=(32,),
                       activation="swish"), ValueError),
    ("VEDConfig", dict(input_dim=(16, 16)), TypeError),
    # training
    ("TrainConfig", dict(), None),
    ("TrainConfig", dict(lr=5e-4, epochs=3, batch_size=32, scale_factor=2.0,
                         seed=4, grad_accum=2, patience=3, min_delta=0.1),
     None),
    ("TrainConfig", dict(enum_schedule=5), None),
    ("TrainConfig", dict(enum_schedule="auto"), None),
    ("TrainConfig", dict(grad_accum=0), ValueError),
    ("TrainConfig", dict(patience=0), ValueError),
    ("TrainConfig", dict(enum_schedule=-1), ValueError),
    ("TrainConfig", dict(enum_schedule="sometimes"), ValueError),
    ("TrainConfig", dict(epoch=5), TypeError),
]


@pytest.fixture(autouse=True, scope="module")
def f32_port():
    """The port's hidden products in f32, as the JAX package's CPU path
    computes them, for the whole module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsd, "BF16_MATMUL", False)
        yield


def _make(module, cls, kw):
    """(config, None) or (None, the exception it raised)."""
    try:
        return getattr(module, cls)(**kw), None
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return None, e


@pytest.mark.parametrize("cls", CLASSES)
def test_fields_and_defaults_equal_jax(cls):
    def spec(module):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(getattr(module, cls))]

    assert spec(tconfig) == spec(jconfig)


@pytest.mark.parametrize("case", range(len(TABLE)),
                         ids=[f"{c}-{i}" for i, (c, _, _) in enumerate(TABLE)])
def test_accepted_and_rejected_as_jax(case):
    cls, kw, expected = TABLE[case]
    jcfg, jerr = _make(jconfig, cls, kw)
    tcfg, terr = _make(tconfig, cls, kw)
    assert type(jerr) is type(terr), (jerr, terr)
    if expected is not None:
        assert isinstance(terr, expected), terr
        assert str(terr) == str(jerr)
        return
    assert terr is None
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if cls == "TrainConfig":
        return
    jm = jcfg.build()
    tm = tcfg.build(device="cpu")
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))
    got = tm.nets.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert tm.z_dim == jm.z_dim
    assert tm.device == torch.device("cpu")
    tm.load_jax_params(jax.tree_util.tree_map(np.asarray, jm.params))


def test_built_models_carry_the_settings():
    """The typed fields and ``extra`` reach the port's model, as the JAX
    package's tests check them there."""
    m = tconfig.iVAEConfig(data_dim=(8, 8), latent_dim=3,
                           invariances=("r", "t"), dx_prior=0.2).build("cpu")
    assert m.z_dim == 6 and float(m.t_prior[0]) == pytest.approx(0.2)
    m = tconfig.jiVAEConfig(data_dim=(8, 8), discrete_dim=5,
                            enum_topk=2).build("cpu")
    assert m.discrete_dim == 5 and m.enum_topk == 2
    assert tconfig.jiVAEConfig(data_dim=(8, 8)).build("cpu").enum_topk == 0
    m = tconfig.ssRegiVAEConfig(data_dim=(8, 8), reg_dim=2,
                                regressor_sig=0.2).build("cpu")
    assert m.reg_dim == 2 and m.reg_sig == pytest.approx(0.2)
    m = tconfig.ssiVAEConfig(data_dim=(8, 8), num_classes=3,
                             invariances=("r",), pixel_chunks=2).build("cpu")
    assert m.pixel_chunks == 2 and m._pixel_mode() == "chunk"
    m = tconfig.iVAEConfig(data_dim=(8, 8), invariances=("r",),
                           extra={"one_pass_train": True,
                                  "num_particles": 2}).build("cpu")
    assert m.one_pass_train and m.num_particles == 2 and m._fused
    assert not tconfig.iVAEConfig(data_dim=(8, 8), invariances=("r",),
                                  fused=False).build("cpu")._fused
    m = tconfig.VEDConfig(input_dim=(16, 16), output_dim=(32,), batchnorm=True,
                          **VED_SMALL).build("cpu")
    assert m.batchnorm and not m.use_running_stats and m.state
    with pytest.raises(TypeError, match="unsupported keywords"):
        tconfig.iVAEConfig(data_dim=(8, 8),
                           extra={"no_such_option": 1}).build("cpu")


def test_build_needs_a_card_unless_told():
    """``build()`` defaults to the card, as every entry point of the port,
    and raises without one instead of running on the CPU."""
    cfg = tconfig.iVAEConfig(data_dim=(8, 8))
    if torch.cuda.is_available():
        assert cfg.build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cfg.build()
