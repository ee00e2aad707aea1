"""The port's public surface against the JAX package's, module by module
(modelled on ``tests/test_api_surface.py``): for every module of
``pyroved_tpu`` its public names (``__all__`` where it has one, else the
functions and classes it defines), each public class's public methods and
each public function's and method's parameter names must exist at the same
dotted path of ``pyroved_tpu_torch``. The port may add names and
parameters. What it leaves out on purpose is the written list below, each
entry with its reason, as ``ROADMAP.md`` section 1.1 keeps it."""
import dataclasses
import importlib
import inspect
import pkgutil

import flax.linen as fnn
import pytest

import pyroved_tpu

# -- the written exclusions (ROADMAP.md section 1.1) -----------------------
TPU_ROUTING = ("measured on a TPU: the port routes by configuration alone "
               "(sdecoder_supports_fusion)")
#: names of a module the port does not have
NAMES = {
    "ops.spatial_decoder.KernelTuning": TPU_ROUTING,
    "ops.spatial_decoder.fused_profitable": TPU_ROUTING,
    "ops.spatial_decoder.calibrate": TPU_ROUTING,
    "ops.spatial_decoder.sdecoder_needs_padding": TPU_ROUTING,
    "native.get_lib": "the JAX package's C++ library; the port is numpy",
}
#: methods the port's classes do not have, by the JAX function's qualname
METHODS = {
    "baseVAE.next_rng": "JAX's key chain; the port draws from torch "
                        "Generators",
}
PYTREE = ("the port takes the model or its tensors where the JAX package "
          "takes a parameter pytree or a batch tuple")
#: parameters the port does not take, by function or method name
PARAMS = {
    "loss_fn": ({"params", "rng", "batch"}, PYTREE),
    "weighted_loss_fn": ({"params", "rng", "batch"}, PYTREE),
    "aux_loss_fn": ({"params", "rng", "batch"}, PYTREE),
    "trace": ({"params", "rng", "batch"}, PYTREE),
    "sync_fusion_gate": ({"params"}, PYTREE),
    "apply_fused_sdecoder": ({"dec_params"}, PYTREE),
    "apply_fused_recon_loss": ({"dec_params"}, PYTREE),
    "replicate_params": ({"params"}, PYTREE),
    "tensor_parallel_params": ({"params"}, PYTREE),
    "quantize_params": ({"params"}, PYTREE),
    "dequantize_params": ({"qparams"}, PYTREE),
    "export_model": ({"platforms"}, "XLA's export platforms; an archive "
                     "serves on whatever device loads it"),
}
#: JAX parameters the port takes under another name
RENAMED = {"rng": "generator"}  # JAX keys become torch Generators
#: flax module fields the port's torch modules do not take
FIELDS = {
    "Dense": ({"features", "use_bias"}, "an nn.Linear: in_features, "
              "out_features, bias"),
    "sDecoderNet": ({"out_dim"}, "the data shape, unused by the decoder; "
                    "torch modules take their input widths instead"),
}

MODULES = sorted(m.name for m in pkgutil.walk_packages(
    pyroved_tpu.__path__, "pyroved_tpu."))


def _modules(name):
    return (importlib.import_module(name),
            importlib.import_module(name.replace("pyroved_tpu",
                                                 "pyroved_tpu_torch", 1)))


def _rel(name):
    return name.split(".", 1)[1] if "." in name else ""


def _public(mod):
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and (inspect.isclass(v)
                                          or inspect.isfunction(v))
            and getattr(v, "__module__", None) == mod.__name__]


def _params(f):
    try:
        return [p for p in inspect.signature(f).parameters
                if p not in ("self", "cls")]
    except (TypeError, ValueError):
        return None


def _missing_params(name, jf, tf):
    jp, tp = _params(jf), _params(tf)
    if jp is None or tp is None:
        return []
    skip = PARAMS.get(name, (set(), ""))[0]
    return [p for p in jp if p not in skip and RENAMED.get(p, p) not in tp
            and p not in ("args", "kwargs")]


def _methods(cls):
    return sorted(n for n in dir(cls) if not n.startswith("_")
                  and inspect.isfunction(getattr(cls, n, None)))


def _jax_classes(mod):
    for n in _public(mod):
        v = getattr(mod, n, None)
        if inspect.isclass(v) and v.__module__.startswith("pyroved_tpu"):
            yield n, v


def test_every_module_has_a_counterpart():
    missing = []
    for name in MODULES:
        try:
            _modules(name)
        except ImportError as e:
            missing.append(f"{name}: {e}")
    assert not missing, missing


@pytest.mark.parametrize("name", MODULES)
def test_public_names(name):
    jm, tm = _modules(name)
    missing = [n for n in _public(jm) if not hasattr(tm, n)
               and f"{_rel(name)}.{n}" not in NAMES]
    assert not missing, f"{name}: {missing}"


@pytest.mark.parametrize("name", MODULES)
def test_function_parameters(name):
    jm, tm = _modules(name)
    bad = {}
    for n in _public(jm):
        jf = getattr(jm, n, None)
        if inspect.isfunction(jf) and hasattr(tm, n):
            miss = _missing_params(n, jf, getattr(tm, n))
            if miss:
                bad[n] = miss
    assert not bad, f"{name}: {bad}"


@pytest.mark.parametrize("name", MODULES)
def test_class_methods_and_parameters(name):
    jm, tm = _modules(name)
    bad = {}
    for n, jc in _jax_classes(jm):
        tc = getattr(tm, n, None)
        if tc is None:
            continue  # test_public_names reports it
        if issubclass(jc, fnn.Module):  # flax fields -> __init__ params
            skip = FIELDS.get(n, (set(), ""))[0]
            tp = _params(tc.__init__) or []
            miss = [f.name for f in dataclasses.fields(jc)
                    if f.name not in ("parent", "name") and f.name not in skip
                    and f.name not in tp]
            if miss:
                bad[n] = miss
            continue
        for m in _methods(jc):
            jf = getattr(jc, m)
            if jf.__qualname__ in METHODS:
                continue
            tf = getattr(tc, m, None)
            if not callable(tf):
                bad[f"{n}.{m}"] = "missing"
                continue
            miss = _missing_params(m, jf, tf)
            if miss:
                bad[f"{n}.{m}"] = miss
        miss = _missing_params("__init__", jc.__init__, tc.__init__)
        if miss:
            bad[f"{n}.__init__"] = miss
    assert not bad, f"{name}: {bad}"


def test_exclusions_are_still_needed():
    """Every written exclusion names something the JAX package has and the
    port lacks, so the list cannot outlive what it excuses."""
    for path in NAMES:
        mod, n = path.rsplit(".", 1)
        jm, tm = _modules(f"pyroved_tpu.{mod}")
        assert hasattr(jm, n) and not hasattr(tm, n), path
    import pyroved_tpu.models as jmodels
    import pyroved_tpu_torch.models as tmodels
    assert hasattr(jmodels.base.baseVAE, "next_rng")
    assert not hasattr(tmodels.base.baseVAE, "next_rng")
