"""Typed dataclass configuration.

Counterpart of ``pyroved_tpu/config.py``, with the same dataclasses,
fields, defaults and errors: every model has a frozen config whose fields
are validated when it is made, and ``build()`` constructs the port's model.
A misspelled field is a ``TypeError``; a value off its menu a
``ValueError``. ``extra`` passes further model keywords through (``fused``,
``one_pass_train``, ``num_particles``, ``approx_tanh``, ...). The one
addition is ``build(device=None)``: None means ``"cuda"``, as for every
entry point of the port, and ``device="cpu"`` builds on the CPU.
"""
from dataclasses import asdict, dataclass
from typing import Optional, Tuple, Union

from . import models
from .utils.nn import _ACTIVATIONS

# the activation menu is the port's own registry (utils/nn.py)
_ACTIVATION_MENU = tuple(_ACTIVATIONS)


def _clean(cfg, skip=("extra",)):
    d = {k: v for k, v in asdict(cfg).items() if k not in skip}
    d.update(cfg.extra or {})
    return d


def _family_kwargs(cfg) -> dict:
    """The keywords of a discrete-latent or semi-supervised family: no
    ``c_dim``, and ``enum_topk`` and ``dy_prior`` only when set."""
    kw = _clean(cfg)
    kw.pop("c_dim", None)
    if not kw.get("enum_topk"):
        kw.pop("enum_topk", None)
    if kw.get("dy_prior") is None:
        kw.pop("dy_prior", None)
    return kw


@dataclass(frozen=True)
class iVAEConfig:
    data_dim: Tuple[int, ...]
    latent_dim: int = 2
    invariances: Optional[Tuple[str, ...]] = None
    c_dim: int = 0
    hidden_dim_e: Optional[Tuple[int, ...]] = None
    hidden_dim_d: Optional[Tuple[int, ...]] = None
    activation: str = "tanh"
    sampler_d: str = "bernoulli"
    sigmoid_d: bool = True
    seed: int = 1
    dx_prior: float = 0.1
    dy_prior: Optional[float] = None
    sc_prior: float = 0.1
    decoder_sig: float = 0.5
    kl: str = "mc"
    fused: bool = True
    channels: int = 1
    # the training-path recon over this many grid tiles (spatial models
    # only; 0 = off)
    pixel_chunks: int = 0
    extra: Optional[dict] = None

    def __post_init__(self):
        _validate_invariances(self.data_dim, self.invariances)
        _validate_choice("activation", self.activation, _ACTIVATION_MENU)
        _validate_choice("sampler_d", self.sampler_d,
                         ("bernoulli", "continuous_bernoulli", "gaussian"))
        _validate_choice("kl", self.kl, ("mc", "analytic"))
        if self.channels < 1:
            raise ValueError(f"channels must be >= 1, got {self.channels}")
        if self.pixel_chunks < 0:
            raise ValueError(
                f"pixel_chunks must be >= 0, got {self.pixel_chunks}")
        if self.pixel_chunks and not self.invariances:
            raise ValueError(
                "pixel_chunks requires a spatial decoder (invariances=...)")

    def build(self, device=None) -> "models.iVAE":
        kw = _clean(self)
        if kw.get("dy_prior") is None:
            kw.pop("dy_prior", None)
        return models.iVAE(**kw, device=device)


@dataclass(frozen=True)
class jiVAEConfig(iVAEConfig):
    discrete_dim: int = 2
    enum_topk: int = 0

    def __post_init__(self):
        super().__post_init__()
        _validate_enum_topk(self.enum_topk, self.discrete_dim, "discrete_dim")

    def build(self, device=None) -> "models.jiVAE":
        return models.jiVAE(**_family_kwargs(self), device=device)


@dataclass(frozen=True)
class ssiVAEConfig(iVAEConfig):
    num_classes: int = 2
    hidden_dim_cls: Optional[Tuple[int, ...]] = None
    enum_topk: int = 0

    def __post_init__(self):
        super().__post_init__()
        _validate_enum_topk(self.enum_topk, self.num_classes, "num_classes")

    def build(self, device=None) -> "models.ssiVAE":
        return models.ssiVAE(**_family_kwargs(self), device=device)


@dataclass(frozen=True)
class ssRegiVAEConfig(iVAEConfig):
    reg_dim: int = 1
    hidden_dim_reg: Optional[Tuple[int, ...]] = None
    regressor_sig: float = 0.5

    def build(self, device=None) -> "models.ss_reg_iVAE":
        return models.ss_reg_iVAE(**_family_kwargs(self), device=device)


@dataclass(frozen=True)
class VEDConfig:
    input_dim: Tuple[int, ...]
    output_dim: Tuple[int, ...]
    input_channels: int = 1
    output_channels: int = 1
    latent_dim: int = 2
    hidden_dim_e: Optional[Tuple[Tuple[int, ...], ...]] = None
    hidden_dim_d: Optional[Tuple[Tuple[int, ...], ...]] = None
    activation: str = "lrelu"
    batchnorm: bool = False
    sampler_d: str = "bernoulli"
    sigmoid_d: bool = True
    seed: int = 1
    decoder_sig: float = 0.5
    kl: str = "mc"
    compute_dtype: str = "float32"
    pool: str = "max"
    extra: Optional[dict] = None

    def __post_init__(self):
        _validate_choice("activation", self.activation, _ACTIVATION_MENU)
        _validate_choice("sampler_d", self.sampler_d,
                         ("bernoulli", "continuous_bernoulli", "gaussian"))
        _validate_choice("kl", self.kl, ("mc", "analytic"))
        _validate_choice("compute_dtype", self.compute_dtype,
                         ("float32", "bfloat16"))
        _validate_choice("pool", self.pool, ("max", "avg", "stride"))

    def build(self, device=None) -> "models.VED":
        return models.VED(**_clean(self), device=device)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    epochs: int = 100
    batch_size: int = 100
    scale_factor: float = 1.0
    seed: int = 1
    grad_accum: int = 1  # gradient accumulation (both trainers)
    patience: Optional[int] = None  # early stop (requires test_data)
    min_delta: float = 0.0
    # exact enumeration for the first N epochs (or "auto": until the guide
    # concentrates), then the model's enum_topk truncation (discrete-latent
    # models; the trainers' run(enum_schedule=))
    enum_schedule: Optional[Union[int, str]] = None

    def __post_init__(self):
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")
        if self.patience is not None and self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if self.enum_schedule is not None:
            if isinstance(self.enum_schedule, str):
                if self.enum_schedule != "auto":
                    raise ValueError(
                        f'enum_schedule accepts an epoch count or "auto", '
                        f"got {self.enum_schedule!r}")
            elif self.enum_schedule < 0:
                raise ValueError(
                    f"enum_schedule must be >= 0, got {self.enum_schedule}")


def _validate_invariances(data_dim, invariances):
    if invariances is None:
        return
    valid = {"r", "t", "s"}
    if not set(invariances) <= valid:
        raise ValueError(f"invariances must be a subset of {valid}, got {invariances}")
    if len(data_dim) == 1 and list(invariances) != ["t"]:
        raise ValueError("For 1D data, the only invariance to enforce is translation ('t')")


def _validate_choice(name, value, choices):
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")


def _validate_enum_topk(enum_topk, num_branches, bound_name):
    # the models check it too; here a bad job file fails when it is parsed
    if enum_topk and not 1 <= enum_topk <= num_branches:
        raise ValueError(
            f"enum_topk must be 0 (exact) or in [1, {bound_name}="
            f"{num_branches}], got {enum_topk}")
