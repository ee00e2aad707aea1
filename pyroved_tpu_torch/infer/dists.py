"""Functional distributions for the ELBO.

Counterpart of ``pyroved_tpu/infer/dists.py``: elementwise log-densities
and samplers, no distribution objects. Samplers take an explicit
``torch.Generator``; they cannot reproduce JAX's random bits, so tests feed
both packages the same noise instead.
"""
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

_LOG_2PI = math.log(2.0 * math.pi)


def _randn_like(x: Tensor, generator: Optional[torch.Generator]) -> Tensor:
    # draw on the generator's device, then move: a CPU generator feeds CUDA
    gdev = generator.device if generator is not None else x.device
    return torch.randn(x.shape, generator=generator, dtype=x.dtype,
                       device=gdev).to(x.device)


def _rand_like(x: Tensor, generator: Optional[torch.Generator]) -> Tensor:
    gdev = generator.device if generator is not None else x.device
    return torch.rand(x.shape, generator=generator, dtype=x.dtype,
                      device=gdev).to(x.device)


# ---------------------------------------------------------------------------
# Normal
# ---------------------------------------------------------------------------

def normal_sample(loc: Tensor, scale: Tensor,
                  generator: Optional[torch.Generator] = None) -> Tensor:
    """Reparameterized draw ``z = loc + scale * eps``."""
    return loc + scale * _randn_like(loc, generator)


def normal_log_prob(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    z = (x - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - torch.log(scale)


def std_normal_log_prob(x: Tensor) -> Tensor:
    return -0.5 * (x * x + _LOG_2PI)


def normal_kl(loc: Tensor, scale: Tensor) -> Tensor:
    """Analytic KL( N(loc, scale) || N(0, 1) ), elementwise."""
    var = scale * scale
    return 0.5 * (var + loc * loc - 1.0) - torch.log(scale)


# ---------------------------------------------------------------------------
# Bernoulli (non-binary observations allowed)
# ---------------------------------------------------------------------------

_PROB_EPS = float(np.finfo(np.float32).eps)


def bernoulli_log_prob(x: Tensor, probs: Tensor) -> Tensor:
    # clamp to [eps, 1-eps] so a saturated sigmoid cannot give -inf; xlogy
    # handles the 0*log(0) corners
    probs = torch.clamp(probs, _PROB_EPS, 1.0 - _PROB_EPS)
    return torch.xlogy(x, probs) + torch.special.xlog1py(1.0 - x, -probs)


def _cb_log_norm(probs: Tensor) -> Tensor:
    """Log normalizing constant of the continuous Bernoulli,
    ``C(p) = 2 atanh(1-2p) / (1-2p)``, with a 4th-order Taylor expansion in
    the unstable window around p = 0.5."""
    unstable = torch.abs(probs - 0.5) < 1e-3
    safe_p = torch.where(unstable, torch.full_like(probs, 0.499), probs)
    x = 1.0 - 2.0 * safe_p
    direct = torch.log(torch.abs(2.0 * torch.atanh(x))) - torch.log(torch.abs(x))
    dp = probs - 0.5
    taylor = math.log(2.0) + (4.0 / 3.0) * dp ** 2 + (104.0 / 45.0) * dp ** 4
    return torch.where(unstable, taylor, direct)


def continuous_bernoulli_log_prob(x: Tensor, probs: Tensor) -> Tensor:
    probs = torch.clamp(probs, _PROB_EPS, 1.0 - _PROB_EPS)
    return bernoulli_log_prob(x, probs) + _cb_log_norm(probs)


def _continuous_bernoulli_sample(loc: Tensor, generator=None) -> Tensor:
    """Inverse-CDF draw; for p != 0.5,
    F^{-1}(u) = log(((2p-1)u + 1 - p) / (1 - p)) / log(p / (1-p))."""
    u = _rand_like(loc, generator)
    unstable = torch.abs(loc - 0.5) < 1e-4
    p = torch.where(unstable, torch.full_like(loc, 0.499), loc)
    x = (torch.log(((2.0 * p - 1.0) * u + 1.0 - p) / (1.0 - p))
         / (torch.log(p) - torch.log1p(-p)))
    return torch.where(unstable, u, x)


# ---------------------------------------------------------------------------
# Decoder observation samplers
# ---------------------------------------------------------------------------

class ObsModel(NamedTuple):
    """Decoder observation model: elementwise log-density and a sampler."""
    name: str
    log_prob: Callable  # (x, loc) -> elementwise log density
    sample: Callable    # (loc, generator=None) -> draw shaped like loc


def _gaussian_obs(decoder_sig: float) -> ObsModel:
    sig = float(decoder_sig)

    def log_prob(x, loc):
        return normal_log_prob(x, loc, torch.full_like(loc, sig))

    def sample(loc, generator=None):
        return loc + sig * _randn_like(loc, generator)

    return ObsModel("gaussian", log_prob, sample)


def _bernoulli_sample(loc: Tensor, generator=None) -> Tensor:
    return (_rand_like(loc, generator) < loc).to(loc.dtype)


_SAMPLERS = ("bernoulli", "continuous_bernoulli", "gaussian")


def get_sampler(sampler: str, **kwargs) -> ObsModel:
    """Observation model: 'bernoulli' | 'continuous_bernoulli' |
    'gaussian' (``decoder_sig`` defaults to 0.5)."""
    if sampler == "bernoulli":
        return ObsModel("bernoulli", bernoulli_log_prob, _bernoulli_sample)
    if sampler == "continuous_bernoulli":
        return ObsModel("continuous_bernoulli", continuous_bernoulli_log_prob,
                        _continuous_bernoulli_sample)
    if sampler == "gaussian":
        return _gaussian_obs(kwargs.get("decoder_sig", 0.5))
    raise KeyError(
        f"Select between the following decoder samplers: {list(_SAMPLERS)}")
