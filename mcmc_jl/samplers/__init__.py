"""Sampler zoo (reference: src/samplers/ — 13 kernels, SURVEY §2.3).

Every sampler is a pure transition kernel ``step(model, ctx, state, key) ->
(state, info)`` over an explicit state pytree — the batched replacement for the
reference's coroutine ``SamplerTask`` generators.
"""
from .base import EmpMCTuner, RunCtx, Sampler
from .rwm import RWM
from .imh import IMH
from .ram import RAM
from .mala import MALA
from .barker import Barker
from .hmc import HMC
from .hmcda import HMCDA
from .nuts import NUTS
from .walnuts import WALNUTS
from .chees import ChEESHMC
from .smmala import SMMALA
from .pmala import PMALA
from .rmhmc import RMHMC
from .lagrangian import ERMLMC, RMLMC
from .slice import slice_sample

__all__ = [
    "Sampler", "RunCtx", "EmpMCTuner",
    "RWM", "IMH", "RAM", "MALA", "Barker", "HMC", "HMCDA", "NUTS", "WALNUTS", "ChEESHMC",
    "SMMALA", "PMALA", "RMHMC", "ERMLMC", "RMLMC", "slice_sample",
]
