"""Chain result type.

Batched analog of ``MCMCChain`` (reference: src/MCMC.jl:58-80): the kept
samples/gradients live in named :class:`~mcmc_jl.utils.table.Table`
columns (DataFrame role), per-step sampler diagnostics become stacked arrays
(the scan ys), and the *task* carries an explicit sampler-state pytree so
``resume`` continues bit-exactly — strictly stronger than the reference,
whose ``resume_serialmc`` re-spins a fresh coroutine and silently drops
adaptive tuner state (SerialMC.jl:93-97, SURVEY §5).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..utils.table import Table


@dataclasses.dataclass
class MCMCChain:
    range: range  # kept 1-based step indices (reference Range)
    samples: Table
    gradients: Table
    diagnostics: dict
    task: Any  # MCMCTask or list of MCMCTask
    run_time: float = float("nan")

    def __post_init__(self):
        if not self.gradients.empty:
            assert self.samples.shape == self.gradients.shape, (
                "samples and gradients must have the same number of rows and columns"
            )

    @property
    def nrow(self):
        return self.samples.nrow

    @property
    def ncol(self):
        return self.samples.ncol

    # -- stats conveniences (delegate to the stats layer) ------------------
    def mean(self, *a, **k):
        from ..stats import mean

        return mean(self, *a, **k)

    def var(self, *a, **k):
        from ..stats import var

        return var(self, *a, **k)

    def ess(self, *a, **k):
        from ..stats import ess

        return ess(self, *a, **k)

    def actime(self, *a, **k):
        from ..stats import actime

        return actime(self, *a, **k)

    def acceptance(self, *a, **k):
        from ..stats import acceptance

        return acceptance(self, *a, **k)

    def describe(self, *a, **k):
        from ..stats import describe

        return describe(self, *a, **k)

    def __repr__(self):
        return (
            f"{self.ncol} parameters, {self.nrow} samples (per parameter), "
            f"{round(self.run_time, 1)} sec."
        )
