"""The package's former import name is an alias of ``mcmc_jl``.

The alias is the one package beside ``mcmc_jl`` whose name extends it
(README, first section)."""
import importlib
import pathlib

import pytest

import mcmc_jl

ROOT = pathlib.Path(__file__).resolve().parents[1]
[ALIAS] = [p.parent.name for p in ROOT.glob("mcmc_jl_*/__init__.py")]


@pytest.mark.parametrize("sub", ["", ".samplers.hmc", ".ops.pallas_glm",
                                 ".parallel.pchains"])
def test_former_name_is_the_same_module(sub):
    old = importlib.import_module(ALIAS + sub)
    assert old is importlib.import_module("mcmc_jl" + sub)


def test_former_name_attribute_access():
    old = importlib.import_module(ALIAS)
    hmc = importlib.import_module(ALIAS + ".samplers.hmc")
    assert old.HMC is mcmc_jl.HMC is hmc.HMC
    assert old.samplers.hmc is hmc
