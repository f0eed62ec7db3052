"""The package's former import name, kept as an alias of :mod:`mcmc_jl`.

Importing it imports ``mcmc_jl`` and all of its submodules and registers
each under this name as well, so that old imports, dotted or not, get the
very same module objects as the new name."""
import importlib
import pkgutil
import sys

import mcmc_jl

for _info in pkgutil.walk_packages(mcmc_jl.__path__, "mcmc_jl."):
    importlib.import_module(_info.name)
for _name, _mod in list(sys.modules.items()):
    if _name.startswith("mcmc_jl."):
        sys.modules[__name__ + _name[len("mcmc_jl"):]] = _mod
sys.modules[__name__] = mcmc_jl
