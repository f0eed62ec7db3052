"""Benchmark harness (reference: benchmarks/run_all.jl).

Runs every unit in ``benchunits/`` and appends one row per metric to
``benchlog.csv`` (listed in .gitignore) with timestamp, git hash, platform
and device info — the same log-accumulation scheme as the reference
(run_all.jl:17-38).  A number from a CPU run is a CPU number: the device
column says which.

Usage: python benchmarks/run_all.py [--platform cpu|gpu|default]
                                    [--only name1,name2]
"""
import csv
import datetime
import importlib.util
import os
import pathlib
import platform
import subprocess
import sys

HERE = pathlib.Path(__file__).parent


def git_hash():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=HERE,
        ).stdout.strip()
    except Exception:
        return "unknown"


def main():
    sys.path.insert(0, str(HERE.parent))
    if "--platform" in sys.argv:
        plat = sys.argv[sys.argv.index("--platform") + 1]
        if plat == "cpu":
            # virtual 8-device mesh so the scaling unit measures
            # multi-device efficiency; XLA_FLAGS is read when the backend
            # starts, which has not happened yet
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=8")
        if plat != "default":
            os.environ["JAX_PLATFORMS"] = plat
    import jax

    from mcmc_jl.utils.cache import enable_compile_cache

    enable_compile_cache()

    rows = []
    meta = {
        "time": datetime.datetime.now().isoformat(timespec="seconds"),
        "git": git_hash(),
        "os": platform.system(),
        "device": str(jax.devices()[0]),
        "ncores": os.cpu_count(),
    }
    only = None
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")
    for unit in sorted((HERE / "benchunits").glob("*.py")):
        if only is not None and unit.stem not in only:
            continue
        spec = importlib.util.spec_from_file_location(unit.stem, unit)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for name, value, unit_str in mod.run():
            print(f"{name:55s} {value:12.4g} {unit_str}")
            rows.append({**meta, "name": name, "value": value, "unit": unit_str})

    log = HERE / "benchlog.csv"
    write_header = not log.exists()
    with open(log, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        if write_header:
            w.writeheader()
        w.writerows(rows)
    print(f"appended {len(rows)} rows to {log}")


if __name__ == "__main__":
    main()
