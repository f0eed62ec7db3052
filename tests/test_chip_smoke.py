"""chip_smoke.py and bench.py measure a GPU: without one they exit nonzero
and print no result.  Also the smoke test's pure helpers."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def _no_result(out):
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and obj.get("ok")), line


@pytest.mark.parametrize("args", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--four"],
                                  ["bench.py"]])
def test_refuses_without_gpu(args):
    out = _run(args, ROOT)
    assert out.returncode != 0, out.stdout
    assert "GPU" in out.stderr
    _no_result(out)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    _no_result(out)


def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


def test_z_gate():
    cs = _smoke()
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4000, 3))
    b = rng.standard_normal((4000, 3))
    z, ok = cs.z_gate(a, b)
    assert ok and z < 5
    z, ok = cs.z_gate(a + 0.5, b)
    assert not ok and z > 5


def test_laplace_mode_is_stationary():
    cs = _smoke()
    X, Y = cs.logistic_data(500, d=4)
    mode, cov = cs.laplace(X, Y)
    p = 1.0 / (1.0 + np.exp(-X @ mode))
    np.testing.assert_allclose(X.T @ (Y - p) - mode, 0.0, atol=1e-8)
    assert np.all(np.linalg.eigvalsh(cov) > 0)


def test_smoke_data_is_the_bench_posterior():
    cs = _smoke()
    import bench

    for a, b in zip(cs.logistic_data(1000), bench.logistic_data(1000)):
        np.testing.assert_array_equal(a, b)
