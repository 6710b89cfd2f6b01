"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phase
functions and comparison helpers work at tiny shapes.  The full-size run
needs the card: ``python3 chip_smoke.py`` (README, "Testing")."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(n=2000, m_fit=512, m_dense=256, n_small=600, m_small=256,
                n_rhs=5, score_block=64, n_scan=512, n_scan_ref=128,
                n_rare=512, window=32)


def _ran_ok(r) -> bool:
    return any(line.startswith('{"ok"') for line in r.stdout.splitlines())


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(tmp_path, where):
    """Exit non-zero and print no result where JAX finds no GPU, and in a
    directory that holds chip_smoke.py and nothing else of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        shutil.copy(script, tmp_path)
        script = str(tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert not _ran_ok(r)


@pytest.mark.gpu
def test_full_run_on_gpu():
    """The full one-card run, in a child that may open the GPU (this test
    process is held to the CPU)."""
    if shutil.which("nvidia-smi") is None or subprocess.run(
            ["nvidia-smi", "-L"], capture_output=True).returncode:
        pytest.skip("needs an NVIDIA GPU: run `python3 chip_smoke.py` on "
                    "the card")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=1500)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"


def test_rel_err_and_limits():
    assert cs.rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert cs.rel_err([1.0, 2.0 + 2e-12], [1.0, 2.0]) == pytest.approx(1e-12)
    assert cs.rel_err([0.5, 10.0 + 1e-9], [0.5, 10.0],
                      normwise=True) == pytest.approx(1e-10)
    assert cs.rel_err([np.nan], [1.0]) == float("inf")
    assert cs.rel_err(np.empty(0), np.empty(0)) == 0.0
    with pytest.raises(AssertionError):
        cs.rel_err([1.0], [1.0, 2.0])
    errors = {}
    cs.check(errors, "scan_p", 1e-9)
    assert errors == {"scan_p": [1e-9, cs.LIMITS["scan_p"]]}
    with pytest.raises(AssertionError, match="scan_p"):
        cs.check(errors, "scan_p", 1e-7)
    with pytest.raises(AssertionError):
        cs.check(errors, "scan_p", float("nan"))


def test_genotype_codes_shape_and_rates():
    codes = cs.genotype_codes(np.random.default_rng(0), 64, 20_000,
                              0.0005, 0.01, 0.001)
    assert codes.shape == (64, 20_000) and codes.dtype == np.int8
    assert set(np.unique(codes)) <= {0, 1, 2, 3}
    assert 0.0003 < np.mean(codes == 3) < 0.002
    assert np.mean((codes == 1) | (codes == 2)) < 0.03


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("smoke"))
    return cs.make_data(data, TINY, 0, multi=False), data


def test_phase_kernels(smoke, capsys):
    p, _ = smoke
    rec = cs.phase_kernels(p, TINY, 0)
    assert set(rec["max_err"]) == {"matvec", "score"}
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["phase"] \
        == "kernels"


@pytest.fixture(scope="module")
def fitted(smoke):
    p, data = smoke
    return cs.phase_fit(p, TINY, data)


def test_phase_fit(fitted):
    assert set(fitted["max_err"]) == {"fit_packed2", "fit_dense", "fit_cpu"}
    its = fitted["pcg_iterations"]
    assert its["small_gpu"] > 0 and its["small_cpu"] > 0


def test_phase_scan(smoke, fitted):
    p, data = smoke
    rec = cs.phase_scan(p, TINY, data, fitted["model"])
    assert rec["variants_tested"] > 0


def test_phase_rare(smoke, fitted):
    p, data = smoke
    rec = cs.phase_rare(p, data, fitted["model"])
    assert rec["shipped_bytes"]["sparse"] < rec["shipped_bytes"]["two_bit"]


def test_phase_aggregate(smoke, fitted):
    p, data = smoke
    rec = cs.phase_aggregate(p, TINY, data, fitted["model"])
    assert rec["windows"] == TINY.n_rare // TINY.window
    assert rec["windows_cpu"] == rec["windows"] // 4


def test_phase_multi_on_virtual_devices(tmp_path):
    """The four-device path on four of the CPU's virtual devices."""
    data = str(tmp_path)
    p = cs.make_data(data, TINY, 0, multi=True)
    assert not os.path.exists(p["rare"])
    rec = cs.phase_multi(p, data, n_dev=4)
    assert rec["devices"] == 4
    assert set(rec["max_err"]) == {"multi_fit", "multi_scan_p"}
