"""Launch-time behaviour: compile cache, device-memory tier rule, and the
pandas-free import + CLI path."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from saigegds_tpu.models import fitnull
from saigegds_tpu.models.fitnull import (CPU_MEMORY_BUDGET, _auto_grm_impl,
                                         _device_memory_budget)
from saigegds_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_dir_env_set_sets_nothing(monkeypatch, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "/elsewhere")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
    assert compile_cache.enable_compile_cache() == "/from/env"
    assert jax.config.jax_compilation_cache_dir == "/elsewhere"


def test_cache_dir_env_unset_uses_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_package_import_sets_no_cache():
    """Importing the package leaves the cache alone; a launcher sets it."""
    code = ("import jax, saigegds_tpu; "
            "print(repr(jax.config.jax_compilation_cache_dir))")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "None"


@pytest.mark.parametrize("budget,want", [
    (16 << 30, ["packed", "packed2", "packed2"]),   # CPU_MEMORY_BUDGET
    (64 << 30, ["packed", "packed", "packed2"]),    # one 80 GB card's share
    (2 << 30, ["packed2", "packed2", "packed2"]),
])
def test_auto_grm_tier_follows_device_memory(budget, want):
    """bf16 store (2 B/genotype) while it fits a quarter of the budget."""
    shapes = [(16_384, 100_000), (65_536, 100_000), (65_536, 430_000)]
    got = [_auto_grm_impl(m, n, budget=budget) for m, n in shapes]
    assert got == want
    # a mesh shards the bf16 store, whatever its size
    assert _auto_grm_impl(65_536, 430_000, mesh=object(),
                          budget=budget) == "packed"


@pytest.mark.parametrize("budget,want", [
    (80 << 30, ["packed2", "packed2", "packed2"]),
    (int(63.8e9), ["packed2", "packed2_split", "packed2_split"]),  # H100
    (16 << 30, ["packed2", "packed2_split", "packed2_split"]),
])
def test_packed2_engine_follows_device_memory(budget, want):
    """One program while 9 B per store byte + 16 B per missing call fit
    in 90% of the budget; else the split engine."""
    def store(m, n):
        return m * (-(-n // 4))
    cases = [(store(16_384, 100_000), 8_192_000),       # 0.5% missing
             (store(65_536, 430_000), 0),
             (store(65_536, 430_000), 140_902_400)]     # 0.5% missing
    assert [fitnull._packed2_engine(s, k, budget=budget)
            for s, k in cases] == want


@pytest.mark.parametrize("budget,want", [
    (1 << 20, "PackedGRM"),
    (200_000, "Packed2GRM"),
    (80_000, "SplitPacked2"),
])
def test_auto_fit_engine_at_budget(tmp_path, monkeypatch, budget, want):
    """The fit preamble picks the bf16 store, the one-program 2-bit store
    or the split engine from the device-memory budget."""
    from saigegds_tpu.config import NullModelConfig
    from saigegds_tpu.io.gds_write import write_seqarray_gds
    from saigegds_tpu.io.seqarray import SeqData
    rng = np.random.default_rng(0)
    n, m = 240, 150          # bf16 store 72,000 B; 2-bit 9,000 B
    write_seqarray_gds(str(tmp_path / "g.gds"), rng.binomial(
        2, rng.uniform(0.1, 0.5, (m, 1)), (m, n)).astype(np.int8))
    data = {"sample.id": np.arange(1, n + 1),
            "y": rng.integers(0, 2, n), "x1": rng.normal(size=n)}
    monkeypatch.setattr(fitnull, "CPU_MEMORY_BUDGET", budget)
    resp, covs = fitnull._parse_formula("y ~ x1")
    prep = fitnull._prepare_fit(SeqData(str(tmp_path / "g.gds")), data,
                                NullModelConfig(maf=0.0), [resp], covs,
                                None, None, False)
    assert type(prep["grm"]).__name__ == want


def test_cpu_memory_budget():
    assert jax.devices()[0].platform == "cpu"
    assert _device_memory_budget() == CPU_MEMORY_BUDGET


def test_cli_fit_scan_acato_without_pandas(tmp_path):
    """`import saigegds_tpu` and the CLI's fit -> scan -> acat-o into .gds
    run with pandas and pyarrow unavailable."""
    from saigegds_tpu.io.gds_write import write_seqarray_gds
    rng = np.random.default_rng(0)
    n, m = 300, 200
    write_seqarray_gds(str(tmp_path / "g.gds"), rng.binomial(
        2, rng.uniform(0.1, 0.5, (m, 1)), (m, n)).astype(np.int8))
    af = rng.uniform(0.005, 0.03, (64, 1))
    write_seqarray_gds(str(tmp_path / "rare.gds"),
                       rng.binomial(2, af, (64, n)).astype(np.int8))
    x = rng.normal(size=n)
    y = (rng.random(n) < 1 / (1 + np.exp(-x + 1))).astype(int)
    with open(tmp_path / "pheno.tsv", "w") as fh:
        fh.write("sample.id\ty\tx1\n")
        for i, (yi, xi) in enumerate(zip(y.tolist(), x.tolist())):
            fh.write(f"{i + 1}\t{yi}\t{xi!r}\n")
    script = textwrap.dedent(f"""
        import json, sys
        sys.modules["pandas"] = None        # any import of it fails
        sys.modules["pyarrow"] = None
        import saigegds_tpu
        from saigegds_tpu.__main__ import main
        d = {str(tmp_path)!r}
        assert main(["fit", "--formula", "y ~ x1", "--pheno",
                     d + "/pheno.tsv", "--gds", d + "/g.gds",
                     "--out", d + "/m.npz"]) == 0
        assert main(["scan", "--gds", d + "/g.gds", "--model",
                     d + "/m.npz", "--out", d + "/assoc.gds",
                     "--mac", "4"]) == 0
        assert main(["acat-o", "--gds", d + "/rare.gds", "--model",
                     d + "/m.npz", "--win-size", "16", "--win-shift", "16",
                     "--out", d + "/sets.gds"]) == 0
        from saigegds_tpu.io.gds import open_gds
        root = open_gds(d + "/assoc.gds").root
        sets = open_gds(d + "/sets.gds").root
        print(json.dumps(dict(
            n=len(root["pval"].read()), windows=len(sets["pval"].read()),
            pandas=sys.modules["pandas"] is None)))
        """)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out == dict(n=out["n"], windows=4, pandas=True) and out["n"] > 100


def _write_pheno(path, header, rows):
    with open(path, "w") as fh:
        fh.write("\t".join(header) + "\n")
        for r in rows:
            fh.write("\t".join(map(str, r)) + "\n")


@pytest.mark.parametrize("token", ["N/A", "NULL", "null", "#N/A", "<NA>",
                                   "None", "NA", ""])
def test_read_pheno_na_tokens(tmp_path, token):
    """pandas' default missing-value tokens read as missing, in a numeric
    column and in a text one."""
    from saigegds_tpu.__main__ import _read_pheno
    f = str(tmp_path / "p.tsv")
    _write_pheno(f, ["sample.id", "y", "x1", "grp"],
                 [["007", 1, 0.5, "a"], ["8", 0, token, "b"],
                  ["9", 1, 1.5, token]])
    d = _read_pheno(f)
    assert d["sample.id"].tolist() == ["007", "8", "9"]
    assert d["y"].dtype == np.int64
    assert d["x1"].dtype == np.float64 and np.isnan(d["x1"][1])
    assert d["grp"].tolist() == ["a", "b", None]


def test_read_pheno_rejects_stray_text_in_numbers(tmp_path):
    """A numeric column with an unknown token is an error, not a factor;
    a text column stays a factor."""
    from saigegds_tpu.__main__ import _read_pheno
    f = str(tmp_path / "p.tsv")
    _write_pheno(f, ["sample.id", "x1"],
                 [[1, 0.5], [2, "missing"], [3, 1.5]])
    with pytest.raises(ValueError, match="'x1'.*'missing'"):
        _read_pheno(f)
    _write_pheno(f, ["sample.id", "x1"], [[1, "lo"], [2, "hi"], [3, 4]])
    assert _read_pheno(f)["x1"].tolist() == ["lo", "hi", "4"]


def test_cli_fit_drops_na_rows(tmp_path):
    """A CLI fit on a TSV with 'N/A' covariate cells drops those rows."""
    from saigegds_tpu.__main__ import main
    from saigegds_tpu.io.gds_write import write_seqarray_gds
    from saigegds_tpu.models.nullmodel import NullModel
    rng = np.random.default_rng(0)
    n, m = 300, 200
    write_seqarray_gds(str(tmp_path / "g.gds"), rng.binomial(
        2, rng.uniform(0.1, 0.5, (m, 1)), (m, n)).astype(np.int8))
    x = rng.normal(size=n)
    y = (rng.random(n) < 1 / (1 + np.exp(-x + 1))).astype(int)
    na = {3, 50, 51, 199}
    _write_pheno(tmp_path / "pheno.tsv", ["sample.id", "y", "x1"],
                 [[i + 1, yi, "N/A" if i in na else repr(xi)]
                  for i, (yi, xi) in enumerate(zip(y.tolist(), x.tolist()))])
    assert main(["fit", "--formula", "y ~ x1", "--pheno",
                 str(tmp_path / "pheno.tsv"), "--gds",
                 str(tmp_path / "g.gds"), "--out",
                 str(tmp_path / "m.npz")]) == 0
    model = NullModel.load(str(tmp_path / "m.npz"))
    want = [str(i + 1) for i in range(n) if i not in na]
    assert np.asarray(model.sample_id).astype(str).tolist() == want
    assert model.coef_names == ["(Intercept)", "x1"]
