"""chip_smoke.py's pieces that run without a GPU: the result line, the
refusal to run anywhere but on a GPU, the phase selection, and the
comparison helpers failing on planted mismatches. The GPU run itself is
``python chip_smoke.py`` on a machine with one."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_result_line_exact():
    assert cs.result_line("NVIDIA H100 80GB HBM3", 1) == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(cs.result_line("x", 4))["device"]["count"] == 4


@pytest.mark.parametrize("args", [[], ["--four-cards"]])
def test_exits_nonzero_without_gpu(args):
    """On the CPU the device phase fails: non-zero exit, no result line."""
    res = _run(args, ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "SmokeFailure" in res.stderr and "GPU" in res.stderr


def test_fails_alone_without_the_repo(tmp_path):
    """Copied into an empty directory, the script cannot import the
    package and fails before printing a result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run([], tmp_path, {"PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_four_cards_selects_only_its_phase():
    assert cs.phases(True) == ["device", "four_cards"]
    single = cs.phases(False)
    assert "four_cards" not in single
    assert single == ["device", "headline", "report", "parity", "exact_tax"]


def test_require_gpu_rejects_cpu_devices():
    import jax

    with pytest.raises(cs.SmokeFailure, match="GPU"):
        cs.require_gpu(jax.devices("cpu"), 1)
    with pytest.raises(cs.SmokeFailure):
        cs.require_gpu(jax.devices("cpu")[:1], 4)


def test_check_close_fails_planted_mismatch(capsys):
    want = np.linspace(1.0, 2.0, 8)
    assert cs.check_close("same", want + 1e-9, want, 1e-6, 0.0, "ulps") <= 1e-8
    bad = want.copy()
    bad[5] *= 1.01
    with pytest.raises(cs.SmokeFailure):
        cs.check_close("planted", bad, want, 1e-3, 0.0, "test")
    nonfinite = want.copy()
    nonfinite[2] = np.nan
    with pytest.raises(cs.SmokeFailure, match="finiteness"):
        cs.check_close("nan", nonfinite, want, 1.0, 1.0, "test")
    with pytest.raises(cs.SmokeFailure, match="shape"):
        cs.check_close("shape", want[:4], want, 1.0, 1.0, "test")
    out = capsys.readouterr().out
    assert "-> PASS" in out and "-> FAIL" in out


def test_check_share_fails_below_minimum():
    cs.check_share("ok", 0.99, 0.95, "test")
    with pytest.raises(cs.SmokeFailure):
        cs.check_share("planted", 0.90, 0.95, "test")


def test_compare_tax_tables_fails_planted_mismatch():
    want = {"S7": {"n_trials": 256, "nonfinite_trials": 0,
                   "median_tax": 1000.0, "pre_tax_p50": 5e4},
            "S8": {"n_trials": 256, "nonfinite_trials": 0,
                   "median_tax": 2000.0, "pre_tax_p50": 6e4}}
    cs.compare_tax_tables(want, want, rtol=1e-5, why="same")
    ints = {s: dict(v) for s, v in want.items()}
    ints["S8"]["nonfinite_trials"] = 1
    with pytest.raises(cs.SmokeFailure, match="integer"):
        cs.compare_tax_tables(ints, want, rtol=1e-5, why="test")
    floats = {s: dict(v) for s, v in want.items()}
    floats["S7"]["pre_tax_p50"] *= 1.001
    with pytest.raises(cs.SmokeFailure):
        cs.compare_tax_tables(floats, want, rtol=1e-5, why="test")


def test_compare_parity_fails_planted_mismatch():
    """compare_parity on two fake runs: identical passes; one strategy's
    wealth scaled by 2% in every trial fails the typical-trial check."""
    from types import SimpleNamespace

    rng = np.random.default_rng(0)
    n = 64
    fw = rng.lognormal(10.0, 0.5, (n, 19))

    def run(w):
        return SimpleNamespace(
            final_wealth=w, max_dd=np.full((n, 19), 0.3),
            num_trades=np.full((n, 19), 10), valid=np.ones(n, bool),
            path_finite=np.ones(n, bool), chunk_failed=np.zeros(n, bool))

    cs.compare_parity(run(fw), run(fw.copy()))
    bad = fw.copy()
    bad[:, 4] *= 1.02
    with pytest.raises(cs.SmokeFailure):
        cs.compare_parity(run(bad), run(fw))
    failed = run(fw)
    failed.chunk_failed = np.ones(n, bool)
    with pytest.raises(cs.SmokeFailure, match="failed chunks"):
        cs.compare_parity(failed, run(fw))


def _trials(fw, trades=10):
    from types import SimpleNamespace

    n = fw.shape[0]
    return SimpleNamespace(
        final_wealth=fw, max_dd=np.full((n, 19), 0.3),
        num_trades=np.full((n, 19), trades), valid=np.ones(n, bool),
        path_finite=np.ones(n, bool), start_offset=np.arange(n))


def test_compare_trials_fails_planted_mismatch(capsys):
    """Per-trial sharded-vs-single check: identical runs pass and print a
    bitwise-equal share of 1; one trial moved by 1e-4, or one trade count
    changed, fails."""
    fw = np.random.default_rng(1).lognormal(10.0, 0.5, (32, 19))
    cs.compare_trials(_trials(fw), _trials(fw.copy()), "same")
    assert "bitwise equal in 1.000000" in capsys.readouterr().out
    bad = fw.copy()
    bad[7, 3] *= 1.0001
    with pytest.raises(cs.SmokeFailure, match="final_wealth"):
        cs.compare_trials(_trials(bad), _trials(fw), "planted")
    with pytest.raises(cs.SmokeFailure, match="num_trades"):
        cs.compare_trials(_trials(fw, trades=11), _trials(fw), "planted")


def test_print_field_diffs_names_the_worst_fields(capsys):
    want = {".S1.wealth.p50": 1e6, ".S2.wealth.p50": 2e6, ".S3.cagr.p50": 0.1}
    got = dict(want)
    got[".S2.wealth.p50"] *= 1.5
    got[".S3.cagr.p50"] += 1e-12
    cs.print_field_diffs("t", got, want, sorted(want), rtol=1e-5)
    out = capsys.readouterr().out
    assert "1 of 3 fields over tolerance" in out
    assert ".S2.wealth.p50" in out and "rel 5.000e-01" in out
    assert ".S1.wealth.p50:" not in out
