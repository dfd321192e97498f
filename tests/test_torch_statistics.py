"""vfisr_tpu_torch/evaluation/statistics.py and vfisr_tpu_torch/analysis/
held against vfisr_tpu/evaluation/statistics.py and vfisr_tpu/analysis/.

Inputs are made with numpy from a seed: samples for the statistics, and an
``experiment_results.json`` of five intervals in which some methods miss
intervals, one row has no PSNR (a FAILED experiment), one an infinite PSNR,
and one (name, interval) cell is repeated. Every result must equal the
reference's, NaN where it has NaN; both run the same numpy and scipy code.
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest

from vfisr_tpu.analysis import final_analysis as jfinal
from vfisr_tpu.analysis import normalize_data as jnorm
from vfisr_tpu.analysis import statistical_analysis as jsa
from vfisr_tpu.evaluation import statistics as jst
from vfisr_tpu_torch.analysis import final_analysis as tfinal
from vfisr_tpu_torch.analysis import normalize_data as tnorm
from vfisr_tpu_torch.analysis import statistical_analysis as tsa
from vfisr_tpu_torch.evaluation import statistics as tst
from _torch_port import one_torch_thread  # noqa: F401 (autouse fixture)

METHODS = ("degraded", "lanczos_blend", "optical_flow_basic", "uafi_default", "ughi_default",
           "rife_default", "adaptive_default", "mcar_default")


def _same(a, b, path=""):
    """Equal, with NaN equal to NaN, through dicts, lists and tuples."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for k in b:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(b, float) and math.isnan(b):
        assert isinstance(a, float) and math.isnan(a), path
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def results(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    rows = []
    for ivl in range(5):
        base = 24.0 + 3.0 * rng.standard_normal()
        for k, name in enumerate(METHODS):
            if name == "adaptive_default" and ivl > 1:  # two intervals: too few samples
                continue
            if name == "mcar_default" and ivl > 0:  # one interval: no spread
                continue
            v = base + 0.5 * k + 0.8 * rng.standard_normal() if name != "degraded" else base
            rows.append({"name": name, "interval_idx": ivl, "vfi_psnr_db": float(v),
                         "time_s": float(1.0 + k + rng.random())})
    rows.append({"name": "ughi_default", "interval_idx": 2, "vfi_psnr_db": None, "time_s": 0.0})
    rows.append({"name": "lanczos_blend", "interval_idx": 3, "vfi_psnr_db": float("inf"),
                 "time_s": 1.5})
    rows.append(dict(rows[1], vfi_psnr_db=rows[1]["vfi_psnr_db"] + 1.0, time_s=9.0))
    return {"experiments": rows, "created": "seeded"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_statistics_functions_match(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal(7) + 0.4, rng.standard_normal(6)
    for x, y in ((a, b), (a[:1], b), (np.ones(3), np.ones(3)), (a, a)):
        _same(tst.cohens_d(x, y), jst.cohens_d(x, y))
        _same(tst.paired_t_test(x, y), jst.paired_t_test(x, y))
    for d in (0.0, 0.1, -0.3, 0.6, 2.0, float("nan")):
        assert tst.effect_size_label(d) == jst.effect_size_label(d)
    for v in (list(a), [1.5], [], [1.0, None, float("inf"), 2.0]):
        _same(tst.mean_ci(v), jst.mean_ci(v))
        _same(tst.mean_ci(v, 0.9), jst.mean_ci(v, 0.9))
    table = tsa.per_interval_table(results(seed))
    assert table == jsa.per_interval_table(results(seed))
    _same(tst.normalize_gains(table), jst.normalize_gains(table))
    _same(tst.interval_difficulty_from_baseline(table),
          jst.interval_difficulty_from_baseline(table))
    pts = [(f"m{i}", float(q), float(t)) for i, (q, t) in enumerate(rng.random((9, 2)))]
    assert tst.pareto_frontier(pts) == jst.pareto_frontier(pts)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_analyses_match(seed):
    r = results(seed)
    _same(tsa.analyze(r), jsa.analyze(r))
    _same(tnorm.normalize(r), jnorm.normalize(r))
    _same(tfinal.analyze(r), jfinal.analyze(r))
    verdicts = tsa.analyze(r)["novel_verdicts"]
    assert verdicts["uafi_default"]["confidence"] in ("significant", "not significant")
    assert verdicts["adaptive_default"]["confidence"] == "insufficient samples"


def test_reports_and_cli_match(tmp_path):
    """Each module's run() writes the reference's files; the CLI writes the
    same statistical report as run()."""
    path = tmp_path / "experiment_results.json"
    path.write_text(json.dumps(results(3)))
    for name, tmod, jmod, files in (
            ("stats", tsa, jsa, ("statistical_analysis.json", "statistical_summary.md")),
            ("norm", tnorm, jnorm, ("normalized_results.json",)),
            ("final", tfinal, jfinal, ("final_analysis.json",))):
        _same(tmod.run(path, tmp_path / "t" / name), jmod.run(path, tmp_path / "j" / name))
        for f in files:
            assert (tmp_path / "t" / name / f).read_text() == (tmp_path / "j" / name / f).read_text()
    from vfisr_tpu_torch import analyze_statistics

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        analyze_statistics.main(["--results", str(path), "--output-dir", str(tmp_path / "cli")])
    for f in ("statistical_analysis.json", "statistical_summary.md"):
        assert (tmp_path / "cli" / f).read_text() == (tmp_path / "j" / "stats" / f).read_text()
    assert "uafi_default:" in buf.getvalue() and "mcar_default:" in buf.getvalue()
