r"""vfisr_tpu_torch's ``utils/config.py`` and ``analysis/data_analysis.py``
held against vfisr_tpu's.

- ``load_config``: config/default.yaml alone, deep-merged with a user file
  and with dict overrides, equal to the JAX package's dicts; ``get``;
  ``warp.backend`` mapped to the port's backends; ``make_adaptive_pipeline``
  taking its thresholds from the config; PyYAML imported on call only, and
  an error naming it where it is missing.
- ``data_analysis``: on one results JSON (numpy-seeded PSNR, SSIM, LPIPS
  and times for 14 methods over 3 intervals, with an infinite PSNR, missing
  LPIPS and an untimed row), ``load_results``, ``rankings``,
  ``category_stats``, ``compute_pareto`` and ``generate_report`` against
  the reference's pandas pipeline: the same rows in the same order, every
  number within 1e-12 relative (float64 means, summed in another order),
  NaN where the reference has NaN, and the report's text equal. The
  figures (matplotlib imported on call only, and raising by name without
  it) and both CLIs against the reference's scripts (the LaTeX table's
  names escaped as ``\_``, where the reference writes ``\\_``).
"""

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_port import one_torch_thread  # noqa: F401 (autouse fixture)
from vfisr_tpu.analysis import data_analysis as jda
from vfisr_tpu.utils import config as jconfig
from vfisr_tpu_torch.analysis import data_analysis as tda
from vfisr_tpu_torch.utils import config as tconfig

ROOT = Path(__file__).resolve().parents[1]
METHODS = ["degraded", "frame_dup", "lanczos_blend", "lanczos_blend_edge", "rife_default",
           "rife_fast", "adaptive_default", "adaptive_aggressive", "uafi_default",
           "ughi_default", "mcar_default", "optical_flow", "control", "slow_bad"]


def test_load_config_matches_jax(tmp_path):
    assert tconfig.load_config() == jconfig.load_config()
    user = tmp_path / "user.yaml"
    user.write_text("adaptive:\n  route_mode: masked\n  motion_threshold_low: 3.5\n"
                    "warp:\n  backend: gather\nnew_section: {a: 1}\n")
    over = {"rife": {"scale": 1.0}, "models": {"enabled": ["rife"]}}
    got = tconfig.load_config(user, over)
    assert got == jconfig.load_config(user, over)
    assert got["adaptive"]["route_mode"] == "masked" and got["adaptive"]["hud_history_frames"] == 10
    assert tconfig._deep_merge({"a": {"b": 1, "c": 2}}, {"a": {"c": 3}, "d": 4}) == \
        jconfig._deep_merge({"a": {"b": 1, "c": 2}}, {"a": {"c": 3}, "d": 4})
    for key in ("adaptive.route_mode", "warp.residual_radius", "nope.x", "adaptive.nope"):
        assert tconfig.get(got, key, "dflt") == jconfig.get(got, key, "dflt")
    assert tconfig.warp_backend(tconfig.load_config()) == "windowed"  # pallas
    assert tconfig.warp_backend(got) == "exact"  # gather
    with pytest.raises(ValueError, match="warp.backend"):
        tconfig.warp_backend({"warp": {"backend": "texture"}})


def test_make_adaptive_pipeline_takes_the_config():
    cfg = tconfig.load_config(overrides={"adaptive": {"motion_threshold_low": 2.0,
                                                      "route_mode": "masked"}})
    pipe = tconfig.make_adaptive_pipeline(cfg, device="cpu")
    assert pipe.route_mode == "masked"
    assert pipe.router.motion_threshold_low == 2.0 and pipe.router.motion_threshold_high == 25.0


def test_yaml_and_matplotlib_only_on_call(monkeypatch, tmp_path):
    code = ("import sys\n"
            "import vfisr_tpu_torch.utils.config, vfisr_tpu_torch.analysis.data_analysis\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('yaml', 'matplotlib',"
            " 'pandas')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stdout + res.stderr
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        tconfig.load_config()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tda.generate_figures(tda.load_results(_results(tmp_path)), tmp_path / "figs")


def _results(tmp_path) -> Path:
    rng = np.random.default_rng(11)
    exps = []
    for ivl in range(3):
        for k, name in enumerate(METHODS):
            e = {"name": name, "interval_idx": ivl,
                 "vfi_psnr_db": float(20 + 0.6 * k + rng.normal(0, 1.5)),
                 "vfi_ssim": float(0.8 + 0.01 * k + rng.normal(0, 0.01)),
                 "vfi_lpips": float(0.3 - 0.01 * k + rng.normal(0, 0.02)),
                 "keyframe_psnr_db": float(35 + rng.normal(0, 0.5)),
                 "overall_psnr_db": float(25 + rng.normal(0, 1)),
                 "time_s": float(np.exp(rng.normal(2 + 0.2 * k, 0.3))),
                 "fps_achieved": float(rng.uniform(1, 100)), "rife_frames_pct": 0.0}
            if name == "control":
                e["vfi_psnr_db"] = "inf"
            if name == "optical_flow":
                e.pop("vfi_lpips")
            if name == "slow_bad" and ivl == 1:
                e["time_s"] = None
            exps.append(e)
    path = tmp_path / "experiment_results.json"
    path.write_text(json.dumps({"experiments": exps, "created": "t"}))
    return path


def _same(got, want) -> bool:
    if isinstance(want, float) or isinstance(want, np.floating):
        if math.isnan(want):
            return math.isnan(got)
        return abs(got - want) <= 1e-12 * max(1.0, abs(want))
    return got == want


def _check_frame(rows: list, frame, cols) -> None:
    assert len(rows) == len(frame)
    for r, (_, ref) in zip(rows, frame.iterrows()):
        for c in cols:
            assert _same(r[c], ref[c]), (c, r[c], ref[c])


def test_load_results_and_rankings_match_pandas(tmp_path):
    path = _results(tmp_path)
    rows, df = tda.load_results(path), jda.load_results(path)
    _check_frame(rows, df, list(df.columns))
    assert math.isnan(rows[METHODS.index("control")]["vfi_psnr"])  # "inf" loads as NaN
    ranks, ref = tda.rankings(rows), jda.rankings(df)
    assert set(ranks) == set(ref)
    for key in ref:
        _check_frame(ranks[key], ref[key], list(ref[key].columns))
    _check_frame(tda.category_stats(rows), jda.category_stats(df),
                 ["category", "vfi_psnr", "time_s", "n"])
    assert tda.compute_pareto(rows) == jda.compute_pareto(df)


def test_report_matches_pandas(tmp_path):
    path = _results(tmp_path)
    text = tda.generate_report(tda.load_results(path), tmp_path / "t" / "analysis_report.md")
    ref = jda.generate_report(jda.load_results(path), tmp_path / "j" / "analysis_report.md")
    assert text == ref
    assert (tmp_path / "t" / "analysis_report.md").read_text() == ref


def test_inf_psnr_loads_as_nan(tmp_path):
    p = tmp_path / "r.json"
    p.write_text(json.dumps({"experiments": [{
        "name": "control", "interval_idx": 0, "vfi_psnr_db": "inf", "time_s": 1.0}]}))
    assert math.isnan(tda.load_results(p)[0]["vfi_psnr"])


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_figures_and_visualizations_cli_match_the_reference(tmp_path, monkeypatch, capsys):
    path = _results(tmp_path)
    got = tda.generate_figures(tda.load_results(path), tmp_path / "t")
    want = jda.generate_figures(jda.load_results(path), tmp_path / "j")
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    assert all(Path(p).stat().st_size > 0 for p in got)
    from vfisr_tpu_torch import generate_visualizations

    generate_visualizations.main(["--results", str(path), "--output-dir",
                                  str(tmp_path / "tv" / "figures")])
    monkeypatch.setattr(sys, "argv", ["generate_visualizations", "--results", str(path),
                                      "--output-dir", str(tmp_path / "jv" / "figures")])
    _script("generate_visualizations").main()
    # the reference escapes "_" as "\\_" (a raw "\\_" inside its f-string:
    # a LaTeX line break); the port writes "\_"
    want = (tmp_path / "jv" / "paper_table.tex").read_text()
    assert "mcar\\\\_default" in want
    assert (tmp_path / "tv" / "paper_table.tex").read_text() == want.replace("\\\\_", "\\_")


def test_analyze_results_cli_matches_the_reference(tmp_path, monkeypatch, capsys):
    path = _results(tmp_path)
    from vfisr_tpu_torch import analyze_results

    analyze_results.main(["--results", str(path)])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["analyze_results", "--results", str(path)])
    _script("analyze_results").main()
    assert got == capsys.readouterr().out and "rife_default" in got
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"experiments": []}))
    analyze_results.main(["--results", str(empty)])
    assert capsys.readouterr().out.strip() == "No experiments found."
