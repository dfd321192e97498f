"""vfisr_tpu_torch's fixed-shape export (``utils/aot.py``, ``compile_aot``)
held against vfisr_tpu's (``utils/aot.py``, tests/test_aot.py).

- The bicubic round trip: the port's ``.pt2`` artifact, loaded back, gives
  the JAX package's exported program's output on the same numpy-seeded
  frames within 1e-6 (both a linear crossfade in f32), and the eager call's
  exactly.
- A wrong input shape raises, in both packages.
- ``compile_stats`` keeps the reference's ``lower_s`` and ``compile_s``
  (plus ``flops``, where a model has convolutions, and the input and output
  sizes, equal to the reference's ``argument_size_in_bytes`` and
  ``output_size_in_bytes`` where XLA reports them).
- An export leaves the eager call's results real (the per-shape caches it
  traced through are emptied).
- A tiny bf16 ``rife_lite`` export on the CPU, the windowed warp routed
  through the custom op ``vfisr_tpu_torch::warp_windowed`` (its plain CPU
  kernel): the config's dtype switched as the reference's, the op a node of
  the program, and its frames equal to the eager call's, element for
  element.
- The CLI: export, ``--load`` and ``--stats-only`` on the CPU; the default
  output path is never under weights/.
"""

import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse fixture)
from vfisr_tpu.utils import aot as jaot
from vfisr_tpu_torch import compile_aot
from vfisr_tpu_torch.utils import aot

@pytest.fixture(scope="module")
def bicubic_blob():
    return aot.export_interpolate("bicubic", height=32, width=48, pairs=1, timesteps=(0.5,),
                                  device="cpu")


def test_export_roundtrip_bicubic_matches_jax(bicubic_blob):
    assert isinstance(bicubic_blob, bytes) and len(bicubic_blob) > 0
    fn = aot.load_exported(bicubic_blob)
    rng = np.random.default_rng(0)
    x0, x1 = (rng.random((1, 32, 48, 3), np.float32) for _ in range(2))
    with torch.no_grad():
        out = fn(torch.from_numpy(x0), torch.from_numpy(x1)).numpy()
    assert out.shape == (1, 1, 32, 48, 3)
    jfn = jaot.load_exported(jaot.export_interpolate("bicubic", height=32, width=48, pairs=1,
                                                     timesteps=(0.5,)))
    ref = np.asarray(jfn(jnp.asarray(x0), jnp.asarray(x1)))
    assert np.abs(out - ref).max() <= 1e-6
    eager, _ = aot.build_interpolate_fn("bicubic", (0.5,), device="cpu")
    with torch.no_grad():
        assert torch.equal(torch.from_numpy(out), eager(torch.from_numpy(x0),
                                                        torch.from_numpy(x1)))


def test_export_rejects_wrong_shape(bicubic_blob):
    fn = aot.load_exported(bicubic_blob)
    bad = torch.zeros((1, 16, 48, 3))
    with pytest.raises(Exception):
        fn(bad, bad)


def test_compile_stats_keys():
    fn, _ = aot.build_interpolate_fn("lanczos", timesteps=(0.5,), device="cpu")
    x = torch.zeros((1, 32, 48, 3))
    stats = aot.compile_stats(fn, x, x.clone())
    jfn, _ = jaot.build_interpolate_fn("lanczos", timesteps=(0.5,))
    aval = jax.ShapeDtypeStruct((1, 32, 48, 3), jnp.float32)
    ref = jaot.compile_stats(jfn, aval, aval)
    for key in ("lower_s", "compile_s"):
        assert key in ref and stats[key] >= 0
    assert stats["flops"] >= 0 and "peak_bytes" not in stats  # no CUDA memory on the CPU
    for key in ("argument_size_in_bytes", "output_size_in_bytes"):
        if key in ref:
            assert stats[key] == ref[key], key
    assert stats["argument_size_in_bytes"] == 2 * 32 * 48 * 3 * 4
    assert stats["output_size_in_bytes"] == 32 * 48 * 3 * 4
    assert not {"bytes_accessed", "transcendentals", "temp_size_in_bytes"} & set(stats)


def test_bf16_export_rife_lite_tiny_through_the_op(monkeypatch):
    monkeypatch.setattr("vfisr_tpu_torch.core.warp.default_warp_backend",
                        lambda device: "windowed")
    fn, model = aot.build_interpolate_fn("rife_lite", timesteps=(0.5,), precision="bf16",
                                         device="cpu")
    assert model.CONFIG.dtype == torch.bfloat16  # the config's dtype switched
    x = torch.zeros((1, 32, 32, 3))
    program = aot.export_program(fn, x, x.clone())
    ops = [str(n.target) for g in program.graph_module.modules()
           if isinstance(g, torch.fx.GraphModule) for n in g.graph.nodes
           if n.op == "call_function"]
    assert ops.count("vfisr_tpu_torch.warp_windowed.default") == 3  # 2 levels + the final warp
    buf = io.BytesIO()
    torch.export.save(program, buf)
    exported = aot.load_exported(buf.getvalue())
    rng = np.random.default_rng(1)
    x0, x1 = (torch.from_numpy(rng.random((1, 32, 32, 3), np.float32)) for _ in range(2))
    calls = []
    from vfisr_tpu_torch.ops.cuda import warp as kw

    real = kw.warp_windowed_plain
    monkeypatch.setattr(kw, "warp_windowed_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got = exported(x0, x1)
        want = fn(x0, x1)
    assert len(calls) == 6  # the op's CPU kernel, 3 per run
    assert got.shape == (1, 1, 32, 32, 3) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    from vfisr_tpu.models.registry import get_model as jget_model

    assert jaot._maybe_bf16(jget_model("rife_lite"), "bf16").CONFIG.dtype == jnp.bfloat16


def test_export_leaves_eager_calls_real():
    """An export traces with fake tensors through the port's per-shape
    caches (here the reflect pad of 40x56 to 64x64): after it, the eager
    call still gives real tensors, equal to the ones before it and to the
    program's."""
    fn, _ = aot.build_interpolate_fn("rife_lite", timesteps=(0.5,), precision="bf16",
                                     device="cpu")
    x0, x1 = (torch.from_numpy(np.random.default_rng(k).random((1, 40, 56, 3), np.float32))
              for k in (2, 3))
    with torch.no_grad():
        before = fn(x0, x1)
        program = aot.export_program(fn, x0, x1)
        after = fn(x0, x1)
        exported = program.module()(x0, x1)
    assert type(after) is torch.Tensor and type(exported) is torch.Tensor
    assert torch.equal(after, before) and torch.equal(exported, before)


def test_cli_export_load_and_stats(tmp_path, capsys, monkeypatch):
    out = tmp_path / "b.pt2"
    rec = compile_aot.main(["--model", "bicubic", "--height", "32", "--width", "48",
                            "--timesteps", "0.5", "--device", "cpu", "--output", str(out)])
    assert out.is_file() and rec["bytes"] == out.stat().st_size
    run = compile_aot.main(["--load", str(out), "--height", "32", "--width", "48",
                            "--device", "cpu"])
    assert run["output_shape"] == [1, 1, 32, 48, 3]
    stats = compile_aot.main(["--model", "lanczos", "--height", "32", "--width", "48",
                              "--timesteps", "0.5", "--device", "cpu", "--stats-only"])
    assert stats["compile_s"] >= 0 and stats["lower_s"] >= 0
    assert len([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]) == 3
    # without --output: outputs/<model>_<height>p.pt2 under the working
    # directory, not weights/
    monkeypatch.chdir(tmp_path)
    rec = compile_aot.main(["--model", "bicubic", "--height", "32", "--width", "48",
                            "--timesteps", "0.5", "--device", "cpu"])
    assert Path(rec["artifact"]) == Path("outputs") / "bicubic_32p.pt2"
    assert (tmp_path / "outputs" / "bicubic_32p.pt2").is_file()
    assert "weights" not in Path(rec["artifact"]).parts


def test_cli_needs_a_card_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        compile_aot.main(["--model", "bicubic"])
