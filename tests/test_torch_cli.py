"""The port CLI's ``paths`` subcommand against the JAX CLI's output contract,
and its device rule: the card unless ``--device cpu`` is given."""

import json

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.host import cli as jcli
from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
from qmmx_monolithic_monte_carlo_tpu_torch.io import db

torch.set_num_threads(2)

ARGS = ["paths", "--num-paths", "16384", "--num-bars", "24"]
CPU = ["--device", "cpu"]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_paths_torch_backend_prints_the_jax_cli_keys(tmp_path, capsys):
    out = _run(cli.main, ["--db", str(tmp_path / "t.db"), *ARGS,
                          "--backend", "torch", *CPU], capsys)
    want = _run(jcli.main, ["--db", str(tmp_path / "j.db"), *ARGS,
                            "--backend", "xla"], capsys)
    assert set(out) == set(want)
    assert all(np.isfinite(v) for v in out.values())
    assert out["paths"] == want["paths"] == 16384.0
    assert 0.0 < out["entered"] <= out["paths"]
    assert 0.0 < out["hit_rate"] < 1.0
    assert out["worst_r"] == -1.0 and out["var_05"] <= out["mean_r"]
    # same model, different streams: close, not equal
    assert abs(out["hit_rate"] - want["hit_rate"]) < 0.05


def test_paths_reads_levels_and_settings_from_the_db(tmp_path, capsys):
    path = str(tmp_path / "t.db")
    conn = db.db_connect(path)
    db.db_init(conn)
    db.replace_levels(conn, [{"color": "blue", "type": "solid", "index": 0,
                              "price": 100.1}])
    db.settings_set(conn, "CONTACT_PROX", "0.0")
    conn.close()
    if not torch.cuda.is_available():
        # auto never changes the device: without a GPU it needs --device cpu
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.main(["--db", path, *ARGS, "--backend", "auto"])
    out = _run(cli.main, ["--db", path, *ARGS, "--backend", "auto", *CPU], capsys)
    # a zero proximity almost never touches a single level exactly
    assert out["entered"] < 0.01 * out["paths"]


def test_paths_noise_and_antithetic(tmp_path, capsys):
    out = _run(cli.main, ["--db", str(tmp_path / "t.db"), *ARGS, "--backend",
                          "torch", "--antithetic", "--entry-slip-std", "0.01",
                          "--level-jitter-std", "0.02", *CPU], capsys)
    assert all(np.isfinite(v) for v in out.values())


def test_paths_cuda_backend_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA device"):
        cli.main(["--db", str(tmp_path / "t.db"), *ARGS, "--backend", "cuda"])


@pytest.mark.parametrize("flags", [["--sampler", "heston"], ["--engine", "--exact-tail"],
                                   ["--exact-tail"], ["--ckpt-dir", "ck"],
                                   ["--sampler", "bootstrap"]])
def test_unported_options_exit_clearly(tmp_path, flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["--db", str(tmp_path / "t.db"), *ARGS, *flags])


GATED = ["paths", "--gated", "--num-paths", "16384", "--num-bars", "24"]


def test_paths_gated_torch_backend_prints_the_jax_cli_gated_keys(tmp_path, capsys):
    out = _run(cli.main, ["--db", str(tmp_path / "t.db"), *GATED,
                          "--backend", "torch", *CPU], capsys)
    want = _run(jcli.main, ["--db", str(tmp_path / "j.db"), *GATED,
                            "--backend", "xla"], capsys)
    assert set(out) == set(want)
    assert {"trades", "mean_trades", "mean_dd", "max_dd"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())
    assert out["paths"] == want["paths"] == 16384.0
    assert out["trades"] >= out["entered"] > 0 and out["mean_trades"] >= 1.0
    assert 0.0 < out["hit_rate"] < 1.0 and out["max_dd"] >= 0.0
    # same model, different streams: close, not equal
    assert abs(out["mean_trades"] - want["mean_trades"]) < 0.05
    assert abs(out["hit_rate"] - want["hit_rate"]) < 0.05


def test_paths_gated_gate_flags_take_effect(tmp_path, capsys):
    base = ["--db", str(tmp_path / "t.db"), *GATED, "--backend", "torch", *CPU]
    loose = _run(cli.main, base, capsys)
    tight = _run(cli.main, [*base, "--touch-limit", "1"], capsys)
    slow = _run(cli.main, [*base, "--cooldown-bars", "5"], capsys)
    assert tight["trades"] == 0.0 and tight["entered"] == 0.0
    assert slow["trades"] < loose["trades"]


def test_paths_gated_cuda_backend_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA device"):
        cli.main(["--db", str(tmp_path / "t.db"), *GATED, "--backend", "cuda"])


@pytest.mark.parametrize("gated, num_paths, num_bars, want", [
    (True, 16384, 24, "cuda"),
    (True, 16384, 25, "torch"),      # the gated kernel takes an even W only
    (True, 12288, 24, "torch"),      # not a multiple of 8 x 1024
    (False, 16384, 25, "torch"),     # the first-contact layout takes an even W only
    (False, 16384, 130, "torch"),    # above the first-contact kernel's 128 bars
])
def test_paths_auto_takes_the_kernel_only_when_the_shape_fits(
        monkeypatch, gated, num_paths, num_bars, want):
    # the choice is made for a CUDA device; nothing is launched here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    argv = ["paths", "--num-paths", str(num_paths), "--num-bars", str(num_bars),
            "--backend", "auto", *(["--gated"] if gated else [])]
    args = cli.build_parser().parse_args(argv)
    assert cli._backend(args, [{"price": 100.0}] * 3) == want


@pytest.mark.parametrize("path", ["first-contact", "gated", "engine"])
@pytest.mark.parametrize("num_bars", [40, 41])
def test_fits_takes_an_even_bar_count_only(path, num_bars):
    flags = {"first-contact": [], "gated": ["--gated"], "engine": ["--engine"]}[path]
    args = cli.build_parser().parse_args(
        ["paths", "--num-paths", "16384", "--num-bars", str(num_bars), *flags])
    rows = [{"price": 100.0}] * 3
    if num_bars % 2:
        assert "even --num-bars" in cli._fits(args, rows)
    else:
        assert cli._fits(args, rows) is None
    assert "8 levels" in cli._fits(args, rows * 3)


@pytest.mark.parametrize("num_paths, num_bars, fits", [
    (16384, 40, True), (16384 + 1024, 40, False), (16384, 62, False)])
def test_fits_engine_envelope(num_paths, num_bars, fits):
    args = cli.build_parser().parse_args(
        ["paths", "--engine", "--num-paths", str(num_paths), "--num-bars", str(num_bars)])
    assert (cli._fits(args, [{"price": 100.0}] * 3) is None) == fits


def test_paths_cuda_backend_refuses_an_odd_first_contact_bar_count(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="even --num-bars"):
        cli.main(["--db", str(tmp_path / "t.db"), "paths", "--num-paths", "16384",
                  "--num-bars", "41", "--backend", "cuda"])


ENGINE = ["paths", "--engine", "--num-paths", "4096", "--num-bars", "24"]


def test_paths_engine_prints_the_jax_cli_engine_keys(tmp_path, capsys):
    out = _run(cli.main, ["--db", str(tmp_path / "t.db"), *ENGINE, "--backend",
                          "torch", *CPU], capsys)
    want = _run(jcli.main, ["--db", str(tmp_path / "j.db"), *ENGINE,
                            "--backend", "xla"], capsys)
    assert set(out) == set(want)
    assert isinstance(out["escalations"], int) and isinstance(out["skips"], dict)
    assert {"TOO_FAR", "CONF_LOW"} <= set(out["skips"])
    assert all(isinstance(n, int) and n > 0 for n in out["skips"].values())
    assert out["paths"] == want["paths"] == 4096.0
    assert out["trades"] >= out["entered"] > 0 and 0.0 < out["hit_rate"] < 1.0
    # same model, different streams: close, not equal
    assert abs(out["mean_trades"] - want["mean_trades"]) < 0.1
    evals = 4096 * 24
    for name in ("TOO_FAR", "IN_POSITION"):
        assert abs(out["skips"][name] - want["skips"][name]) < 0.05 * evals


def test_paths_engine_auto_on_the_cpu_runs_the_pipeline(tmp_path, capsys):
    out = _run(cli.main, ["--db", str(tmp_path / "t.db"), *ENGINE, "--num-bars",
                          "25", "--backend", "auto", "--antithetic",
                          "--entry-slip-std", "0.01", *CPU], capsys)
    assert out["paths"] == 4096.0 and out["trades"] > 0


def test_paths_gated_cuda_backend_refuses_an_odd_bar_count(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="even --num-bars"):
        cli.main(["--db", str(tmp_path / "t.db"), "paths", "--gated",
                  "--num-paths", "16384", "--num-bars", "25", "--backend", "cuda"])


def test_paths_cuda_backend_refuses_the_cpu_device(tmp_path):
    with pytest.raises(SystemExit, match="--device cuda"):
        cli.main(["--db", str(tmp_path / "t.db"), *GATED, "--backend", "cuda",
                  *CPU])


SWEEP = ["sweep", "--num-paths", "16384", "--num-bars", "24"]
SWEEP_FORMS = {
    "first-contact": ["--stops", "0.25", "0.45", "--tps", "0.15", "0.3"],
    "gated": ["--gated", "--stops", "0.3", "--tps", "0.2", "0.3", "--touch-limits", "2",
              "4", "--qmins", "0.55"],
    "engine": ["--engine", "--num-paths", "2048", "--num-bars", "16", "--stops", "0.3",
               "--tps", "0.2", "--jitter-stds", "0", "0.02", "--entry-slip-std", "0.01"],
}


def _rows(main, argv, capsys):
    assert main(argv) == 0
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("form", list(SWEEP_FORMS))
def test_sweep_prints_the_jax_cli_rows_and_keys(tmp_path, capsys, form):
    """Each form's rows in the JAX CLI's order with its keys; the values are
    close, not equal (the two packages draw different streams)."""
    argv = [*SWEEP, *SWEEP_FORMS[form]]
    out = _rows(cli.main, ["--db", str(tmp_path / "t.db"), *argv, "--backend", "torch",
                           *CPU], capsys)
    want = _rows(jcli.main, ["--db", str(tmp_path / "j.db"), *argv], capsys)
    assert len(out) == len(want) == {"first-contact": 4, "gated": 4, "engine": 2}[form]
    grid_keys = ("stop_padding", "tp_padding", "touch_limit", "q_min_prob",
                 "level_jitter_std")
    for o, w in zip(out, want):
        assert list(o) == list(w)
        assert [o.get(k) for k in grid_keys] == [w.get(k) for k in grid_keys]
        assert 0.0 < o["hit_rate"] < 1.0 and np.isfinite(o["mean_r"])
        assert abs(o["hit_rate"] - w["hit_rate"]) < 0.1
    if form == "gated":
        assert out[0]["mean_trades"] < out[1]["mean_trades"]   # touch limit 2 < 4
    if form == "engine":
        assert all(isinstance(o["escalations"], int) for o in out)


def test_sweep_cuda_backend_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for form in SWEEP_FORMS.values():
        with pytest.raises(SystemExit, match="CUDA device"):
            cli.main(["--db", str(tmp_path / "t.db"), *SWEEP, *form, "--backend", "cuda"])


@pytest.mark.parametrize("flags", [["--sampler", "bootstrap"],
                                   ["--sampler", "block_bootstrap"],
                                   ["--bars-csv", "bars.csv"], ["--block-len", "5"],
                                   ["--engine", "--block-len", "5"]])
def test_sweep_unported_options_exit_clearly(tmp_path, flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["--db", str(tmp_path / "t.db"), *SWEEP, *flags, *CPU])


@pytest.mark.parametrize("flags", [["--touch-limits", "2"], ["--qmins", "0.5"],
                                   ["--engine", "--touch-limits", "2"]])
def test_sweep_gate_axes_require_gated(tmp_path, flags):
    with pytest.raises(SystemExit, match="require --gated"):
        cli.main(["--db", str(tmp_path / "t.db"), *SWEEP, *flags, *CPU])


@pytest.mark.parametrize("form, num_paths, num_bars, want", [
    ("first-contact", 16384, 40, "cuda"),
    ("first-contact", 12288, 40, "torch"),   # not a multiple of 8192 lanes
    ("gated", 16384, 40, "cuda"),
    ("gated", 16384, 41, "torch"),           # the kernels take an even W only
    ("engine", 4096, 40, "cuda"),
    ("engine", 4096, 62, "torch"),           # above the engine kernel's 61 bars
])
def test_sweep_auto_takes_the_kernel_only_when_the_shape_fits(
        monkeypatch, form, num_paths, num_bars, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    flags = {"first-contact": [], "gated": ["--gated"], "engine": ["--engine"]}[form]
    args = cli.build_parser().parse_args(
        ["sweep", "--num-paths", str(num_paths), "--num-bars", str(num_bars), *flags])
    assert cli._backend(args, [{"price": 100.0}] * 3) == want
