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


@pytest.mark.parametrize("flags", [["--sampler", "heston", "--exact-tail"],
                                   ["--engine", "--exact-tail"],
                                   ["--exact-tail"], ["--ckpt-dir", "ck"],
                                   ["--sampler", "bootstrap", "--ckpt-dir", "ck"]])
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
    (False, 16384, 130, "cuda"),     # past 128 bars: the long-horizon first-contact kernels
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
    """The first-contact and gated kernels take an even W and 8 levels; the
    engine's take any W and 64 levels."""
    flags = {"first-contact": [], "gated": ["--gated"], "engine": ["--engine"]}[path]
    args = cli.build_parser().parse_args(
        ["paths", "--num-paths", "16384", "--num-bars", str(num_bars), *flags])
    rows = [{"price": 100.0}] * 3
    if num_bars % 2 and path != "engine":
        assert "even --num-bars" in cli._fits(args, rows)
    else:
        assert cli._fits(args, rows) is None
    if path == "engine":
        assert cli._fits(args, rows * 3) is None
        assert "64 levels" in cli._fits(args, rows * 22)
    else:
        assert "8 levels" in cli._fits(args, rows * 3)


@pytest.mark.parametrize("num_paths, num_bars, fits", [
    (16384, 40, True), (16384 + 1024, 40, False), (16384, 62, True)])
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
def test_sweep_unported_options_exit_clearly(tmp_path, capsys, flags):
    """These options were refused ("not ported yet") until the sweeps took
    the recorded-bar samplers; now each runs on the CPU: one row per grid
    point in grid order, and a sampler's rows differ from the gbm sweep's
    while ``--bars-csv`` or ``--block-len`` alone (gbm reads neither) leave
    them as they are.  ``--bars-csv`` reads a history written here."""
    rng = np.random.default_rng(2)
    c = np.round(100.0 + np.cumsum(rng.normal(0, 0.05, 300)), 2)
    with open(tmp_path / "bars.csv", "w") as f:
        f.write("t,o,h,l,c,v\n" + "".join(f"{60_000 * i},{c[i]:.2f},{c[i] + 0.03:.2f},"
                                          f"{c[i] - 0.03:.2f},{c[i]:.2f},1000\n"
                                          for i in range(300)))
    flags = [str(tmp_path / f) if f == "bars.csv" else f for f in flags]
    base = [*SWEEP, *CPU, "--num-paths", "2048", "--num-bars", "8", "--stops", "0.3"]
    rows = _rows(cli.main, ["--db", str(tmp_path / "t.db"), *base, *flags], capsys)
    gbm = _rows(cli.main, ["--db", str(tmp_path / "g.db"), *base,
                           *[f for f in flags if f == "--engine"]], capsys)
    assert len(rows) == len(gbm) == 3
    assert [(r["stop_padding"], r["tp_padding"]) for r in rows] == \
        [(g["stop_padding"], g["tp_padding"]) for g in gbm]
    assert all(0.0 <= r["hit_rate"] <= 1.0 and np.isfinite(r["mean_r"]) for r in rows)
    if "--sampler" in flags:
        assert rows != gbm
    else:
        assert rows == gbm


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
    ("engine", 4096, 62, "cuda"),            # the windowed guard's envelope kernel
])
def test_sweep_auto_takes_the_kernel_only_when_the_shape_fits(
        monkeypatch, form, num_paths, num_bars, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    flags = {"first-contact": [], "gated": ["--gated"], "engine": ["--engine"]}[form]
    args = cli.build_parser().parse_args(
        ["sweep", "--num-paths", str(num_paths), "--num-bars", str(num_bars), *flags])
    assert cli._backend(args, [{"price": 100.0}] * 3) == want


# ---- the engine's envelope: 1-64 levels, any W >= 2 (even in a book)

def _ladder_rows(n, s0=100.0, step=0.12):
    """tests/test_engine_envelope.py's n-level ladder as DB rows."""
    return [{"color": ("blue", "orange", "black", "teal")[i % 4],
             "type": "solid" if (i // 4) % 2 == 0 else "dashed", "index": i // 8,
             "price": round(s0 + (i - n // 2) * step, 2)} for i in range(n)]


@pytest.mark.parametrize("num_bars", [25, 62, 390])
def test_fits_takes_30_levels_at_any_engine_horizon(num_bars):
    for cmd in ("paths", "sweep"):
        args = cli.build_parser().parse_args(
            [cmd, "--engine", "--num-paths", "16384", "--num-bars", str(num_bars)])
        assert cli._fits(args, _ladder_rows(30)) is None
        assert cli._fits(args, _ladder_rows(64)) is None


def test_fits_names_the_64_level_cap_and_auto_takes_the_pipeline_past_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    args = cli.build_parser().parse_args(
        ["paths", "--engine", "--num-paths", "16384", "--num-bars", "390"])
    assert "at most 64 levels" in cli._fits(args, _ladder_rows(65))
    assert cli._backend(args, _ladder_rows(65)) == "torch"
    assert cli._backend(args, _ladder_rows(64)) == "cuda"
    args.backend = "cuda"
    with pytest.raises(SystemExit, match="at most 64 levels"):
        cli._backend(args, _ladder_rows(65))


def test_fits_names_an_even_horizon_for_the_engine_book():
    args = cli.build_parser().parse_args(
        ["book", "--engine", "--num-paths", "16384", "--num-bars", "25"])
    assert "even --num-bars" in cli._fits(args, _ladder_rows(2))
    args.num_bars = 62
    assert cli._fits(args, _ladder_rows(2)) is None


def test_paths_engine_on_a_30_level_db_at_an_odd_horizon(tmp_path, capsys):
    """``paths --engine --device cpu`` on a 30-level DB at W = 25 prints the
    totals of the plain pipeline (``sim.enginepath.mc_paths_engine``) on the
    DB's 30 levels at the same seed."""
    from qmmx_monolithic_monte_carlo_tpu_torch.config import EngineParams
    from qmmx_monolithic_monte_carlo_tpu_torch.sim import enginepath
    from qmmx_monolithic_monte_carlo_tpu_torch.types import Levels

    path = str(tmp_path / "t.db")
    conn = db.db_connect(path)
    db.db_init(conn)
    rows = _ladder_rows(30)
    db.replace_levels(conn, rows)
    conn.close()
    out = _run(cli.main, ["--db", path, "paths", "--engine", "--num-paths", "4096",
                          "--num-bars", "25", *CPU], capsys)
    conn = db.db_connect(path)
    levels = Levels.from_rows(db.load_levels(conn), max_levels=64)
    conn.close()
    stats, skips, escal = enginepath.mc_paths_engine(
        0, levels, EngineParams.default(), num_paths=4096, num_bars=25, s0=100.0, sigma=0.3,
        block_paths=4096, device="cpu")
    assert out["paths"] == 4096.0 and out["trades"] == float(stats.sum_trades) > 0
    assert out["entered"] == float(stats.n_entered)
    assert out["mean_r"] == pytest.approx(float(stats.mean_r), abs=1e-6)
    assert out["escalations"] == int(escal)
    assert out["skips"] == {r.name: int(n) for r, n in
                            zip(enginepath.SKIP_REASONS, skips.tolist()) if n}
