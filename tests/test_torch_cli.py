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


@pytest.mark.parametrize("flags", [["--sampler", "heston"], ["--engine"],
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
    (False, 16384, 25, "cuda"),
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


def test_paths_gated_cuda_backend_refuses_an_odd_bar_count(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="even --num-bars"):
        cli.main(["--db", str(tmp_path / "t.db"), "paths", "--gated",
                  "--num-paths", "16384", "--num-bars", "25", "--backend", "cuda"])


def test_paths_cuda_backend_refuses_the_cpu_device(tmp_path):
    with pytest.raises(SystemExit, match="--device cuda"):
        cli.main(["--db", str(tmp_path / "t.db"), *GATED, "--backend", "cuda",
                  *CPU])
