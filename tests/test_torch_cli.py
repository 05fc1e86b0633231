"""The port CLI's ``paths`` subcommand against the JAX CLI's output contract."""

import json

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.host import cli as jcli
from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
from qmmx_monolithic_monte_carlo_tpu_torch.io import db

torch.set_num_threads(2)

ARGS = ["paths", "--num-paths", "16384", "--num-bars", "24"]


def _run(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_paths_torch_backend_prints_the_jax_cli_keys(tmp_path, capsys):
    out = _run(cli.main, ["--db", str(tmp_path / "t.db"), *ARGS,
                          "--backend", "torch"], capsys)
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
    out = _run(cli.main, ["--db", path, *ARGS, "--backend", "auto"], capsys)
    # a zero proximity almost never touches a single level exactly
    assert out["entered"] < 0.01 * out["paths"]


def test_paths_noise_and_antithetic(tmp_path, capsys):
    out = _run(cli.main, ["--db", str(tmp_path / "t.db"), *ARGS, "--backend",
                          "torch", "--antithetic", "--entry-slip-std", "0.01",
                          "--level-jitter-std", "0.02"], capsys)
    assert all(np.isfinite(v) for v in out.values())


def test_paths_cuda_backend_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA device"):
        cli.main(["--db", str(tmp_path / "t.db"), *ARGS, "--backend", "cuda"])


@pytest.mark.parametrize("flags", [["--gated"], ["--engine"], ["--exact-tail"],
                                   ["--ckpt-dir", "ck"],
                                   ["--sampler", "bootstrap"]])
def test_unported_options_exit_clearly(tmp_path, flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["--db", str(tmp_path / "t.db"), *ARGS, *flags])
