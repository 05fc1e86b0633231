"""The port CLI's ``sweep [--gated | --engine] --sampler bootstrap |
block_bootstrap --bars-csv FILE --block-len L --device cpu`` against the JAX
CLI's ``sweep`` on the same history: its rows, in its order, with its keys
and grid values (the two draw their paths from different generators, so the
rates themselves are only checked to be finite)."""

import json

import numpy as np
import pytest
import torch

from qmmx_monolithic_monte_carlo_tpu.host import cli as jcli
from qmmx_monolithic_monte_carlo_tpu_torch.host import cli
from qmmx_monolithic_monte_carlo_tpu_torch.ops.pathgen import PathBars

from .test_torch_sampler_rows import BLOCK_LEN, HIST

torch.set_num_threads(2)


def _csv(path, hist):
    t = 60_000 * np.arange(hist.close.shape[0])
    with open(path, "w") as f:
        f.write("t,o,h,l,c,v\n")
        for i in range(t.shape[0]):
            f.write(f"{t[i]},{float(hist.open[i]):.2f},{float(hist.high[i]):.2f},"
                    f"{float(hist.low[i]):.2f},{float(hist.close[i]):.2f},"
                    f"{int(hist.volume[i])}\n")


def _lines(main, argv, capsys):
    assert main(argv) == 0
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("form", ["first contact", "gated", "engine"])
@pytest.mark.parametrize("sampler", ["bootstrap", "block_bootstrap"])
def test_cli_sweep_samplers_match_the_jax_cli(tmp_path, capsys, form, sampler):
    """``sweep [--gated | --engine] --device cpu --sampler ... --bars-csv``:
    the JAX CLI's rows, in its order, with its keys and grid values; finite
    rates."""
    _csv(tmp_path / "b.csv", PathBars(*(x[0] for x in HIST)))
    flags = {"first contact": [], "gated": ["--gated", "--touch-limits", "2", "4"],
             "engine": ["--engine", "--jitter-stds", "0", "0.02"]}[form]
    common = ["sweep", *flags, "--num-paths", "2048", "--num-bars", "8", "--stops", "0.3",
              "--tps", "0.2", "0.4", "--sampler", sampler, "--bars-csv",
              str(tmp_path / "b.csv"), "--block-len", str(BLOCK_LEN)]
    got = _lines(cli.main, ["--db", str(tmp_path / "t.db"), *common, "--device", "cpu"],
                 capsys)
    want = _lines(jcli.main, ["--db", str(tmp_path / "j.db"), *common], capsys)
    assert [list(r) for r in got] == [list(r) for r in want]
    grid_keys = ("stop_padding", "tp_padding", "touch_limit", "level_jitter_std")
    assert [[r.get(k) for k in grid_keys] for r in got] == \
        [[r.get(k) for k in grid_keys] for r in want]
    assert len(got) == {"first contact": 2, "gated": 4, "engine": 4}[form]
    for r in got:
        assert 0.0 < r["hit_rate"] < 1.0 and np.isfinite(r["mean_r"])
