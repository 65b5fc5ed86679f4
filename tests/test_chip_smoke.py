"""chip_smoke.py and bench.py off the card: both refuse a CPU device, the
smoke test's phases run at toy size on the CPU backend, and its last line
keeps the contract's keys."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 1
    assert capsys.readouterr().out == ""


def test_refuses_to_run_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_result_line_has_exactly_the_contract_keys():
    line = json.loads(chip_smoke.result_line(jax.devices()[:1]))
    assert set(line) == {"ok", "device"} and line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == 1


def test_check_close_reports_and_raises(capsys):
    chip_smoke.check_close("a", [1.0, 2.0], [1.0, 2.0005], atol=1e-3, reason="r")
    assert "max|Δ| 5.000e-04" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="b:"):
        chip_smoke.check_close("b", [1.0], [1.1], atol=1e-3, reason="r")
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.check_equal("c", [1, 2], [1, 3], "r")


def test_phase_regression():
    chip_smoke.phase_regression()


def test_phase_forward_toy():
    chip_smoke.phase_forward(grid=32, n_rays=256, budget=300, n_sub=64)


def test_phase_train_toy():
    step = chip_smoke.phase_train(grid=32, n_rays=256, budget=128,
                                  chunk_steps=16, n_sub=64)
    new, loss = step()
    assert np.isfinite(float(loss))


def test_phase_render_toy():
    chip_smoke.phase_render(grid=24, width=32, crop=8, budget=256)


def test_phase_four_toy():
    assert jax.device_count() >= 4
    chip_smoke.phase_four(grid=34, n_rays=64, budget=64, chunk_steps=16,
                          k_steps=8)


@pytest.mark.parametrize("n_rays", [1024, bench.N_RAYS])
def test_bench_rays_are_exact(n_rays):
    pos, dirs = bench.build_rays(n_rays)
    assert pos.shape == dirs.shape == (n_rays, 3)
    assert len(np.unique(np.asarray(pos), axis=0)) == n_rays


def test_bench_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main([])


def test_trace_summary_needs_a_gpu_plane(tmp_path):
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(jax.numpy.ones(4) * 2)
    with pytest.raises(RuntimeError, match="no GPU plane"):
        bench.summarize_trace(tmp_path, 1)


def test_hlo_kernels_finds_gathers_and_scatters():
    """The trace reduction tells gather and scatter fusions apart by their
    compiled HLO (checked on a CPU compile of the SGD step)."""
    ior = jax.numpy.ones((12, 10, 10), jax.numpy.float32)
    pos, dirs = bench.build_rays(16, 10)
    step = bench.make_sgd_step(budget=8, chunk_steps=4)
    info = bench.hlo_kernels(step.lower(ior, pos, dirs).compile().as_text())
    assert any(k["gather"] for k in info.values())
    assert any(k["scatter"] for k in info.values())
    assert all(set(k) == {"elements", "gather", "scatter"} for k in info.values())
