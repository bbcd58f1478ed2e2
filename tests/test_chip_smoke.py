"""chip_smoke.py on the CPU: it refuses to report without a GPU, and its
phase functions run end to end at a tiny size (kernels interpreted)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from icp_tpu.io.csv import load_matrix, write_matrix

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tiny(tmp_path, monkeypatch, capsys):
    """Subsampled copies of the workload files; phase output in tmp_path."""
    monkeypatch.setattr(cs, "OUT", str(tmp_path))

    def sub(name, k):
        path = str(tmp_path / f"{name}.txt")
        write_matrix(load_matrix(os.path.join(cs.DATA, name + ".txt"))[::k],
                     path)
        return path

    return sub


def test_main_without_gpu_exits_nonzero_and_prints_no_result(capsys):
    rc = cs.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_unknown_phase_is_refused():
    with pytest.raises(SystemExit):
        cs.main(["--only", "no_such_phase"])


def test_gates_raise():
    with pytest.raises(AssertionError, match="gate missed"):
        cs.check(False, "anything")
    p = np.zeros((4, 3))
    model = np.array([[0.0, 0, 0], [1, 0, 0]])
    with pytest.raises(AssertionError):
        # index 1 is farther than the true NN (index 0) for every row
        cs.nn_agreement(p, model, np.ones(4, int), np.ones(4),
                        np.zeros(4, int), np.zeros(4), "wrong")


def test_phase_kernels_tiny(tiny, capsys):
    cs.phase_kernels(cow_n=200, horse_n=300, million=2000, sample_rows=128)
    out = capsys.readouterr().out
    assert out.count("[gate] ok") >= 7
    assert "[memory] icp step horse" in out


def test_phase_cow_and_horse_tiny(tiny, capsys):
    cs.phase_cow(tiny("cow_ref", 10), tiny("cow_tr1", 10))
    cs.phase_horse(tiny("horse_ref", 200), tiny("horse_tr1", 200), iters=30)
    out = capsys.readouterr().out
    assert "cow RMSE against cow_ref" in out
    assert "horse err within 1%" in out


def test_phase_bunny_tiny(tiny, capsys):
    paths = [tiny(v, 200) for v in cs.BUNNY]
    cs.phase_bunny(paths, {"p2p": [], "p2pl": ["--engine", "point_to_plane"]})
    out = capsys.readouterr().out
    assert out.count("<= plain XLA + 1%") == 8


def test_phase_million_tiny(tiny, capsys):
    # the kd-grid engine (interpreted here) against the blocked XLA engine
    cs.phase_million(n=2000, iters=10, nn_method="grid")
    out = capsys.readouterr().out
    assert "resolves to grid" in out
    assert "1M registered points match the plain XLA path" in out


def test_phase_four_cards_tiny(tiny, capsys):
    # 4 of the suite's 8 virtual CPU devices stand in for the four cards
    cs.phase_four_cards(n=1024, iters=5)
    out = capsys.readouterr().out
    assert "icp_sharded_2d matches" in out
    assert "bundle_adjust_sharded matches" in out


def test_phase_timings_tiny(tiny, capsys):
    cs.phase_timings("cpu", horse_n=300, million=1024, reps=2, knn_clouds=(),
                     sweep=(256,), knn_sweep=(128,))
    out = capsys.readouterr().out
    assert "icp iteration cow nn=bcast solver=qcp" in out
    assert "nn_dense kernel 1024x1024" in out


def test_result_line_contract(monkeypatch, capsys, tmp_path):
    """With a GPU reported, main prints the card line and then exactly the
    result JSON as its last line."""
    import jax

    import icp_tpu.utils.cache as cache

    class FakeGPU:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGPU()])
    monkeypatch.setattr(cs, "card_line", lambda: "NVIDIA H100, 700.00 W")
    monkeypatch.setattr(cache, "enable_compile_cache", lambda: "cache")
    monkeypatch.setattr(cs, "OUT", str(tmp_path))
    ran = []
    monkeypatch.setattr(cs, "phase_cow", lambda: ran.append("cow"))
    assert cs.main(["--only", "cow"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert ran == ["cow"]
    assert lines[-2] == "card: NVIDIA H100, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
