"""chip_smoke.py: the helpers that need no card, and its refusal to
report a result where there is no GPU."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from fsgm_tpu.io.synthetic import constant_flow_pair  # noqa: E402


def test_final_line_is_the_contract():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "jax": "0.9.0"}
    assert json.loads(chip_smoke.final_line(True, dev)) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3",
                               "count": 1}}


def test_final_line_on_failure_names_the_phase():
    rec = json.loads(chip_smoke.final_line(False, None, failed_phase="x"))
    assert rec == {"ok": False, "failed_phase": "x"}


def test_stereo_gt_check_accepts_truth_and_rejects_noise():
    rng = np.random.default_rng(0)
    gt = rng.integers(0, 64, (60, 200)).astype(np.float64)
    assert chip_smoke.stereo_gt_check(gt, gt, 64)["ok"]
    off = gt + 3.0
    assert not chip_smoke.stereo_gt_check(off, gt, 64)["ok"]
    invalid = np.full_like(gt, -1.0)
    assert not chip_smoke.stereo_gt_check(invalid, gt, 64)["ok"]


def test_flow_gt_check_accepts_truth_and_rejects_noise():
    _, _, gt = constant_flow_pair(64, 80, 3, -2, seed=0)
    valid = np.ones(gt.shape[:2], bool)
    assert chip_smoke.flow_gt_check(gt, valid, gt)["ok"]
    assert not chip_smoke.flow_gt_check(gt + 2.0, valid, gt)["ok"]
    assert not chip_smoke.flow_gt_check(gt, ~valid, gt)["ok"]


def test_bad_arguments_print_usage():
    assert chip_smoke.main(["--bogus"]) == 2


def _run(args, cwd):
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("PYTHONPATH",)}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_gpu_means_no_result():
    """On the CPU the device phase fails: non-zero exit, and no
    {"ok": true} line."""
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_script_alone_fails(tmp_path):
    """Copied into a directory without the rest of the repo it cannot
    import the program, and fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([str(tmp_path / "chip_smoke.py")], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture
def gpu():
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU; run `python chip_smoke.py` on the card")


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu):
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["ok"] is True
