"""chip_smoke.py --four at small shapes on 4 virtual CPU devices: every
multi-card mode it runs on the cards agrees with the single-device result
(exact modes bit for bit)."""

import sys
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import chip_smoke  # noqa: E402


def test_four_checks_small_on_virtual_devices():
    chip_smoke.four_checks(jax.devices()[:4],
                           ((96, 128), (64, 96), (48, 96)), max_disp=16)
