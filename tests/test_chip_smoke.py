"""The CPU-checkable parts of chip_smoke.py, bench.py and their helpers:
refusing a non-GPU backend, reading nvidia-smi, choosing phases, and the
agreement bars every chip check is held to."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke
from ldpc_decoders_tpu.utils import compare, device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dev(platform, kind="NVIDIA H100 80GB HBM3"):
    return SimpleNamespace(platform=platform, device_kind=kind)


@pytest.mark.parametrize("backend,devices", [
    ("cpu", [_dev("cpu", "cpu")]),
    ("METAL", [_dev("METAL", "Apple M2")]),
    ("gpu", []),
    ("gpu", [_dev("gpu"), _dev("cpu", "cpu")]),
], ids=["cpu", "metal", "no-devices", "mixed"])
def test_device_info_refuses_non_gpu(backend, devices):
    with pytest.raises(device.NoGPUError):
        device.device_info(backend, devices)


def test_device_info_reports_gpu():
    info = device.device_info("gpu", [_dev("gpu")] * 4)
    assert info == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                    "count": 4}


def test_require_gpu_refuses_the_test_backend():
    """The tests run on the CPU backend: the measurement paths' guard
    must refuse it rather than fall back."""
    with pytest.raises(device.NoGPUError, match="cpu"):
        device.require_gpu()


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W",
     [("NVIDIA H100 80GB HBM3", "500.00 W"),
      ("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("Some, Card, With Commas, [N/A]", [("Some, Card, With Commas",
                                         "[N/A]")]),
], ids=["one", "four-card-host", "commas"])
def test_parse_nvidia_smi(text, want):
    assert device.parse_nvidia_smi(text) == want


@pytest.mark.parametrize("text", ["", "no comma here", ", 700 W"])
def test_parse_nvidia_smi_rejects_malformed(text):
    with pytest.raises(ValueError):
        device.parse_nvidia_smi(text)


@pytest.mark.parametrize("chips,want", [
    (1, ("device", "cli", "campaign", "lt", "families", "routes")),
    (4, ("device", "mesh")),
])
def test_select_phases(chips, want):
    assert chip_smoke.select_phases(chips) == want


def test_select_phases_rejects_other_counts():
    with pytest.raises(ValueError):
        chip_smoke.select_phases(2)


@pytest.mark.parametrize("dec,it,n,ok", [
    (0, 0, 100, True),
    (1, 3, 100, True),      # exactly at both limits
    (2, 0, 100, False),     # decisions over 1%
    (0, 4, 100, False),     # iterations over 3%
    (40, 122, 4096, True),
])
def test_within_float_bar(dec, it, n, ok):
    assert compare.within_float_bar(dec, it, n) is ok


def test_mismatch_counts_counts_words():
    x_a = np.zeros((4, 6), np.int32)
    x_b = x_a.copy()
    x_b[1, :3] = 1          # one word, three bits
    x_b[3, 5] = 1
    it_a = np.array([1, 2, 3, 4])
    it_b = np.array([1, 2, 5, 4])
    assert compare.mismatch_counts(x_a, it_a, x_b, it_b) == (2, 1)
    assert compare.mismatch_counts(x_a, None, x_a, None) == (0, 0)
    with pytest.raises(ValueError):
        compare.mismatch_counts(x_a, None, x_a[:2], None)


def test_wer_sigma_gap():
    assert compare.wer_sigma_gap(0.5, 100, 0.5, 100) == 0.0
    assert compare.wer_sigma_gap(0.0, 10, 0.0, 10) == 0.0
    assert compare.wer_sigma_gap(0.0, 10, 1.0, 10) == pytest.approx(
        np.sqrt(20))
    gap = compare.wer_sigma_gap(0.2, 10000, 0.19453125, 10240)
    assert 0.9 < gap < 1.0
    # No errors in one chunk against a curve that needed 254k words for
    # 109 (7 expected errors here): unremarkable, not ~10 sigma.
    gap = compare.wer_sigma_gap(0.0, 16384, 109 / 253952, 253952)
    assert 2.0 < gap < 3.0


def test_float_bar_line_reports_counts():
    line, ok = chip_smoke.float_bar_line("BSC MSA", "f32", 1, 2, 100)
    assert ok and "1/100" in line and "2/100" in line and "f32" in line
    line, ok = chip_smoke.float_bar_line("BSC MSA", "f32", 5, 0, 100)
    assert not ok and line.endswith("FAIL")


def _run(cmd, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   p for p in (cwd, os.environ.get("PYTHONPATH")) if p))
    return subprocess.run([sys.executable] + cmd, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_without_gpu(script):
    """No accelerator: non-zero exit and no result line."""
    r = _run([script], REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "codewords/s" not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repo, the script has nothing to drive."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_golden_gaps_matches_points_by_value():
    """Saver keys are str(float): a stepped sweep writes
    '0.09000000000000001' where the committed curve has '0.09'."""
    out = {"tot": {"0.09000000000000001": 1000, "0.1": 1000},
           "wer": {"0.09000000000000001": 0.1, "0.1": 0.5}}
    golden = {"tot": {"0.1": 1000, "0.09": 1000},
              "wer": {"0.1": 0.5, "0.09": 0.1}}
    rows = chip_smoke.golden_gaps(out, golden)
    assert [(r[0], r[-2], r[-1]) for r in rows] == [
        ("0.09000000000000001", 0.0, 0.0), ("0.1", 0.0, 0.0)]
    out["wer"]["0.1"] = 0.45        # allowance 5 * 0.0222 + 0.01 = 0.121
    z, frac = chip_smoke.golden_gaps(out, golden)[1][-2:]
    assert z < -2 and 0.4 < frac < 0.42
    out["wer"]["0.1"] = 0.35
    assert chip_smoke.golden_gaps(out, golden)[1][-1] > 1
    del golden["tot"]["0.09"]
    with pytest.raises(chip_smoke.SmokeFailure, match="no point"):
        chip_smoke.golden_gaps(out, golden)


def test_lt_mean_gap():
    rng = np.random.default_rng(0)
    golden = rng.normal(10400, 100, 2750)
    assert chip_smoke.lt_mean_gap(golden[:8], golden) < 4
    assert chip_smoke.lt_mean_gap(golden[:8] + 300, golden) > 4


def test_campaign_cli_passes_max_words(monkeypatch):
    """chip_smoke bounds each REG_ENS point through the campaign CLI."""
    from ldpc_decoders_tpu import campaign

    seen = {}
    monkeypatch.setattr(campaign, "run_campaign",
                        lambda cases, **kw: seen.update(cases=cases, **kw))
    campaign.main(chip_smoke.CAMPAIGN_ARGS + ["--data_dir", "unused"])
    assert seen["cases"] == ["REG_ENS"]
    assert seen["overrides"] == {"batch": 16384, "max_words": 16384}
    assert seen["use_ensemble"] and not seen["joint_ensemble"]
