"""scripts/run_sims.sh's scheduling, with stand-ins for python and
nvidia-smi: SEQL stops at the first failed line; PARA runs one worker
per visible GPU (one process per line without a GPU), carries on past a
failed line, and exits non-zero if any line failed."""

import os
import stat
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Stand-in for python: `-m ...campaign --emit` lists four lines, `-u -m
# ...main <line>` records where it ran and fails on the line "bad".
FAKE_PYTHON = """#!/usr/bin/env bash
if [[ " $* " == *" --emit "* ]]; then printf '%s\\n' $EMIT_LINES; exit 0; fi
echo "$4 ${CUDA_VISIBLE_DEVICES-none}" >> "$RUN_LOG"
[ "$4" != bad ]
"""


def _exe(path, text):
    with open(path, "w") as f:
        f.write(text)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)


def _run(tmp_path, mode, lines, visible=None, smi_cards=None):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    _exe(bin_dir / "python", FAKE_PYTHON)
    _exe(bin_dir / "nvidia-smi", "#!/usr/bin/env bash\n" + (
        f"printf '%s\\n' {' '.join(smi_cards)}\n" if smi_cards
        else "exit 9\n"))
    log = tmp_path / "runs.log"
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               EMIT_LINES=" ".join(lines), RUN_LOG=str(log))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    if visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = visible
    r = subprocess.run(["bash", os.path.join(REPO, "scripts", "run_sims.sh"),
                        mode, "CASE"], env=env, capture_output=True,
                       text=True, timeout=60)
    runs = sorted(log.read_text().split("\n")[:-1]) if log.exists() else []
    return r, runs


def test_seql_stops_at_first_failure(tmp_path):
    r, runs = _run(tmp_path, "SEQL", ["ok1", "bad", "ok2"])
    assert r.returncode != 0
    assert runs == ["bad none", "ok1 none"]


@pytest.mark.parametrize("visible,smi,cards", [
    ("3,5", None, ("3", "5")),
    (None, ["0", "1"], ("0", "1")),
], ids=["cuda-visible-devices", "nvidia-smi"])
def test_para_one_worker_per_card_survives_failure(tmp_path, visible, smi,
                                                   cards):
    """Line i goes to card i % 2; ok3 shares a worker with the failed
    line and still runs."""
    r, runs = _run(tmp_path, "PARA", ["ok1", "bad", "ok2", "ok3"],
                   visible=visible, smi_cards=smi)
    assert r.returncode == 1
    assert "!! failed: bad" in r.stderr
    assert "run_sims done" not in r.stdout
    assert runs == sorted([f"ok1 {cards[0]}", f"bad {cards[1]}",
                           f"ok2 {cards[0]}", f"ok3 {cards[1]}"])


def test_para_without_gpu_runs_every_line(tmp_path):
    r, runs = _run(tmp_path, "PARA", ["ok1", "bad", "ok2"])
    assert r.returncode == 1
    assert runs == ["bad none", "ok1 none", "ok2 none"]


@pytest.mark.parametrize("mode", ["SEQL", "PARA"])
def test_all_lines_pass(tmp_path, mode):
    r, runs = _run(tmp_path, mode, ["ok1", "ok2"], visible="0")
    assert r.returncode == 0, r.stderr
    assert "run_sims done" in r.stdout
    assert runs == ["ok1 0", "ok2 0"]
