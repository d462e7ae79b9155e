"""The checkout-comparison tool's turns, output and errors.

``utils/compare_trees.py`` runs ``chip_smoke.py``'s ``biggan_f32_path`` from
several checkouts in turns on the card; here, on the CPU, each checkout is a
stand-in ``chip_smoke.py`` whose phase prints a fixed images/s.
"""

import json
import types

import pytest

from pix2latent_tpu_torch.utils import compare_trees as CT

_FAKE = '''
import json, sys
from pathlib import Path
ROOT = Path(__file__).resolve().parent
FLAGSHIP = (18, 4096, 1024, 64, 256)
RATE = float((ROOT / "rate.txt").read_text())

def phase_build():
    print(json.dumps({"phase": "build"}))

def _attention_case(shape, dtype, timed):
    return {"kernel": "sagan_attention", "shape": list(shape)}

def phase_biggan_f32_path(generations, final_steps, cases, save_dir):
    if RATE < 0:
        sys.exit("the phase failed")
    print(json.dumps({"phase": "biggan_f32_path", "images_per_sec": RATE,
                      "schedule": [generations, final_steps],
                      "k1_shape": cases[0]["shape"],
                      "save_dir_exists": Path(save_dir).is_dir()}))
'''


def _checkout(tmp_path, name, rate):
    root = tmp_path / name
    root.mkdir()
    (root / "chip_smoke.py").write_text(_FAKE)
    (root / "rate.txt").write_text(str(rate))
    return f"{name}={root}"


@pytest.fixture
def no_smi(monkeypatch):
    monkeypatch.setattr(CT.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(stdout="card, limit\n"))


def test_checkouts_take_turns_and_are_averaged(tmp_path, capsys, no_smi):
    trees = [_checkout(tmp_path, "old", 70.0), _checkout(tmp_path, "new",
                                                         80.0)]
    assert CT.main(trees) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card, limit"
    runs = [json.loads(line) for line in lines[1:-1]]
    assert [r["tree"] for r in runs] == ["old", "new", "new", "old"]
    assert all(r["schedule"] == [CT.GENERATIONS, CT.FINAL_STEPS]
               and r["k1_shape"] == [18, 4096, 1024, 64, 256]
               and r["save_dir_exists"] for r in runs)
    summary = json.loads(lines[-1])["images_per_sec"]
    assert summary == {"old": {"turns": [70.0, 70.0], "mean": 70.0},
                       "new": {"turns": [80.0, 80.0], "mean": 80.0}}


def test_bad_arguments_and_a_failed_phase_raise(tmp_path, no_smi):
    good = _checkout(tmp_path, "good", 1.0)
    with pytest.raises(SystemExit, match="no chip_smoke.py"):
        CT.main([good, f"empty={tmp_path}"])
    with pytest.raises(RuntimeError, match="the phase failed"):
        CT.main([_checkout(tmp_path, "bad", -1.0)])

