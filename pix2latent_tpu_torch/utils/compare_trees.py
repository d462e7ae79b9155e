"""Time ``chip_smoke.py``'s ``biggan_f32_path`` phase from two or more
checkouts in turns, on one card.

    python -m pix2latent_tpu_torch.utils.compare_trees \\
        old=path/to/checkout new=path/to/checkout

Each NAME=DIR is a checkout that holds ``chip_smoke.py`` and its package
(for an earlier commit: ``git archive <commit> | tar -x -C _chipwork/old``).
First every checkout builds its kernels, one process each, all started
together. Then the checkouts take turns, in the order given and then in
reverse (old, new, new, old), each turn a fresh process that imports the
checkout's own ``chip_smoke.py`` and package, times K1's float32 case at the
BigGAN-deep-256 shape (the phase reads K1's share of a step from it) and
runs the phase at ``chip_smoke.py``'s schedule (3 generations of 30 steps,
30 final steps), its results written to a temporary directory.
Prints the card's ``nvidia-smi`` line, the phase's JSON line of every turn
with ``"tree"`` added, and a last line with each checkout's images/s by turn
and their mean. Runs only on the card; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

GENERATIONS, FINAL_STEPS = 3, 30      # chip_smoke.py's biggan_f32_path

_CHILD = """
import importlib, sys, tempfile
root, build_only = sys.argv[1], sys.argv[2] == "build"
sys.path.insert(0, root)
import torch
cs = importlib.import_module("chip_smoke")
assert str(cs.ROOT) == root, (cs.ROOT, root)
cs.phase_build()
if not build_only:
    case = cs._attention_case(cs.FLAGSHIP, torch.float32, timed=True)
    with tempfile.TemporaryDirectory() as save_dir:
        cs.phase_biggan_f32_path({generations}, {final_steps}, [case],
                                 save_dir)
""".format(generations=GENERATIONS, final_steps=FINAL_STEPS)


def _run(root: Path, what: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", _CHILD, str(root), what],
                            cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _phase_line(proc: subprocess.Popen, name: str) -> dict:
    out, err = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}: exit {proc.returncode}\n{err[-3000:]}")
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    return next((d for d in lines if d.get("phase") == "biggan_f32_path"),
                lines[-1] if lines else {})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="NAME=DIR")
    args = ap.parse_args(argv)
    trees = {}
    for spec in args.trees:
        name, _, path = spec.partition("=")
        root = Path(path).resolve()
        if not (root / "chip_smoke.py").is_file():
            raise SystemExit(f"{spec}: no chip_smoke.py in {root}")
        trees[name] = root
    turns = list(trees) + list(reversed(trees))

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = {name: _run(root, "build") for name, root in trees.items()}
    for name, proc in builds.items():
        _phase_line(proc, f"build {name}")

    rates = {name: [] for name in trees}
    for name in turns:
        line = _phase_line(_run(trees[name], "phase"), name)
        print(json.dumps({"tree": name, **line}), flush=True)
        rates[name].append(line["images_per_sec"])
    print(json.dumps({"images_per_sec": {
        name: {"turns": r, "mean": statistics.mean(r)}
        for name, r in rates.items() if r}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
