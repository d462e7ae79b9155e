"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
the reference loads nothing of the port."""

import subprocess
import sys

from p2l_bench.harness import env
from p2l_bench.harness.spec import ROOT


def test_top_level_names_compared_whole(monkeypatch):
    fake = {"pix2latent_tpu_torch": 1, "pix2latent_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert env.forbidden_modules() == []
    for name in ("jax", "jax.numpy", "jaxlib.xla", "flax.linen",
                 "pix2latent_tpu", "pix2latent_tpu.ops"):
        monkeypatch.setattr(sys, "modules", {**fake, name: 1})
        assert env.forbidden_modules() == [name]


def _loaded_after(imports):
    code = (f"import sys; {imports}; print(sorted({{n.split('.')[0] "
            "for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_and_port_load_no_jax():
    loaded = _loaded_after(
        "import p2l_bench.run, p2l_bench.calibrate, p2l_bench.harness.cell, "
        "p2l_bench.problems.biggan, p2l_bench.problems.stylegan2, "
        "p2l_bench.flops.model, pix2latent_tpu_torch.optimizers, "
        "pix2latent_tpu_torch.examples.common, "
        "pix2latent_tpu_torch.parallel")
    assert "pix2latent_tpu_torch" in loaded
    assert not set(loaded) & set(env.FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(
        "import p2l_bench.reference.biggan, p2l_bench.reference.stylegan2, "
        "p2l_bench.reference.loss, p2l_bench.reference.optim")
    assert "pix2latent_tpu_torch" not in loaded
    assert not set(loaded) & set(env.FORBIDDEN)
