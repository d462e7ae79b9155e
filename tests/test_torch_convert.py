"""The port's checkpoint conversion against the JAX package's, on the
synthetic ``pytorch_pretrained_biggan``, rosinality StyleGAN2 and lpips state
dicts of the JAX golden tests (numpy-seeded):

- ``convert_torch_biggan`` gives the JAX converter's tree leaf for leaf,
  bitwise, with plain weights and with spectral norm stored as
  ``weight_orig`` / ``weight_u`` (baked from the stored ``u``);
- a ``.npz`` written by the port's CLI loads in the JAX package's
  ``load_params_npz`` and a JAX-written one in the port's, bitwise;
- a ``.pth`` loaded by the port's ``BigGAN`` gives the JAX BigGAN's forward
  on the same state dict within rel 1e-4 in float32, at a tiny width;
- the CLI's stylegan2 and lpips kinds write the port converters' trees
  (equal to the JAX converters'), and the port's models load them;
- the CLI prints the JAX CLI's report.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.models.biggan import BigGAN as JaxBigGAN
from pix2latent_tpu.models.biggan import \
    convert_torch_biggan as jax_convert_biggan
from pix2latent_tpu.utils.params_io import \
    load_params_npz as jax_load_params_npz
from pix2latent_tpu.utils.params_io import \
    save_params_npz as jax_save_params_npz
from pix2latent_tpu_torch.models.biggan import BigGAN, convert_torch_biggan
from pix2latent_tpu_torch.scripts import convert
from pix2latent_tpu_torch.utils.params_io import (_flatten, load_params_npz,
                                                  save_params_npz)
from tests.test_biggan_golden import make_state_dict

ROOT = Path(__file__).resolve().parents[1]
VERSION, CH = "biggan-deep-128", 8


def _with_sn(sd, seed=1):
    """``sd`` with every generator conv and linear weight stored as torch's
    spectral norm does: ``weight_orig`` and a unit ``weight_u``."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in sd.items():
        if k.startswith("generator.") and k.endswith(".weight") \
                and v.dim() >= 2:
            base = k[:-len("weight")]
            out[base + "weight_orig"] = v
            u = rng.randn(v.shape[0]).astype(np.float32)
            out[base + "weight_u"] = torch.tensor(u / np.linalg.norm(u))
        else:
            out[k] = v
    return out


def _state_dict(sn):
    sd = make_state_dict(np.random.RandomState(0), VERSION, CH)
    return _with_sn(sd) if sn else sd


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in _flatten(
        {k: v for k, v in tree.items()}).items()}


@pytest.mark.parametrize("sn", [False, True], ids=["plain", "spectral_norm"])
def test_biggan_converter_matches_jax_leaf_for_leaf(sn):
    sd = _state_dict(sn)
    want = _flat_np(jax_convert_biggan(sd, VERSION))
    got = _flat_np(convert_torch_biggan(sd, VERSION))
    assert sorted(got) == sorted(want)
    for k in want:                          # tolerance: bitwise
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if sn:                                  # the baking divided by sigma
        key = "generator/gen_z/kernel"
        raw = sd["generator.gen_z.weight_orig"].numpy().T
        assert not np.allclose(got[key], raw)


def test_npz_files_cross_between_the_packages(tmp_path):
    sd = _state_dict(sn=True)
    pth = tmp_path / "G.pth"
    torch.save(sd, pth)
    port_npz = tmp_path / "port.npz"
    report = convert.main(["biggan", str(pth), str(port_npz),
                           "--model", VERSION])
    want = _flat_np(jax_convert_biggan(sd, VERSION))
    assert {k: tuple(v) for k, v in report.items()} == {
        k: v.shape for k, v in want.items()}
    # the port's file in the JAX package
    from_jax = _flat_np(jax_load_params_npz(str(port_npz)))
    assert sorted(from_jax) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(from_jax[k], want[k], err_msg=k)
    # the JAX package's file in the port
    jax_npz = tmp_path / "jax.npz"
    jax_save_params_npz(str(jax_npz), jax_convert_biggan(sd, VERSION))
    from_port = load_params_npz(str(jax_npz))
    assert sorted(from_port) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(from_port[k], want[k], err_msg=k)
    # and the port's save of a nested tree reads as the JAX package's
    again = tmp_path / "again.npz"
    save_params_npz(str(again), convert_torch_biggan(sd, VERSION))
    for k, v in load_params_npz(str(again)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_pth_loaded_biggan_matches_the_jax_forward(tmp_path):
    sd = _state_dict(sn=True)
    pth = tmp_path / "G.pth"
    torch.save(sd, pth)
    port = BigGAN(VERSION, pretrained_path=str(pth), channel_width=CH,
                  device="cpu")
    ref = JaxBigGAN(VERSION, params=jax_convert_biggan(sd, VERSION),
                    channel_width=CH)
    rng = np.random.RandomState(2)
    z = (0.5 * rng.randn(2, 128)).astype(np.float32)
    want = np.asarray(ref(z=jnp.asarray(z), c=jnp.broadcast_to(
        ref.get_class_embedding(153), (2, 128))))
    with torch.no_grad():
        got = port(torch.tensor(z), port.get_class_embedding(153).expand(
            2, 128)).numpy()
    # tolerance: rel 1e-4 of the output's scale, float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", ["weights.bin", "weights.safetensors"])
def test_biggan_rejects_other_files(tmp_path, name):
    path = tmp_path / name
    path.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match=r"\.pt / \.pth"):
        BigGAN(VERSION, pretrained_path=str(path), channel_width=CH,
               device="cpu")


def test_cli_stylegan2_kind_round_trips(tmp_path):
    from pix2latent_tpu.models.stylegan2 import \
        convert_torch_stylegan2 as jax_convert
    from pix2latent_tpu_torch.models.stylegan2 import \
        convert_torch_stylegan2
    from tests.test_stylegan2_golden import make_state_dict as make_sg2
    im_res = 16
    sd = make_sg2(np.random.RandomState(0), im_res)
    ckpt = tmp_path / "g.pt"
    torch.save({"g_ema": sd}, ckpt)
    out = tmp_path / "g.npz"
    convert.main(["stylegan2", str(ckpt), str(out), "--res", str(im_res)])
    got = load_params_npz(str(out))
    direct = convert_torch_stylegan2(sd, im_res)
    want = _flat_np(jax_convert(sd, im_res))
    assert sorted(got) == sorted(direct) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], direct[k], err_msg=k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's generator of that size takes the tree
    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2Generator
    from pix2latent_tpu_torch.utils.params_io import STYLEGAN2, from_jax_params
    StyleGAN2Generator(im_res).load_state_dict(
        from_jax_params(got, STYLEGAN2), strict=True)


@pytest.mark.parametrize("net", ["alex", "vgg16"])
def test_cli_lpips_kind_round_trips(tmp_path, net):
    from pix2latent_tpu.losses.lpips import convert_torch_lpips as jax_convert
    from pix2latent_tpu_torch.losses.lpips import LPIPS, convert_torch_lpips
    from tests.test_lpips_golden import (make_alex_state_dict,
                                         make_vgg_state_dict)
    make = make_alex_state_dict if net == "alex" else make_vgg_state_dict
    sd = make(np.random.RandomState(0))
    ckpt = tmp_path / "lpips.pt"
    torch.save(sd, ckpt)
    out = tmp_path / "lpips.npz"
    convert.main(["lpips", str(ckpt), str(out), "--net", net])
    got = load_params_npz(str(out))
    want = _flat_np(jax_convert(sd, net=net))
    direct = convert_torch_lpips(sd, net=net)
    assert sorted(got) == sorted(want) == sorted(direct)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = LPIPS(net=net, pretrained_path=str(out), device="cpu")
    x = torch.rand(1, 32, 32, 3) * 2 - 1
    assert math.isfinite(float(model(x, -x).sum()))


def test_cli_matches_the_jax_cli_flags_and_report(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_convert_cli", ROOT / "scripts" / "convert.py")
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    sd = _state_dict(sn=False)
    pth = tmp_path / "G.pth"
    torch.save(sd, pth)
    jax_cli.main(["biggan", str(pth), str(tmp_path / "a.npz"), "--model",
                  VERSION])
    want = capsys.readouterr().out.replace("a.npz", "X.npz")
    convert.main(["biggan", str(pth), str(tmp_path / "b.npz"), "--model",
                  VERSION])
    got = capsys.readouterr().out.replace("b.npz", "X.npz")
    assert got == want
