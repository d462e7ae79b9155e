"""The port's GANSpace editing against the JAX package's.

The draws are injected: JAX's threefry and torch's Philox cannot give the
same numbers, so the JAX package's own ``z`` and Gaussian test matrix (from
the keys its functions split) are handed to the port's ``_draw`` in the
order the port draws them. Components are compared up to their sign (SVD
and QR choose it per backend): sign-aligned, within atol 1e-3 (float32
against float64 of the same algorithm differed by 6.0e-5 on 2048-wide
features); singular values at rtol 1e-4. The editor's renders match the
JAX package's at rtol 1e-4, atol 2e-5 (``tests/test_torch_biggan.py``'s
image tolerance), on the same weights.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2latent_tpu.edit import ganspace as jgs
from pix2latent_tpu.edit.editor import BigGANLatentEditor as JaxEditor
from pix2latent_tpu.models.biggan import BigGAN as JaxBigGAN
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu.variables import save_variables as jax_save_variables
from pix2latent_tpu_torch.edit import BigGANLatentEditor, biggan_components
from pix2latent_tpu_torch.edit import ganspace
from pix2latent_tpu_torch.examples import edit_biggan
from pix2latent_tpu_torch.models.biggan import BigGAN
from pix2latent_tpu_torch.variables import save_variables

VERSION, CH = "biggan-deep-128", 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inject(monkeypatch, *arrays):
    """The port's draws replaced by ``arrays``, in order."""
    queue = [torch.from_numpy(np.array(a, np.float32)) for a in arrays]

    def draw(generator, shape, device):
        t = queue.pop(0)
        assert tuple(t.shape) == tuple(shape), (t.shape, shape)
        return t.to(device)

    monkeypatch.setattr(ganspace, "_draw", draw)
    return queue


def assert_same_up_to_sign(got, want, atol=1e-3):
    """Rows of ``got`` and ``want`` equal once each row's sign is aligned."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    sign = np.sign(np.sum(got * want, axis=1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, atol=atol, rtol=0)


def _decaying(seed=0, n=200, d=50):
    base = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, d)))
    return base * np.geomspace(10.0, 0.5, d)[None, :].astype(np.float32)


# --------------------------------------------------------------------- #
# pca_lowrank                                                            #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("q,niter", [(5, 2), (8, 0), (3, 4)])
def test_pca_lowrank_matches_jax_on_the_same_test_matrix(monkeypatch, q,
                                                         niter):
    a = _decaying()
    key = jax.random.PRNGKey(1)
    s_j, v_j = jgs.pca_lowrank(jnp.asarray(a), q=q, key=key, niter=niter)
    g = jax.random.normal(key, (a.shape[1], q + 6), jnp.float32)
    inject(monkeypatch, g)
    s, v = ganspace.pca_lowrank(torch.from_numpy(a), q=q, niter=niter)
    assert s.shape == (q,) and v.shape == (a.shape[1], q)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-4)
    assert_same_up_to_sign(v.numpy().T, np.asarray(v_j).T)


def test_pca_lowrank_matches_svd(monkeypatch):
    """tests/test_aux.py's check on its own test matrix (``PRNGKey(1)``'s);
    with the port's own draw, the singular values."""
    a = torch.from_numpy(_decaying())
    a0 = a - a.mean(0, keepdim=True)
    _, s_full, vt_full = torch.linalg.svd(a0, full_matrices=False)
    inject(monkeypatch, jax.random.normal(jax.random.PRNGKey(1), (50, 11)))
    s, v = ganspace.pca_lowrank(a, q=5)
    np.testing.assert_allclose(s.numpy(), s_full[:5].numpy(), rtol=1e-2)
    assert float((v * vt_full[:5].T).sum(0).abs().min()) > 0.95
    monkeypatch.undo()
    s, _ = ganspace.pca_lowrank(a, q=5,
                                generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(s.numpy(), s_full[:5].numpy(), rtol=1e-2)


def test_pca_lowrank_draws_from_the_generator():
    a = torch.from_numpy(_decaying())
    one = ganspace.pca_lowrank(a, q=4, generator=torch.Generator()
                               .manual_seed(3))[1]
    two = ganspace.pca_lowrank(a, q=4, generator=torch.Generator()
                               .manual_seed(3))[1]
    assert torch.equal(one, two)
    default = ganspace.pca_lowrank(a, q=4)[1]         # seed 0, as JAX's key
    assert torch.equal(default, ganspace.pca_lowrank(a, q=4)[1])


# --------------------------------------------------------------------- #
# biggan_components                                                      #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def models():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = JaxBigGAN(VERSION, channel_width=CH)
    tm = BigGAN(VERSION, params=_flatten(
        {"generator": jm.params, "embeddings": jm._embed.params}),
        channel_width=CH, device="cpu")
    return jm, tm


def _jax_draws(num_samples, feat_dim, q, key=None):
    """The z and the test matrix ``biggan_components`` draws from ``key``."""
    key = jax.random.PRNGKey(0) if key is None else key
    k_z, k_pca = jax.random.split(key)
    z = jax.random.normal(k_z, (num_samples, 128))
    g = jax.random.normal(k_pca, (feat_dim, q + 6), jnp.float32)
    return np.asarray(z), np.asarray(g)


@pytest.mark.parametrize("cls", [3, "embedding"])
def test_biggan_components_match_jax(monkeypatch, models, cls):
    jm, tm = models
    n, q = 512, 4
    if cls == "embedding":
        c = np.array(jm.get_class_embedding(7))
        want = jgs.biggan_components(jm, jnp.asarray(c), num_components=q,
                                     num_samples=n, batch=100)
        c_port = torch.from_numpy(c)
    else:
        want = jgs.biggan_components(jm, cls, num_components=q,
                                     num_samples=n, batch=100)
        c_port = cls
    feat_dim = tm.generator.gen_z.weight.shape[0]
    inject(monkeypatch, *_jax_draws(n, feat_dim, q))
    got = biggan_components(tm, c_port, num_components=q, num_samples=n,
                            batch=100)
    assert got.shape == (q, 128)
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, atol=1e-5)
    assert_same_up_to_sign(got.numpy(), np.asarray(want))


def test_biggan_components_refuses_a_rank_deficient_solve(monkeypatch,
                                                          models):
    """gels assumes full rank: more components than the features' rank
    raise instead of returning garbage."""
    _, tm = models
    n, q = 8, 12                       # centered rank <= 7 < 12
    feat_dim = tm.generator.gen_z.weight.shape[0]
    z, g = _jax_draws(n, feat_dim, q)
    inject(monkeypatch, z, g)
    with pytest.raises(RuntimeError, match="rank"):
        biggan_components(tm, 3, num_components=q, num_samples=n)


# --------------------------------------------------------------------- #
# the editor (tests/test_aux.py's flow, against the JAX editor)          #
# --------------------------------------------------------------------- #

def _result(tmp_path, saver):
    variables = {"input": {
        "z": np.random.RandomState(0).randn(3, 128).astype(np.float32),
        "c": 0.1 * np.random.RandomState(1).randn(3, 128).astype(np.float32)}}
    p = str(tmp_path / "vars.npy")
    saver(p, variables, extras={"loss": np.asarray([0.5, 0.1, 0.9])})
    return p


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-5)


@pytest.mark.parametrize("saver", [jax_save_variables, save_variables],
                         ids=["jax_vars", "port_vars"])
def test_editor_flow_matches_jax(tmp_path, models, saver):
    """A ``vars.npy`` of either package (plain numpy) loads; the best
    sample's renders match the JAX editor's."""
    jm, tm = models
    p = _result(tmp_path, saver)
    payload = np.load(p, allow_pickle=True).item()
    assert all(type(a) is np.ndarray
               for a in payload["variables"]["input"].values())
    ed = BigGANLatentEditor(tm).load_result(p)
    je = JaxEditor(jm).load_result(p)
    assert ed._idx == je._idx == 1
    out = ed.default()
    assert out.shape == (128, 128, 3)
    _close(out, je.default())
    out2 = ed.edit_class(5, alpha=0.5)
    _close(out2, je.edit_class(5, alpha=0.5))
    assert not np.allclose(out.numpy(), out2.numpy())
    u = np.linalg.qr(np.random.RandomState(2).randn(128, 4))[0].T
    ed.components = torch.from_numpy(u.astype(np.float32))
    je.components = jnp.asarray(u, jnp.float32)
    _close(ed.edit_z(2, 1.5), je.edit_z(2, 1.5))


def test_editor_computes_components_on_first_z_edit(tmp_path, models,
                                                     monkeypatch):
    _, tm = models
    ed = BigGANLatentEditor(tm).load_result(_result(tmp_path,
                                                    save_variables))
    calls = []

    def fake(model, c, **kwargs):
        calls.append(c)
        return torch.eye(128)[:32]

    monkeypatch.setattr("pix2latent_tpu_torch.edit.editor.biggan_components",
                        fake)
    ed.edit_z(0, 1.0)
    ed.edit_z(1, 1.0)
    assert len(calls) == 1 and torch.equal(calls[0], ed._c)


def test_editor_needs_a_loss(tmp_path, models):
    _, tm = models
    p = str(tmp_path / "v.npy")
    save_variables(p, {"input": {"z": np.zeros((2, 128), np.float32),
                                 "c": np.zeros((2, 128), np.float32)}})
    with pytest.raises(ValueError, match="loss"):
        BigGANLatentEditor(tm).load_result(p)


# --------------------------------------------------------------------- #
# the example                                                            #
# --------------------------------------------------------------------- #

def test_edit_example_flags_match_jax():
    import ast
    from pathlib import Path
    src = (Path(__file__).resolve().parents[1] / "examples" /
           "edit_biggan.py").read_text()
    flags = {a.value for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Call)
             and getattr(node.func, "attr", "") == "add_argument"
             for a in node.args[:1] if isinstance(a, ast.Constant)}
    ours = {a.option_strings[0] for a in edit_biggan.parser()._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert ours == flags | {"--device"}


def test_edit_example_smoke_on_the_cpu(tmp_path, monkeypatch):
    """``--smoke --device cpu``: BigGAN-deep-128 (at 4 channels here), a
    synthetic result, 256 PCA samples and 4 components."""
    from pix2latent_tpu_torch.models import biggan as B
    built = []

    class Narrow(B.BigGAN):
        def __init__(self, version, **kwargs):
            built.append(version)
            super().__init__(version, channel_width=CH, **kwargs)

    monkeypatch.setattr(B, "BigGAN", Narrow)
    sizes = []
    components = edit_biggan.biggan_components

    def recorded(model, c, num_components, num_samples):
        sizes.append((num_components, num_samples))
        return components(model, c, num_components=num_components,
                          num_samples=num_samples)

    monkeypatch.setattr(edit_biggan, "biggan_components", recorded)
    editor, edits = edit_biggan.main(["--smoke", "--device", "cpu",
                                      "--save_dir", str(tmp_path)])
    assert built == ["biggan-deep-128"] and sizes == [(4, 256)]
    assert editor.components.shape == (4, 128)
    for name in ("original", "class_edit", "z_edit"):
        assert edits[name].shape == (128, 128, 3)
        assert torch.isfinite(edits[name]).all()
        assert os.path.getsize(tmp_path / f"{name}.jpg") > 0
    assert os.path.exists(tmp_path / "smoke_vars.npy")
    assert not torch.equal(edits["original"], edits["z_edit"])


def test_edit_example_needs_a_result_without_smoke():
    with pytest.raises(SystemExit):
        edit_biggan.main(["--device", "cpu"])
