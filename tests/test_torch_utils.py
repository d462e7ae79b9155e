"""The port's small public helpers against the JAX package's: the
population split (``split_vars`` / ``stack_splits``), the distribution
factories, ``weight_regularization`` on the BigGAN tree carried across by
``utils/params_io``, the ``misc`` helpers, ``imagenet_tools`` (mirroring
``tests/test_aux.py``'s ImageNet cases), ``Benchmark`` with the same LPIPS
weights, ``profiling`` and the module-to-``.npz`` weight export.

Tolerances: splits and one-hots exact; ``weight_regularization`` rtol 1e-5
(f32 means summed in another order); ``Benchmark`` rtol 1e-4, atol 1e-6
(the port's LPIPS against the JAX package's, as
``tests/test_torch_losses.py``).
"""

import json
import os
import stat
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pix2latent_tpu.loss_functions as JLF
import pix2latent_tpu.variables as JV
import pix2latent_tpu_torch as P
import pix2latent_tpu_torch.loss_functions as LF
from pix2latent_tpu import distribution as jdist
from pix2latent_tpu.models.biggan import BigGAN as JaxBigGAN
from pix2latent_tpu.utils import imagenet_tools as jit_
from pix2latent_tpu.utils import misc as jmisc
from pix2latent_tpu.utils.benchmark import Benchmark as JaxBenchmark
from pix2latent_tpu.utils.params_io import _flatten
from pix2latent_tpu_torch import distribution as dist
from pix2latent_tpu_torch.models import stylegan2 as S
from pix2latent_tpu_torch.models.biggan import BigGAN
from pix2latent_tpu_torch.utils import cuda_build, imagenet_tools as it
from pix2latent_tpu_torch.utils import misc, params_io, profiling
from pix2latent_tpu_torch.utils.benchmark import Benchmark

VERSION, CH = "biggan-deep-128", 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(pop=7):
    rng = np.random.RandomState(0)
    return {"input": {"z": rng.randn(pop, 5).astype(np.float32),
                      "c": rng.randn(pop, 3).astype(np.float32)},
            "output": {"target": rng.randn(pop, 4, 4, 3).astype(np.float32)}}


# --------------------------------------------------------------------- #
# variables and the package's exports                                    #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("size", [1, 3, 7, 10])
def test_split_and_stack_match_jax(size):
    v = _variables()
    want = JV.split_vars(jax.tree.map(jnp.asarray, v), size)
    got = P.split_vars({vt: {k: torch.from_numpy(a) for k, a in d.items()}
                        for vt, d in v.items()}, size)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert P.num_samples(g) == JV.num_samples(w)
        for vt, d in w.items():
            for name, arr in d.items():
                np.testing.assert_array_equal(g[vt][name].numpy(),
                                              np.asarray(arr))
    back = P.stack_splits(got)
    for vt, d in v.items():
        for name, arr in d.items():
            np.testing.assert_array_equal(back[vt][name].numpy(), arr)


def test_package_exports_match_jax():
    import pix2latent_tpu
    assert set(P.__all__) == set(pix2latent_tpu.__all__)
    assert P.Variables is not None and callable(P.num_samples)


# --------------------------------------------------------------------- #
# distributions                                                           #
# --------------------------------------------------------------------- #

def test_distribution_factories_match_jax():
    pairs = [(dist.truncated_clamp_normal(0.5, 1.5),
              jdist.truncated_clamp_normal(0.5, 1.5)),
             (dist.truncated_clamp_normal(), jdist.truncated_clamp_normal()),
             (dist.normal(0.3), jdist.normal(0.3)), (dist.normal(), jdist.normal())]
    for got, want in pairs:
        assert type(got).__name__ == type(want).__name__
        assert repr(got) == repr(want)
    gen = torch.Generator().manual_seed(0)
    x = dist.truncated_clamp_normal(2.0, 1.5)(gen, 4000, (8,))
    assert x.shape == (4000, 8) and float(x.abs().max()) == 1.5
    y = dist.normal(0.3)(gen, 4000, (8,))
    assert abs(float(y.std()) - 0.3) < 0.01


# --------------------------------------------------------------------- #
# weight_regularization on the BigGAN tree                               #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def biggan_trees():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = JaxBigGAN(VERSION, channel_width=CH)
    orig = {"generator": jm.params, "embeddings": jm._embed.params}
    rng = np.random.RandomState(3)
    curr = jax.tree.map(
        lambda a: a + jnp.asarray(0.01 * rng.randn(*a.shape), a.dtype), orig)
    return orig, curr


def _port(tree):
    return BigGAN(VERSION, params=_flatten(tree), channel_width=CH,
                  device="cpu")


@pytest.mark.parametrize("reg", ["l1", "l2", "inf"])
def test_weight_regularization_matches_jax(biggan_trees, reg):
    orig, curr = biggan_trees
    want = float(JLF.weight_regularization(orig, curr, reg=reg))
    po, pc = _port(orig), _port(curr)
    for a, b in ((po, pc), (po.state_dict(), pc.state_dict()),
                 (dict(po.named_parameters()), dict(pc.named_parameters()))):
        got = float(LF.weight_regularization(a, b, reg=reg))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_weight_regularization_skips_and_weights_the_same_leaves(
        biggan_trees):
    """The ``"bn"`` skip catches the same 164 of 254 leaves in both
    packages, and ``weight_dict`` keyed by the port's dotted names weights
    the same terms as the JAX package's keyed by ``keystr`` paths."""
    from jax.tree_util import keystr, tree_flatten_with_path
    orig, curr = biggan_trees
    paths = [p for p, _ in tree_flatten_with_path(curr)[0]]
    jax_names = [keystr(p) for p in paths]
    port_names = [params_io.jax_to_torch_name(
        "/".join(str(k.key) for k in p)) for p in paths]
    po, pc = _port(orig), _port(curr)
    assert sorted(port_names) == sorted(po.state_dict())
    skipped_jax = {n for n in jax_names if "bn" in n.lower()}
    skipped_port = {n for n in port_names if "bn" in n.lower()}
    assert len(skipped_jax) == len(skipped_port) == 164
    rng = np.random.RandomState(5)
    w = rng.rand(len(paths))
    want = float(JLF.weight_regularization(
        orig, curr, reg="l2", weight_dict=dict(zip(jax_names, w))))
    got = float(LF.weight_regularization(
        po, pc, reg="l2", weight_dict=dict(zip(port_names, w))))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    everything = float(LF.weight_regularization(po, pc, skip_substr=None))
    assert everything > float(LF.weight_regularization(po, pc))
    with pytest.raises(ValueError, match="unknown reg"):
        LF.weight_regularization(po, pc, reg="l3")


# --------------------------------------------------------------------- #
# misc                                                                   #
# --------------------------------------------------------------------- #

def test_set_seed_seeds_numpy_and_returns_a_generator():
    jmisc.set_seed(11)
    want = np.random.rand(3)
    gen = misc.set_seed(11)
    np.testing.assert_array_equal(np.random.rand(3), want)
    assert isinstance(gen, torch.Generator)
    np.testing.assert_array_equal(
        torch.randn(4, generator=gen).numpy(),
        torch.randn(4, generator=torch.Generator().manual_seed(11)).numpy())


def test_to_onehot_matches_jax():
    for idx in (3, [3, 7, 999]):
        got = misc.to_onehot(idx)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jmisc.to_onehot(idx)))


def test_set_model_precision_and_prepare_variables():
    vs = [np.ones((2, 2), np.float32), np.zeros((3,), np.float32)]
    want = jmisc.prepare_variables(vs, precision="half")
    got = misc.prepare_variables(vs, precision="half", device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in got)
    assert all(w.dtype == jnp.bfloat16 for w in want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    got = misc.prepare_variables(vs, precision="float", device="cpu")
    assert all(v.dtype == torch.float32 for v in got)
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), torch.arange(3)]}
    cast = misc.set_model_precision(tree, "double")
    assert cast["a"].dtype == torch.float64
    assert cast["b"][0].dtype == torch.float64
    assert cast["b"][1].dtype == torch.int64        # not a float: kept
    module = misc.set_model_precision(torch.nn.Linear(2, 2), "half")
    assert module.weight.dtype == torch.bfloat16


def test_prepare_variables_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        misc.prepare_variables([np.ones(2, np.float32)])


def test_hidden_prints(capsys):
    print("shown")
    with misc.HiddenPrints():
        print("hidden")
    print("shown again")
    assert capsys.readouterr().out == "shown\nshown again\n"


# --------------------------------------------------------------------- #
# imagenet_tools (tests/test_aux.py's cases, against the JAX package)    #
# --------------------------------------------------------------------- #

def test_imagenet_static_mappings_match_jax():
    for label in (0, 153, 254, 999):
        wnid = it.label_to_wnid(label)
        assert wnid == jit_.label_to_wnid(label)
        assert it.wnid_to_label(wnid) == label
        assert it.label_to_noun(label) == jit_.label_to_noun(label)
    assert it.pascal_categories() == jit_.pascal_categories()
    assert len(it.pascal_categories()) == 21
    assert it.coco_categories() == jit_.coco_categories()
    assert "person" in it.coco_categories()
    wnid = it.label_to_wnid(153)
    for form in (wnid, wnid[1:], int(wnid[1:])):
        assert it.wnid_to_label(form) == jit_.wnid_to_label(form) == 153


def test_imagenet_data_file_is_the_jax_packages():
    here = os.path.join(os.path.dirname(it.__file__), "data",
                        "imagenet_meta.json.gz")
    there = os.path.join(os.path.dirname(jit_.__file__), "data",
                         "imagenet_meta.json.gz")
    with open(here, "rb") as a, open(there, "rb") as b:
        assert a.read() == b.read()


def test_imagenet_noun_search_and_onehot():
    hits = it.noun_to_labels("terrier")
    assert hits == jit_.noun_to_labels("terrier") and len(hits) > 5
    assert all(isinstance(l, int) for l, _ in hits)
    oh = it.to_onehot([3, 7])
    assert isinstance(oh, torch.Tensor) and oh.shape == (2, 1000)
    np.testing.assert_array_equal(oh.numpy(),
                                  np.asarray(jit_.to_onehot([3, 7])))


def test_imagenet_wordnet_gated():
    try:
        labels = it.query_subclass_by_name("dog")
        assert 153 in labels
    except RuntimeError as e:
        assert "wordnet" in str(e).lower()
    labels = it.coco_to_imagenet_labels("terrier")
    assert labels == jit_.coco_to_imagenet_labels("terrier")
    assert len(labels) > 0


def test_imagenet_wordnet_without_nltk_raises(monkeypatch):
    """Without nltk at all (the card machine has none) the WordNet helpers
    raise ``RuntimeError`` and the fallbacks still answer."""
    monkeypatch.setitem(sys.modules, "nltk", None)
    monkeypatch.setitem(sys.modules, "nltk.corpus", None)
    with pytest.raises(RuntimeError, match="wordnet"):
        it.query_subclass_by_name("dog")
    with pytest.raises(RuntimeError, match="wordnet"):
        it.wnid_depth(it.label_to_wnid(153))
    noun = it.wnid_to_noun(it.label_to_wnid(153))
    assert noun == it.label_to_noun(153).split(",")[0]
    assert len(it.coco_to_imagenet_labels("terrier")) > 0


def test_imagenet_helpers_and_readers(tmp_path):
    assert it.wnid_str_to_int("n02084071") == 2084071
    wnid = it.label_to_wnid(153)
    noun = it.wnid_to_noun(wnid)
    assert isinstance(noun, str) and noun
    p = tmp_path / "synset_words.txt"
    p.write_text("n01440764 tench, Tinca tinca\nn01443537 goldfish\n")
    assert it.read_synset_file(p) == ["n01440764", "n01443537"]
    assert len(it.read_txt_file(p)) == 2
    try:
        depth = it.wnid_depth(wnid)
        assert depth > 3
        parent = it.get_parent_wnid(wnid)
        assert parent.startswith("n") and parent != wnid
        s = it.wnid_to_synset(wnid)
        assert it.is_hyponym(s, s)
        stats = it.wnid_statistics([wnid])
        assert stats["min_depth"] == stats["max_depth"] == depth
    except RuntimeError as e:
        assert "wordnet" in str(e).lower()


def test_imagenet_valid_tables_match_jax():
    labels = it.get_coco_valid_labels()
    want = jit_.get_coco_valid_labels()
    assert sorted(labels) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(labels[k], want[k])
    assert labels["dog"].dtype.kind in "iu"
    wnids = it.get_coco_valid_wnids()
    assert all(str(w).startswith("n") for w in wnids["dog"])
    assert it.wnid_to_label(str(wnids["dog"][0])) == int(labels["dog"][0])
    pascal = it.get_pascal_valid_wnids()
    assert sorted(pascal) == sorted(jit_.get_pascal_valid_wnids())


# --------------------------------------------------------------------- #
# Benchmark                                                               #
# --------------------------------------------------------------------- #

def _images(n=3, res=32, seed=0):
    rng = np.random.RandomState(seed)
    out = rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32)
    mask = np.ones((1, res, res, 3), np.float32)
    mask[:, : res // 4] = 0.25
    return out, out[1:2] * 0.5, mask


def test_benchmark_matches_jax_with_the_same_lpips_weights():
    from pix2latent_tpu.losses.lpips import LPIPS as JaxLPIPS
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = JaxLPIPS(net="alex").params
    out, target, mask = _images()
    want = JaxBenchmark(("l1", "l2", "alex"),
                        lpips_params={"alex": params}).evaluate(
        jnp.asarray(out), jnp.asarray(target), jnp.asarray(mask))
    got = Benchmark(("l1", "l2", "alex"), lpips_params={"alex": params},
                    device="cpu").evaluate(
        torch.from_numpy(out), torch.from_numpy(target),
        torch.from_numpy(mask))
    assert set(got) == set(want)
    for k in want:
        assert isinstance(got[k], np.ndarray) and got[k].shape == (3,)
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-6)


def test_benchmark_lazy_nets_and_unknown_metric():
    bm = Benchmark(("l1", "squeeze"), device="cpu")
    assert bm._fns == {}
    out, _, mask = _images(n=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = bm.evaluate(torch.from_numpy(out), torch.from_numpy(out[:1]),
                          torch.from_numpy(mask))
    assert set(bm._fns) == {"l1", "squeeze"}
    assert res["l1"][0] < 1e-6 and res["squeeze"][0] < 1e-6
    assert res["squeeze"][1] > 0
    with pytest.raises(ValueError, match="unknown metric"):
        Benchmark(("ssim",), device="cpu")


def test_benchmark_is_reported_by_log_result():
    from pix2latent_tpu_torch.models.toy import make_toy_model
    from pix2latent_tpu_torch.optimizers import GradientOptimizer
    model = make_toy_model(z_dim=4, res=16, width=8, device="cpu")
    target = model(torch.ones(1, 4))[0]
    vm = P.VariableManager(seed=0, device="cpu")
    vm.register("z", shape=(4,), learning_rate=0.05)
    vm.register("target", shape=(16, 16, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(16, 16, 3), var_type="output",
                requires_grad=False, default=torch.ones(16, 16, 3))
    def loss_fn(out, target, weight):
        return LF.masked_l1_loss(out, target, weight)

    opt = GradientOptimizer(model, vm, loss_fn, log=True, device="cpu")
    bm = Benchmark(("l1", "l2"), device="cpu")
    opt.register_benchmark(bm)
    variables, _, losses = opt.optimize(num_samples=2, grad_steps=5)
    step, res = losses[-1]
    assert step == 5 and set(res) == {"l1", "l2"}
    want = bm.evaluate(opt.out, target[None], torch.ones(1, 16, 16, 3))
    for k in res:
        np.testing.assert_allclose(res[k], want[k], rtol=1e-6)


# --------------------------------------------------------------------- #
# profiling                                                              #
# --------------------------------------------------------------------- #

def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    profiling.clear_spans()
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("generation", gen=0):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "p2l::generation" in names
    assert [(r["name"], r["attrs"]) for r in profiling.spans()] == [
        ("generation", {"gen": 0})]
    profiling.clear_spans()


def test_debug_nans_toggles_anomaly_mode():
    try:
        profiling.debug_nans(True)
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"), \
                pytest.warns(UserWarning, match="SqrtBackward"):
            torch.sqrt(x - 1).sum().backward()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()


def test_log_compiles_prints_each_nvcc_build(tmp_path, monkeypatch, capsys):
    """A stand-in ``nvcc`` (it writes its ``-o`` file): each build of
    ``cuda_build`` is printed while ``log_compiles`` is on, and not after."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    try:
        profiling.log_compiles(True)
        report = cuda_build.build(["a.cu"])
        err = capsys.readouterr().err
        assert not report["a.cu"]["cached"]
        assert "nvcc: building a.cu" in err and "nvcc: built a.cu" in err
    finally:
        profiling.log_compiles(False)
    cuda_build.build(["b.cu"])
    assert "nvcc" not in capsys.readouterr().err


# --------------------------------------------------------------------- #
# weights out of a module                                                 #
# --------------------------------------------------------------------- #

def test_to_jax_params_round_trips_both_layouts(biggan_trees, tmp_path):
    orig, _ = biggan_trees
    flat = _flatten(orig)
    got = params_io.to_jax_params(_port(orig))
    assert sorted(got) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
    path = str(tmp_path / "b.npz")
    params_io.save_params_npz(path, got)
    again = BigGAN(VERSION, pretrained_path=path, channel_width=CH,
                   device="cpu")
    for a, b in zip(again.state_dict().values(),
                    _port(orig).state_dict().values()):
        assert torch.equal(a, b)

    g = S.StyleGAN2Generator(im_res=16, channel_multiplier=1)
    S._random_init_(g, 2, "equalized")
    sd = params_io.from_jax_params(
        params_io.to_jax_params(g, params_io.STYLEGAN2), params_io.STYLEGAN2)
    assert sd.keys() == g.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in g.state_dict().items())
