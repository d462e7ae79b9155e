"""The port's spans (``utils/profiling.span``) on the toy model.

Off (no profiler session) a span is one shared no-op and a whole BasinCMA
run records nothing. Under ``torch.profiler`` the drivers, the execution
core and the mesh record their tree: ``generation`` > ``ask``, ``ctx``,
``inner`` > ``step`` > ``hook``, ``adam``, ``forward``, ``loss``,
``backward``; ``tell_loss`` and ``eval`` > ``hook``, ``forward``, ``loss``;
``strategy_tell`` > ``sync`` (``eigh``); the loops' ``sync`` reads;
``chunk`` where the population runs in several chunks; ``gather``; and
the generators' ``recompute`` of each checkpointed block inside the
``backward`` that needs it (a tiny StyleGAN2 with ``remat_from_res`` 16,
BigGAN-deep-128 at channel width 8). Each record sits on the profiler's
own clock. On the card (``cuda``-marked, so skipped here) one generation
shows that recording adds no host sync and that the ``sync`` spans hold
every sync the drivers' loop makes, and the recompute, run on autograd's
device thread, still sits under the host's ``backward`` span.

The file imports neither JAX nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import warnings
from collections import Counter

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import pix2latent_tpu_torch.loss_functions as LF
import pix2latent_tpu_torch.models.stylegan2 as S
from pix2latent_tpu_torch import VariableManager, hooks
from pix2latent_tpu_torch.models.biggan import BigGAN
from pix2latent_tpu_torch.models.toy import make_toy_model
from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer, CMAOptimizer
from pix2latent_tpu_torch.parallel.mesh import Mesh
from pix2latent_tpu_torch.utils import profiling



class PrecomputedL1:
    """The L1 loss with a target context, so that the core computes one
    (``ExecutionCore.make_ctx``)."""

    def __call__(self, out, target):
        return LF.l1_loss(out, target)

    def precompute(self, target):
        return {"target": target}

    def from_ctx(self, out, ctx):
        return LF.l1_loss(out, ctx["target"])


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _optimizer(cls, device="cpu", max_batch_size=None):
    model = make_toy_model(z_dim=16, res=16, width=8, seed=0, device=device)
    with torch.no_grad():
        target = model(z=torch.full((1, 16), 0.3, device=device))[0]
    vm = VariableManager(seed=0, device=device)
    vm.register("z", shape=(16,), grad_free=True, learning_rate=0.05,
                hook_fn=hooks.Clamp(2.0))
    vm.register("target", shape=(16, 16, 3), var_type="output",
                requires_grad=False, default=target)
    return cls(model, vm, PrecomputedL1(), seed=3, device=device,
               max_batch_size=max_batch_size)


def _profiled(fn, cuda=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
    return prof, profiling.spans()


def _tree(recs):
    by_id = {r["id"]: r for r in recs}
    children = {r["id"]: [] for r in recs}
    for r in recs:
        if r["parent"] is not None:
            children[r["parent"]].append(r)
    return by_id, children


def test_span_is_a_shared_noop_without_a_profiler():
    # the flag the tracer reads is PyTorch's own, set by every session
    assert autograd_profiler._is_profiler_enabled is False
    assert profiling.span("a") is profiling.span("b", site="x")
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert profiling.span("a") is not profiling.span("b")
    assert autograd_profiler._is_profiler_enabled is False
    opt = _optimizer(BasinCMAOptimizer)
    opt.optimize(2, 3, last_grad_steps=2)
    assert profiling.spans() == []


def test_basincma_records_the_tree():
    opt = _optimizer(BasinCMAOptimizer)
    _, recs = _profiled(lambda: opt.optimize(2, 3, last_grad_steps=2))
    by_id, children = _tree(recs)
    gens = [r for r in recs if r["name"] == "generation"]
    assert [g["attrs"] for g in gens] == [{"gen": 0}, {"gen": 1}]
    for g in gens:
        names = Counter(c["name"] for c in children[g["id"]])
        assert names == {"ask": 1, "ctx": 1, "inner": 1, "tell_loss": 1,
                         "strategy_tell": 1, "sync": 1}
        inner = next(c for c in children[g["id"]] if c["name"] == "inner")
        assert inner["attrs"] == {"steps": 3, "rows": opt.num_samples}
        steps = children[inner["id"]]
        assert [s["name"] for s in steps] == ["step"] * 3
        for s in steps:
            assert Counter(c["name"] for c in children[s["id"]]) == {
                "hook": 1, "adam": 2, "forward": 1, "loss": 1,
                "backward": 1}
        tell = next(c for c in children[g["id"]] if c["name"] == "tell_loss")
        assert {c["name"] for c in children[tell["id"]]} == {
            "hook", "forward", "loss"}
        strategy = next(c for c in children[g["id"]]
                        if c["name"] == "strategy_tell")
        assert [(c["name"], c["attrs"]) for c in children[strategy["id"]]] \
            == [("sync", {"site": "eigh"})]
    assert Counter(r["attrs"]["site"] for r in recs
                   if r["name"] == "sync") == {"eigh": 2, "tell_min": 2}
    # the final run's steps, outside any generation
    assert sum(r["name"] == "step" for r in recs) == 2 * 3 + 2
    for r in recs:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]


def test_spans_sit_on_the_profilers_clock():
    opt = _optimizer(BasinCMAOptimizer)
    prof, recs = _profiled(lambda: opt.optimize(2, 3, last_grad_steps=2))
    starts = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("p2l::"):
            assert e.device_type() == DeviceType.CPU
            starts.setdefault(e.name()[5:], []).append(e.start_ns())
    ours = {}
    for r in recs:
        ours.setdefault(r["name"], []).append(r["start_ns"])
    assert set(ours) == set(starts)
    for name, got in ours.items():
        want = sorted(starts[name])
        assert len(want) == len(got), name
        for a, b in zip(sorted(got), want):
            assert abs(a - b) < 1_000_000, (name, (a - b) * 1e-6)


def test_eval_only_records_its_spans_each_generation():
    opt = _optimizer(CMAOptimizer)
    _, recs = _profiled(lambda: opt.optimize(3, grad_steps=2))
    _, children = _tree(recs)
    gens = [r for r in recs if r["name"] == "generation"]
    assert len(gens) == 3
    for g in gens:
        kids = children[g["id"]]
        assert [c["name"] for c in kids] == [
            "ask", "eval", "tell_loss", "strategy_tell", "sync"]
        assert kids[-1]["attrs"] == {"site": "tell_min"}
        for c in kids[1:3]:
            assert {k["name"] for k in children[c["id"]]} == {
                "hook", "forward", "loss"}
    assert sum(r["name"] == "sync" and r["attrs"]["site"] == "eigh"
               for r in recs) == 3


@pytest.mark.parametrize("max_batch_size", [4, 5])
def test_chunks_record_one_span_each(max_batch_size):
    opt = _optimizer(BasinCMAOptimizer, max_batch_size=max_batch_size)
    _, recs = _profiled(lambda: opt.optimize(1, 2, last_grad_steps=1))
    _, children = _tree(recs)
    pop = opt.num_samples
    n = -(-pop // max_batch_size)
    want = [(min(max_batch_size, pop - i * max_batch_size),
             max_batch_size - min(max_batch_size, pop - i * max_batch_size))
            for i in range(n)]
    steps = [r for r in recs if r["name"] == "step"]
    for s in steps:
        chunks = [c for c in children[s["id"]] if c["name"] == "chunk"]
        assert [(c["attrs"]["rows"], c["attrs"]["pad"]) for c in chunks] \
            == want
        for c in chunks:
            assert [k["name"] for k in children[c["id"]]] == [
                "forward", "loss", "backward"]
        assert not {"forward", "loss", "backward"} & {
            c["name"] for c in children[s["id"]]}
    tell = next(r for r in recs if r["name"] == "tell_loss")
    assert [c["name"] for c in children[tell["id"]]] == ["hook"] + [
        "chunk"] * n


def test_one_rank_gather_records_gather():
    mesh = Mesh()
    _, recs = _profiled(lambda: mesh.gather(torch.ones(3, 2)))
    assert [r["name"] for r in recs] == ["gather"]


def test_a_span_open_when_the_profiler_stops_is_kept():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", gen=7):
            s = profiling.span("late")
            s.__enter__()
    s.__exit__(None, None, None)
    names = [(r["name"], r["attrs"]) for r in profiling.spans()]
    assert names == [("outer", {"gen": 7}), ("late", {})]
    profiling.clear_spans()
    assert profiling.spans() == []


def _tiny_stylegan2(monkeypatch, remat_from_res):
    """StyleGAN2 at 32 px with 8 channels a layer: blocks at 8, 16 and 32
    px, those from ``remat_from_res`` on checkpointed."""
    monkeypatch.setattr(S, "channels_for", lambda res, cm=2: 8)
    monkeypatch.setitem(S.StyleGAN2.MODELS, "cars", 32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return S.StyleGAN2("cars", remat_from_res=remat_from_res,
                           init="equalized", device="cpu")


def _stylegan2_optimizer(model):
    with torch.no_grad():
        target = model(z=torch.randn(1, 512, generator=torch.Generator()
                                     .manual_seed(1)))[0]
    vm = VariableManager(seed=0, device="cpu")
    vm.register("z", shape=(512,), grad_free=True, learning_rate=0.05,
                hook_fn=hooks.Normalize())
    vm.register("target", shape=(32, 32, 3), var_type="output",
                requires_grad=False, default=target)
    return BasinCMAOptimizer(model, vm, PrecomputedL1(), seed=3,
                             device="cpu")


def test_recompute_spans_sit_under_each_steps_backward(monkeypatch):
    opt = _stylegan2_optimizer(_tiny_stylegan2(monkeypatch, 16))
    _, recs = _profiled(lambda: opt.optimize(2, 3, last_grad_steps=2))
    by_id, children = _tree(recs)
    steps = [r for r in recs if r["name"] == "step"]
    assert len(steps) == 2 * 3 + 2
    for s in steps:
        backward = [c for c in children[s["id"]] if c["name"] == "backward"]
        assert len(backward) == 1
        # the up-conv, the conv and ToRGB at 16 and at 32 px, the last
        # block's first
        assert [(c["name"], c["attrs"]) for c in children[
            backward[0]["id"]]] == [("recompute", {"res": 32})] * 3 + [
            ("recompute", {"res": 16})] * 3
    recompute = [r for r in recs if r["name"] == "recompute"]
    assert len(recompute) == 6 * len(steps)
    for r in recompute:
        b = by_id[r["parent"]]
        assert b["name"] == "backward" and by_id[b["parent"]]["name"] == \
            "step"
        assert b["start_ns"] <= r["start_ns"] <= r["end_ns"] <= b["end_ns"]


@pytest.mark.parametrize("case", ["no_remat", "no_grad", "no_profiler"])
def test_no_recompute_span(case, monkeypatch):
    model = _tiny_stylegan2(monkeypatch, 0 if case == "no_remat" else 16)
    z = torch.randn(2, 512, generator=torch.Generator().manual_seed(2))

    def run():
        if case == "no_grad":
            with torch.no_grad():
                model(z=z)
            return
        zt = z.clone().requires_grad_(True)
        model(z=zt).square().sum().backward()
        assert zt.grad.abs().max() > 0

    if case == "no_profiler":
        run()
        assert profiling.spans() == []
        return
    _, recs = _profiled(run)
    assert recs == []


def test_recompute_span_leaves_the_gradient_bitwise(monkeypatch):
    model = _tiny_stylegan2(monkeypatch, 16)
    z = torch.randn(3, 512, generator=torch.Generator().manual_seed(3))
    cot = torch.randn(3, 32, 32, 3, generator=torch.Generator()
                      .manual_seed(4))

    def grad():
        zt = z.clone().requires_grad_(True)
        (model(z=zt) * cot).sum().backward()
        return zt.grad

    plain = grad()
    traced = []
    _, recs = _profiled(lambda: traced.append(grad()))
    assert sum(r["name"] == "recompute" for r in recs) == 6
    assert torch.equal(traced[0], plain)


@pytest.mark.parametrize("remat", [dict(remat=True),
                                   dict(remat_from_res=64)])
def test_biggan_recompute_spans(remat):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = BigGAN("biggan-deep-128", channel_width=8, device="cpu",
                       **remat)
    res, want = 4, []
    for up, _, _ in model.generator.layers:
        res *= 2 if up else 1
        if remat.get("remat") or res >= remat.get("remat_from_res", 0):
            want.append(res)
    z = torch.randn(2, 128, generator=torch.Generator().manual_seed(5))
    c = model.get_class_embedding(153).expand(2, -1)

    def run():
        zt = z.clone().requires_grad_(True)
        out = model(zt, c, 0.5)
        with profiling.span("backward"):
            out.square().sum().backward()

    _, recs = _profiled(run)
    assert recs[0]["name"] == "backward"
    got = [r for r in recs if r["name"] == "recompute"]
    # the backward recomputes the blocks from the last
    assert [r["attrs"] for r in got] == [{"res": r} for r in want[::-1]]
    assert all(r["parent"] == recs[0]["id"] for r in got)


def _syncs_of(run):
    """``run()`` under the sync debug mode: for each synchronizing call,
    the names of the spans open around it, from the outermost in, and the
    innermost one's id (None outside every span)."""
    seen = []

    def show(message, *args, **kwargs):
        if "synchroniz" in str(message):
            open_ = profiling._OPEN
            seen.append((tuple(s.name for s in open_),
                         open_[-1].id if open_ else None))

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return seen


@pytest.mark.cuda
def test_recording_adds_no_sync_and_sync_spans_hold_the_loops_syncs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    def one_generation():
        _optimizer(BasinCMAOptimizer, "cuda").optimize(
            1, 3, last_grad_steps=2)
        torch.cuda.synchronize()

    # the same run first: the first run under the sync debug mode syncs
    # once more, with no frame of the port on its stack
    _syncs_of(one_generation)
    plain = _syncs_of(one_generation)
    traced = []
    prof, recs = _profiled(
        lambda: traced.extend(_syncs_of(one_generation)), cuda=True)
    # the spans' ranges stay on the host's timeline: nothing of them is
    # counted as device work
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("p2l::")
                and e.device_type() != DeviceType.CPU]
    assert len(traced) == len(plain) > 0, (Counter(plain), Counter(traced))
    in_gen = [(names, sid) for names, sid in traced if "generation" in names]
    assert in_gen and all(names[-1] == "sync" for names, _ in in_gen), in_gen
    gen = next(r for r in recs if r["name"] == "generation")
    syncs = [r for r in recs if r["name"] == "sync"
             and gen["start_ns"] <= r["start_ns"] <= gen["end_ns"]]
    # the inner run's reads of the tracked variables and of its last
    # losses, the tell's eigh, the loop's read of the best tell loss
    assert Counter(r["attrs"]["site"] for r in syncs) == {
        "to_numpy": 2, "eigh": 1, "tell_min": 1}
    # each sync span of the generation holds a sync, and nothing else does
    assert {sid for _, sid in in_gen} == {r["id"] for r in syncs}
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0
               for r in recs)


@pytest.mark.cuda
def test_recompute_on_autograds_device_thread_sits_under_backward(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(S, "channels_for", lambda res, cm=2: 8)
    monkeypatch.setitem(S.StyleGAN2.MODELS, "cars", 32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = S.StyleGAN2("cars", remat_from_res=16, init="equalized",
                            fused_mod_bwd=True, fir_kernel=True,
                            device="cuda")
    z = torch.randn(2, 512, device="cuda", requires_grad=True)

    def run():
        out = model(z=z)
        with profiling.span("backward"):
            out.square().sum().backward()
        torch.cuda.synchronize()

    _, recs = _profiled(run, cuda=True)
    got = [r for r in recs if r["name"] == "recompute"]
    assert [r["attrs"]["res"] for r in got] == [32] * 3 + [16] * 3
    assert all(r["parent"] == recs[0]["id"] for r in got)
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0
               for r in got)
