"""The port's spans (``utils/profiling.span``) on the toy model.

Off (no profiler session) a span is one shared no-op and a whole BasinCMA
run records nothing. Under ``torch.profiler`` the drivers, the execution
core and the mesh record their tree: ``generation`` > ``ask``, ``ctx``,
``inner`` > ``step`` > ``hook``, ``adam``, ``forward``, ``loss``,
``backward``; ``tell_loss`` and ``eval`` > ``hook``, ``forward``, ``loss``;
``strategy_tell`` > ``sync`` (``eigh``); the loops' ``sync`` reads;
``chunk`` where the population runs in several chunks; ``gather``. Each
record sits on the profiler's own clock. On the card (``cuda``-marked, so
skipped here) one generation shows that recording adds no host sync and
that the ``sync`` spans hold every sync the drivers' loop makes.

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
from pix2latent_tpu_torch import VariableManager, hooks
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
