"""The comparison that decides ``correct``.

It judges two generations of the window's own driver at the timed sizes
(``capture.Capture``) against the plain reference
(``p2l_bench/reference/``) over the same inputs: the warm-up, whose first
ask the harness answers with its own candidates, and the generation after
the window, which starts from the program's own ask (the reference takes
the leaves that entered its first hook call). Each number is the larger of
the two generations' readings:

- ``loss_gap``: the first inner step's population-mean loss, relative
  gap (from the second step on each side's input carries its own rounding
  through Adam's normalized update, which scales every gradient element,
  small or not, to a step of about the learning rate; see PERF.md);
- ``grad_gap``: the norm of the first gradient as Adam got it (its first
  moment over ``1 - beta1``), per leaf;
- ``delta_gap``: the norm of each leaf's change over the first three steps
  (the leaf entering the fourth step's hook less the first's);
- ``tell_gap``: the tell losses of the generation's refined rows, the
  largest relative gap over rows;
- ``eval_gap``: an eval-only generation's losses, the same way;
- ``cma_gap``: the CMA state after the warm-up's tell (mean, step size,
  covariance, paths) against the update of the reference's own initial
  state from the program's candidates and tell losses, the largest
  relative gap; ``cma_gap.after``: the same for the generation after the
  window, updating the program's state from before its tell (the reference
  works out that state's eigendecomposition itself);
- ``noise_gap``: where a hook draws noise, its draws' mean and standard
  deviation in units of the configured sigma against 0 and 1.

A per-leaf gap is ``| |a| - |r| | / max(|r|, |median leaf of r|)``, the
worst leaf; a leaf whose reference gradient is under a thousandth of the
median leaf's moves by round-off alone and is left out of both.

The reference follows the program's generation where it cannot do
otherwise: its inner steps run its own chain from the generation's start,
taking only the noise a hook drew from the program (checked by
``noise_gap``); the tell is judged at the program's refined rows after all
inner steps.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from p2l_bench.reference import optim as ref_optim
from p2l_bench.reference import precision

BETA1 = 0.9
FOLLOWED_STEPS = 3


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def _blocks(ref, leaves, block, grad_scale=None):
    """Per-row losses of hooked ``leaves`` in blocks of ``block`` rows and,
    with ``grad_scale``, the gradient of ``grad_scale * sum`` to each."""
    rows = next(iter(leaves.values())).shape[0]
    losses, grads = [], {n: [] for n in leaves}
    for lo in range(0, rows, block):
        part = {n: t[lo:lo + block].detach().clone().requires_grad_(
            grad_scale is not None) for n, t in leaves.items()}
        with torch.set_grad_enabled(grad_scale is not None):
            loss = ref.loss(part)
            if grad_scale is not None:
                (loss.sum() * grad_scale).backward()
        losses.append(loss.detach())
        for n, t in part.items():
            if grad_scale is not None:
                grads[n].append(t.grad)
    grads = {n: torch.cat(g) for n, g in grads.items()} if grad_scale \
        is not None else None
    return torch.cat(losses), grads


CMA_FIELDS = ("mean", "sigma", "C", "p_sigma", "p_c")


def cma_state(state) -> dict:
    """The compared fields of a strategy state, float64 on the host."""
    return {k: np.asarray(getattr(state, k).detach().double().cpu())
            for k in CMA_FIELDS}


def program_side(cap, rows: range, kind: str) -> dict:
    """The numbers' program side from a capture."""
    side = {"tell_loss": cap.tell["loss"][rows.start:rows.stop],
            "cma": cma_state(cap.tell["state"])}
    if kind == "evalonly":
        side["eval_loss"] = cap.eval_loss
        return side
    pre0, pre3 = cap.hooks[0][0], cap.hooks[FOLLOWED_STEPS][0]
    side["step_loss"] = cap.step_loss[:FOLLOWED_STEPS]
    # a leaf that Adam never stepped has no moment: its gradient reads 0
    side["g0"] = {n: (cap.m1[n] if n in (cap.m1 or {}) else
                      torch.zeros_like(pre0[n])) / (1.0 - BETA1)
                  for n in pre0}
    side["delta"] = {n: pre3[n] - pre0[n] for n in pre0}
    return side


def reference_side(ref, cap, start: dict, kind: str, total_rows: int,
                   block: int, tf32: bool = False) -> dict:
    """The numbers' reference side: the reference's own chain from
    ``start`` (``tf32``: the control, the same computed in TF32)."""
    with precision(tf32):
        if kind == "evalonly":
            hooked = {n: ref.hook(n, start[n], *_call(cap, 0, n))
                      for n in start}
            side = {"eval_loss": _blocks(ref, hooked, block)[0]}
            tell_call = 1
        else:
            adam = ref_optim.Adam(ref.leaves)
            params, losses = dict(start), []
            for k in range(FOLLOWED_STEPS):
                hooked = {n: ref.hook(n, params[n], *_call(cap, k, n))
                          for n in params}
                loss, grads = _blocks(ref, hooked, block, 1.0 / total_rows)
                losses.append(loss)
                if k == 0:
                    g0 = grads
                params = adam.step(hooked, grads)
            side = {"step_loss": torch.stack(losses), "g0": g0,
                    "delta": {n: params[n] - start[n] for n in params}}
            tell_call = len(cap.hooks) - 1
        pre, _ = cap.hooks[tell_call]
        hooked = {n: ref.hook(n, pre[n], *_call(cap, tell_call, n))
                  for n in pre}
        side["tell_loss"] = _blocks(ref, hooked, block)[0]
    return side


def _call(cap, index, name):
    pre, hooked = cap.hooks[index]
    return pre[name], hooked[name]


def reference_cma(cap, popsize: int, dim: int, tf32: bool = False,
                  before=None, sigma0: float = 1.0) -> dict:
    """The reference's CMA update from the program's candidates and tell
    losses, of its own initial state, or with ``before`` of the program's
    state before the tell (its mean, step size, covariance, paths and
    generation): float64 on the host, or for the control float32 on the
    candidates' device with TF32 products."""
    cp = ref_optim.cma_params(dim, popsize)
    x, loss = cap.tell["x"].detach(), cap.tell["loss"].detach()
    if tf32:
        dtype, device = torch.float32, x.device
    else:
        dtype, device = torch.float64, "cpu"
        x, loss = x.double().cpu(), loss.double().cpu()
    if before is None:
        init = ref_optim.cma_init(dim, 0.0, sigma0, dtype, device)
    else:
        init = {k: getattr(before, k).detach().to(dtype=dtype, device=device)
                for k in CMA_FIELDS}
        init["gen"] = int(before.gen)
    with precision(tf32):
        state = ref_optim.cma_tell(cp, init, x, loss)
    return {k: torch.as_tensor(state[k]).detach().double().cpu().numpy()
            for k in CMA_FIELDS}


def _rel(a, r):
    a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
    return float(np.linalg.norm(a - r) / max(np.linalg.norm(r), 1e-30))


def _leaf_gap(a: dict, r: dict, keep) -> float:
    norms = {n: _norm(r[n]) for n in keep}
    med = statistics.median(norms.values())
    return max(abs(_norm(a[n]) - norms[n]) / max(norms[n], med, 1e-30)
               for n in keep)


def _row_gap(a, r) -> float:
    a, r = a.detach().double(), r.detach().double()
    return float(((a - r).abs() / r.abs().clamp_min(1e-30)).max())


def cma_gap(a: dict, r: dict) -> float:
    return max(_rel(a[k], r[k]) for k in r)


def numbers(prog: dict, ref: dict, cma_ref: dict, look: bool = False) -> dict:
    """``{name: reading}`` of the program side against the reference
    side; NaN where a side is not finite. ``look`` adds the numbers read
    beside them for a calibration's look, never judged: each CMA field's
    and each leaf's gaps, each of the followed steps' losses along the
    reference's chain, and the elements whose three-step change differs by
    more than one Adam step of the reference's smallest (a sign that
    rounding turned round)."""
    out = {"tell_gap": _row_gap(prog["tell_loss"], ref["tell_loss"]),
           "cma_gap": cma_gap(prog["cma"], cma_ref)}
    if look:
        out.update({f"cma_gap:{k}": _rel(prog["cma"][k], cma_ref[k])
                    for k in cma_ref})
    if "eval_loss" in ref:
        out["eval_gap"] = _row_gap(prog["eval_loss"], ref["eval_loss"])
        return out
    pm = prog["step_loss"].double().mean(dim=1)
    rm = ref["step_loss"].double().mean(dim=1)
    gaps = (pm - rm).abs() / rm.abs()
    out["loss_gap"] = float(gaps[0])
    g_norms = {n: _norm(g) for n, g in ref["g0"].items()}
    med = statistics.median(g_norms.values())
    keep = [n for n, v in g_norms.items() if v >= 1e-3 * med]
    out["grad_gap"] = _leaf_gap(prog["g0"], ref["g0"], keep)
    out["delta_gap"] = _leaf_gap(prog["delta"], ref["delta"], keep)
    if look:
        out["loss_chain_gap"] = float(gaps.max())
        for n in keep:
            out[f"grad_gap:{n}"] = _leaf_gap(prog["g0"], ref["g0"], [n])
            out[f"delta_gap:{n}"] = _leaf_gap(prog["delta"], ref["delta"],
                                              [n])
            step = ref["delta"][n].abs().max() / FOLLOWED_STEPS
            out[f"delta_turned:{n}"] = float(
                ((prog["delta"][n] - ref["delta"][n]).abs() > step).sum())
    return out


def noise_gap(ref, cap) -> float:
    """The largest of ``|mean|`` and ``|std - 1|`` of the noise the
    program's hook drew over the generation, in units of its sigma."""
    if not hasattr(ref, "noise"):
        return None
    draws = torch.cat([ref.noise(pre[n], hooked[n]).reshape(-1).double()
                       for pre, hooked in cap.hooks for n in pre
                       if n in ref.leaves])
    return float(max(draws.mean().abs(), (draws.std() - 1.0).abs()))


def finite(readings: dict) -> dict:
    return {k: (v if v is not None and np.isfinite(v) else float("nan"))
            for k, v in readings.items()}
