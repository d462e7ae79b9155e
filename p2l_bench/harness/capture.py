"""What a judged generation leaves for the comparison.

Wrappers on the optimizer and execution core the harness built keep
copies (device clones, no host sync) of: the first ask, which for the
warm-up generation the harness answers with its own candidates ``x0`` so
that the reference starts where the program starts (for the generation
after the window, ``x0`` is None and the program's own ask stands); every
hook call's input and output leaves (each inner step's, then the tell's or
the evaluation's); Adam's first moment after the first step (the first
gradient as the optimizer got it); the inner run's per-step losses; the
evaluation's losses; and the tell's state before it, candidates, losses
and new state. They are removed when the generation is over.
"""

from __future__ import annotations


def _leaves(variables):
    return {n: t.detach().clone() for n, t in variables.get("input", {})
            .items()}


class Capture:

    def __init__(self, opt, x0):
        self.opt = opt
        self.x0 = x0
        self.hooks = []            # [(pre leaves, hooked leaves)] per call
        self.m1 = None             # {leaf: exp_avg after the first step}
        self.step_loss = None      # [steps, rows]
        self.eval_loss = None      # [rows]
        self.tell = None           # {"before", "x", "loss", "state"}
        self._wrapped = []

    def _wrap(self, obj, name, fn):
        setattr(obj, name, fn)
        self._wrapped.append((obj, name))

    def install(self):
        opt, core = self.opt, self.opt.core
        ask, tell = opt._ask, opt._tell
        hooks, init = core._apply_hooks, core.init_opt_state
        grad_steps, evaluate = core.grad_steps, core.eval

        def first_ask(state):
            if self.tell is not None or self.x0 is None:
                return ask(state)
            _, aux = ask(state)
            return self.x0.clone(), aux

        def apply_hooks(generator, variables, step):
            out = hooks(generator, variables, step)
            self.hooks.append((_leaves(variables), _leaves(out)))
            return out

        def init_opt_state(variables):
            variables, optimizer = init(variables)
            names = {id(t): n for n, t in variables.get("input", {}).items()}
            step = optimizer.step

            def first_step():
                step()
                if self.m1 is None:
                    self.m1 = {names[id(p)]: o.state[p]["exp_avg"].clone()
                               for o in optimizer.optimizers
                               for g in o.param_groups for p in g["params"]
                               if p in o.state}
            optimizer.step = first_step
            return variables, optimizer

        def grads(*args, **kwargs):
            out = grad_steps(*args, **kwargs)
            if self.step_loss is None:
                self.step_loss = out[3]["loss"]
            return out

        def evaluation(*args, **kwargs):
            out = evaluate(*args, **kwargs)
            if self.eval_loss is None:
                self.eval_loss = out[1]
            return out

        def first_tell(state, x, loss, aux):
            before = (None if self.tell is not None else
                      type(state)(*(t.clone() for t in state)))
            new = tell(state, x, loss, aux)
            if self.tell is None:
                self.tell = {"before": before, "x": x.clone(),
                             "loss": loss.clone(), "state": new}
            return new

        self._wrap(opt, "_ask", first_ask)
        self._wrap(opt, "_tell", first_tell)
        self._wrap(core, "_apply_hooks", apply_hooks)
        self._wrap(core, "init_opt_state", init_opt_state)
        self._wrap(core, "grad_steps", grads)
        self._wrap(core, "eval", evaluation)

    def remove(self):
        for obj, name in self._wrapped:
            delattr(obj, name)
        self._wrapped = []
