"""Device time of the backward's recomputation of checkpointed synthesis
blocks in an inner Adam step, ms: the program's ``recompute`` spans
(``models/base.checkpointed``, from ``remat_from_res`` on) under
``inner``, per step. None where the program records no such span."""

from p2l_bench.harness.program import ms_per_step, records


def read(trace):
    recs = records(trace)
    if not recs or not any(r["name"] == "recompute" for r in recs):
        return None
    return ms_per_step(trace, "recompute")
