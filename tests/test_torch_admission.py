"""Port parity: cost-model admission, ``preempt_over_budget`` and the
first-call accounting, against the JAX engines on the same virtual clock.

* The same seeded cost table gives the same decisions: the rids rejected
  at submit, swept from the queue (expired or infeasible) and preempted
  (``deadline-overrun``, predicted with a cost model, after the fact
  without one), with the same estimates and budgets in the events and
  the same table after the online EWMA refinement.
* ``CostModel.save`` in one package and ``load`` in the other round-trip
  (same JSON, same entries, key element types kept).
* After the same diffusion workload (fused programs of two step buckets,
  a segmented run with decoded previews) the port's ``traces`` equal the
  reference's jit traces, and the same quanta go unobserved.
"""
import itertools
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JCfg  # noqa: E402
from repro.engine import CostModel as JCostModel  # noqa: E402
from repro.engine import DiffusionEngine as JDiff  # noqa: E402
from repro.engine import GenerateRequest as JGen  # noqa: E402
from repro.engine import diffusion_engine as jde  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro_torch.configs import TINY_SD  # noqa: E402
from repro_torch.configs.base import ModelConfig as TCfg  # noqa: E402
from repro_torch.engine import (CostModel, DiffusionEngine,  # noqa: E402
                                GenerateRequest, calibrate)
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
              head_dim=32)
JCFG, TCFG = JCfg(**CFG_KW), TCfg(**CFG_KW)
# Tie-stable prompts (see tests/test_torch_router.py): every greedy token
# has a top-2 lm_forward margin >= 0.1 in the reference.
SEEDS = (30, 31, 37, 38, 43, 49, 61, 62, 67, 80, 85)


def jax_noise(req, hw):
    return torch.from_numpy(np.array(jde.request_noise(req, hw)))


def _clock(tick=1e-3):
    ticks = itertools.count()
    return lambda: next(ticks) * tick


def _prompt(seed):
    return [int(t) for t in
            np.random.default_rng(seed).integers(1, 90, 5 + seed % 5)]


def _tokens(seed):
    return np.random.default_rng(seed).integers(0, 512, 77).tolist()


@pytest.fixture(scope="module")
def weights():
    # One jitted init (one compile) instead of the op-by-op eager init.
    jsd = jax.jit(lambda k: jde.init_pipeline(k, jde.TINY_SD))(jax.random.PRNGKey(0))
    jlm = jinit_lm(jax.random.PRNGKey(0), JCFG)
    return (jsd, jlm), (from_reference(jsd, "cpu"), from_reference(jlm, "cpu"))


@pytest.fixture(scope="module")
def jit():
    """The JAX batchers' jitted programs, shared across this module's
    batchers (each would compile its own; their cost model skips a
    quantum by shape, not by jit trace).  The JAX diffusion engines keep
    their own: their first-call skips are what the tests compare."""
    return {}


def _batcher(side, lmp, jit, **kw):
    """A tiny-LM batcher of one package (the JAX one on shared programs)."""
    if side == "port":
        return ContinuousBatcher(lmp, TCFG, device="cpu", **kw)
    cb = JCB(lmp, JCFG, **kw)
    for name in ("step_fn", "_prefill_raw", "_reset_fn", "_copy_fn"):
        setattr(cb, name, jit.setdefault(name, getattr(cb, name)))
    return cb


def _events(eng):
    def scalar(v):
        return round(v, 9) if isinstance(v, float) else v
    return [(type(e).__name__, e.rid) + tuple(
        scalar(getattr(e, k)) for k in ("reason", "estimated_s", "budget_s",
                                        "pos", "token", "phase", "step")
        if hasattr(e, k)) for e in eng.bus.log]


# ------------------------------------------------------------- LM admission
LM_COSTS = (0.004, 0.01)          # seeded (prefill chunk, decode token) s
LM_TICK = 5e-3                    # virtual seconds per clock read
# (rid, max_new, deadline_ms) on one slot: rid 3's budget no estimate
# meets (rejected at submit); rid 0 is admitted, predicted to overrun
# while rid 1 waits (preempted), then rejected at its next pop; rid 2 is
# preempted the same way and expires in the queue (swept).
LM_WORKLOAD = [(0, 8, 150.0), (1, 3, 2000.0), (2, 2, 200.0), (3, 4, 1.0),
               (4, 3, None)]


def _lm_pair(weights, jit, cost: bool):
    out = []
    for side, (_, lmp) in zip(("jax", "port"), weights):
        cm = (JCostModel if side == "jax" else CostModel)() if cost else None
        cb = _batcher(side, lmp, jit, slots=1, max_len=24, block_size=4,
                      prefill_chunk=4, clock=_clock(LM_TICK), cost_model=cm,
                      preempt_over_budget=True)
        if cost:
            kp, kd = cm.lm_keys(cb)
            cm.seed(kp, LM_COSTS[0])
            cm.seed(kd, LM_COSTS[1])
        reqcls = JReq if side == "jax" else Request
        for rid, new, dl in LM_WORKLOAD:
            cb.submit(reqcls(rid=rid, prompt=_prompt(SEEDS[rid]), max_new=new,
                             deadline_ms=dl))
        cb.run()
        out.append(cb)
    return out


@pytest.mark.parametrize("cost", [True, False], ids=["predicted", "after"])
def test_lm_rejections_sweeps_and_preemptions_match(weights, jit, cost):
    jcb, tcb = _lm_pair(weights, jit, cost)
    assert _events(tcb) == _events(jcb)
    assert (tcb.rejections, tcb.preemptions) == (jcb.rejections, jcb.preemptions)
    kinds = {(e[0], e[2]) for e in _events(tcb) if e[0] in ("Rejected", "Preempted")}
    assert ("Preempted", "deadline-overrun") in kinds
    if cost:
        assert {("Rejected", "infeasible"), ("Rejected", "expired")} <= kinds
        assert tcb.cost_model.snapshot() == jcb.cost_model.snapshot()
        assert tcb._cm_warm == jcb._cm_warm
    else:
        assert not tcb.rejections
    assert {r.rid: r.out for r in tcb.finished} == {r.rid: r.out for r in jcb.finished}
    tcb.runtime.check_consistency()
    assert tcb.runtime.allocated_blocks == 0


def test_lm_next_slack_and_deadline(weights, jit):
    """``next_slack`` is deadline - now - estimate, the raw deadline
    without a cost model, as in the reference."""
    for cost in (False, True):
        vals = []
        for side, (_, lmp) in zip(("jax", "port"), weights):
            cm = (JCostModel if side == "jax" else CostModel)() if cost else None
            reqcls = JReq if side == "jax" else Request
            cb = _batcher(side, lmp, jit, slots=1, max_len=24, prefill_chunk=4,
                          clock=_clock(), cost_model=cm)
            if cost:
                kp, kd = cm.lm_keys(cb)
                cm.seed(kp, 0.01)
                cm.seed(kd, 0.02)
            assert cb.next_deadline() == cb.next_slack() == float("inf")
            for rid, dl in ((0, 300.0), (1, 100.0), (2, None)):
                cb.submit(reqcls(rid=rid, prompt=_prompt(SEEDS[rid]), max_new=4,
                                 deadline_ms=dl))
            cb.step()
            vals.append((round(cb.next_deadline(), 9), round(cb.next_slack(), 9)))
        assert vals[0] == vals[1]


# ------------------------------------------------------ diffusion admission
def _diff_pair(weights, workload, cost=True, max_batch=2, seed_costs=None):
    out = []
    for side, (sdp, _) in zip(("jax", "port"), weights):
        cm = (JCostModel if side == "jax" else CostModel)() if cost else None
        if side == "jax":
            eng = JDiff(sdp, jde.TINY_SD, max_batch=max_batch, clock=_clock(),
                        cost_model=cm)
        else:
            eng = DiffusionEngine(sdp, TINY_SD, max_batch=max_batch,
                                  clock=_clock(), cost_model=cm, device="cpu",
                                  noise_fn=jax_noise)
        gen = JGen if side == "jax" else GenerateRequest
        calls = []
        inner = eng._observe

        def observe(key, t0, traces0, *rest, _inner=inner, _eng=eng, _c=calls):
            _c.append((key[2], _eng.traces != traces0))
            return _inner(key, t0, traces0, *rest)
        eng._observe = observe
        for name, kw, cost_s in seed_costs or ():
            probe = gen(rid=-1, tokens=_tokens(0), **kw)
            cm.seed(cm._diff_keys(eng, probe)[name], cost_s)
        for rid, kw in workload:
            eng.submit(gen(rid=rid, tokens=_tokens(rid), seed=rid, **kw))
        eng.run()
        out.append((eng, calls))
    return out


def test_diffusion_rejections_and_sweep_match(weights):
    """A seeded fused cost: the 1 ms request is rejected at submit, the
    request whose budget runs out behind the queue is swept, and the
    queue-wait charge rejects a request that is feasible alone."""
    workload = [(0, dict(deadline_ms=None)), (1, dict(deadline_ms=None)),
                (2, dict(deadline_ms=None)),
                (3, dict(deadline_ms=60.0)), (4, dict(deadline_ms=1.0)),
                (5, dict(deadline_ms=45.0))]
    (je, _), (te, _) = _diff_pair(weights, workload,
                                  seed_costs=[("fused", {}, 0.040)])
    assert _events(te) == _events(je)
    assert te.rejections == je.rejections >= 2
    reasons = [e[2] for e in _events(te) if e[0] == "Rejected"]
    assert "infeasible" in reasons
    assert {r.rid for r in te.finished} == {r.rid for r in je.finished}
    assert te.cost_model.snapshot() == je.cost_model.snapshot()
    assert te.quanta == je.quanta


def test_traces_and_skipped_observations_match(weights):
    """First calls of each program key: two fused step buckets (turbo at
    1, ddim 3 steps at bucket 4), then a segmented euler run with decoded
    previews (encode, step and decode keys)."""
    workload = [(0, {}), (1, dict(sampler="ddim", steps=3)), (2, {}),
                (3, dict(sampler="ddim", steps=3)),
                (4, dict(sampler="euler", steps=2, preview_every=2)),
                (5, {})]
    (je, jcalls), (te, tcalls) = _diff_pair(weights, workload, max_batch=1)
    assert te.traces == je.traces == 5
    assert tcalls == jcalls
    assert sum(skip for _, skip in tcalls) == 5
    assert te.quanta == je.quanta
    snap_t = {k: n for k, (_, n) in te.cost_model.snapshot().items()}
    assert snap_t == {k: n for k, (_, n) in je.cost_model.snapshot().items()}


def test_calibrate_seeds_both_engines_alike(weights, jit):
    """``calibrate`` drains deadline-free requests into the table."""
    snaps = []
    for side, (_, lmp) in zip(("jax", "port"), weights):
        cm = (JCostModel if side == "jax" else CostModel)()
        reqcls = JReq if side == "jax" else Request
        cb = _batcher(side, lmp, jit, slots=2, max_len=24, prefill_chunk=4,
                      clock=_clock(), cost_model=cm)
        if side == "port":
            assert calibrate(cb, [reqcls(rid=i, prompt=_prompt(SEEDS[i]),
                                         max_new=4) for i in range(2)]) is cm
        else:
            from repro.engine import calibrate as jcalibrate
            jcalibrate(cb, [reqcls(rid=i, prompt=_prompt(SEEDS[i]), max_new=4)
                            for i in range(2)])
        snaps.append(cm.snapshot())
    assert snaps[0] == snaps[1] and len(snaps[1]) == 2
    with pytest.raises(ValueError, match="no cost model"):
        calibrate(ContinuousBatcher(weights[1][1], TCFG, max_len=8, device="cpu"), [])


# ------------------------------------------------------------- persistence
def test_save_and_load_across_packages(tmp_path):
    keys = [("lm", "t", "prefill", True, False, None),
            ("lm", "t", "decode", False, "q8_0"),
            ("diff", "tiny-sd", "fused", "ddim", 4, 8, True, 2, None),
            ("lm", "t", "decode-spec", "d", 4, False, None)]
    port = CostModel(alpha=0.25)
    for i, k in enumerate(keys):
        port.seed(k, 0.01 * (i + 1))
        port.observe(k, 0.02 * (i + 1))
    a, b, c = (str(tmp_path / n) for n in ("a.json", "b.json", "c.json"))
    port.save(a)
    ref = JCostModel.load(a)
    assert ref.alpha == 0.25 and ref.snapshot() == port.snapshot()
    ref.save(b)
    back = CostModel.load(b)
    back.save(c)
    with open(a) as fa, open(b) as fb, open(c) as fc:
        assert json.load(fa) == json.load(fb) == json.load(fc)
    assert back.snapshot() == port.snapshot()
    for k in keys:
        assert back.cost(k) == port.cost(k)
    with open(a, "w") as f:
        f.write('{"version": 2, "alpha": 0.3, "entries": []}')
    for cls in (CostModel, JCostModel):
        with pytest.raises(ValueError, match="version"):
            cls.load(a)
