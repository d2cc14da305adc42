"""Port parity: migration (``evacuate``/``adopt``), ``FleetManager`` and
``ReplicaHealth`` against the JAX package.

* Engine level: requests evacuated from one engine and adopted by a
  second on a shared bus end with the tokens of an uninterrupted run
  (the decode-step-scan prefill is exact) and images within the engine's
  bound of the reference's (corr > 0.9999, max|d| <= 5e-2), the port's
  restarted image with its uninterrupted bits; the event log is the
  reference's.
* Fleet level: a kill, an eviction mid-prefill, a drain, a hang and a
  slow window (virtual clock) give the reference's event log, stats and
  tokens; replicas that are routers migrate both request types.
* ``ReplicaHealth`` walks the reference's states and counts the same
  transitions for a scripted sequence of step times; ``FaultInjector``
  fires at the same quanta.
* Replicas built from one weight tree share its tensors.

The JAX engines of one kind share their jitted programs (test plumbing:
each JAX engine would otherwise compile its own).
"""
import dataclasses
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JCfg  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.engine import DiffusionEngine as JDiff  # noqa: E402
from repro.engine import EngineRouter as JRouter  # noqa: E402
from repro.engine import EventBus as JBus  # noqa: E402
from repro.engine import FaultInjector as JInjector  # noqa: E402
from repro.engine import FleetManager as JFleet  # noqa: E402
from repro.engine import GenerateRequest as JGen  # noqa: E402
from repro.engine import ReplicaSpec as JSpec  # noqa: E402
from repro.engine import diffusion_engine as jde  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro_torch.configs import TINY_SD  # noqa: E402
from repro_torch.configs.base import ModelConfig as TCfg  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.engine import (DiffusionEngine, EngineConfig,  # noqa: E402
                                EngineRouter, EventBus, FaultInjector,
                                FleetManager, GenerateRequest, LMEngineConfig,
                                ReplicaFault, ReplicaSpec)
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402

pytestmark = pytest.mark.serving

CORR, MAX_ABS = 0.9999, 5e-2
CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
              head_dim=32)
JCFG, TCFG = JCfg(**CFG_KW), TCfg(**CFG_KW)
LM_KW = dict(slots=2, max_len=32, prefill_chunk=4, fused_prefill=False)
NO_WD = dict(watchdog_threshold=1e9)
# Tie-stable prompts (see tests/test_torch_router.py): every greedy token
# has a top-2 lm_forward margin >= 0.1 in the reference.
SEEDS = (30, 31, 37, 38, 43, 49, 61, 62, 67, 80, 85)
# Segmented images: euler, 3 steps, a latent preview every step.
IMG = dict(sampler="euler", steps=3, preview_every=1)


def jax_noise(req, hw):
    return torch.from_numpy(np.array(jde.request_noise(req, hw)))


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


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
def makers(weights):
    """Engine factories per side: ``lm(**kw)`` and ``diffusion(**kw)``;
    the JAX ones share jitted programs across instances."""
    (jsd, jlm), (tsd, tlm) = weights
    fns: dict = {}
    diff_fns: dict = {}

    def jlm_make(**kw):
        kw = {**LM_KW, **kw}
        cb = JCB(jlm, JCFG, **kw)
        for name in ("step_fn", "_prefill_raw", "_reset_fn", "_copy_fn"):
            setattr(cb, name, fns.setdefault(name, getattr(cb, name)))
        return cb

    def jdiff_make(**kw):
        eng = JDiff(jsd, jde.TINY_SD, max_batch=2, **kw)
        eng._fns = diff_fns
        return eng

    def tlm_make(**kw):
        return ContinuousBatcher(tlm, TCFG, device="cpu", **{**LM_KW, **kw})

    def tdiff_make(**kw):
        return DiffusionEngine(tsd, TINY_SD, max_batch=2, device="cpu",
                               noise_fn=jax_noise, **kw)
    return {"jax": (jlm_make, jdiff_make, JReq, JGen),
            "port": (tlm_make, tdiff_make, Request, GenerateRequest)}


def _events(log):
    skip = ("result", "latent", "ts", "seq")
    return [(type(e).__name__,) + tuple(
        (f.name, getattr(e, f.name)) for f in dataclasses.fields(e)
        if f.name not in skip) for e in log]


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


def _close(a, b):
    a, b = a.ravel(), b.ravel()
    return np.corrcoef(a, b)[0, 1] > CORR and np.abs(a - b).max() <= MAX_ABS


def _finished(log):
    toks = {e.rid: list(e.result.out) for e in log
            if type(e).__name__ == "Finished" and hasattr(e.result, "out")}
    imgs = {e.rid: _np(e.result.image) for e in log
            if type(e).__name__ == "Finished" and hasattr(e.result, "image")}
    return toks, imgs


# ----------------------------------------------------------- engine level
def _migrate(make, bus_cls, reqs, steps):
    """Serve ``reqs`` on engine A for ``steps`` quanta, evacuate it, adopt
    everything on engine B (same bus), drain B."""
    bus = bus_cls(_clock())
    a, b = make(bus=bus), make(bus=bus)
    for r in reqs:
        a.submit(r)
    for _ in range(steps):
        a.step()
    moved = a.evacuate("replica-evicted")
    for r in moved:
        b.adopt(r)
    b.run()
    assert not a.has_work() and not b.has_work()
    return bus, [r.rid for r in moved]


def test_lm_evacuate_adopt_keeps_tokens(makers):
    out = {}
    for side, bus_cls in (("jax", JBus), ("port", EventBus)):
        lm, _, req, _ = makers[side]

        def reqs():
            return [req(rid=i, prompt=_prompt(SEEDS[i]), max_new=5)
                    for i in range(3)]
        # Step 3: rid 0 decoding, rid 1 mid-prefill, rid 2 queued.
        bus, moved = _migrate(lm, bus_cls, reqs(), 3)
        plain = lm(clock=_clock())
        for r in reqs():
            plain.submit(r)
        plain.run()
        out[side] = (bus.log, moved, {r.rid: r.out for r in plain.finished})
    (jlog, jmoved, jplain), (tlog, tmoved, tplain) = out["jax"], out["port"]
    assert _events(tlog) == _events(jlog)
    assert tmoved == jmoved == [0, 1, 2]
    toks = _finished(tlog)[0]
    assert toks == tplain == jplain
    kinds = [(e[0], e[1]) for e in _events(tlog)]
    assert kinds.count(("Preempted", ("rid", 0))) == 1
    assert ("Progress", ("rid", 1)) in kinds


def test_diffusion_evacuate_adopt_restarts_from_the_seed(makers):
    out = {}
    for side, bus_cls in (("jax", JBus), ("port", EventBus)):
        _, diff, _, gen = makers[side]

        def reqs():
            return [gen(rid=i, tokens=_tokens(i), seed=i, **IMG) for i in range(3)]
        # One step: rids 0 and 1 one denoise step in, rid 2 queued.
        bus, moved = _migrate(diff, bus_cls, reqs(), 1)
        plain = diff(clock=_clock())
        for r in reqs():
            plain.submit(r)
        plain.run()
        out[side] = (bus.log, moved, {r.rid: _np(r.image) for r in plain.finished})
    (jlog, jmoved, jplain), (tlog, tmoved, tplain) = out["jax"], out["port"]
    assert _events(tlog) == _events(jlog)
    assert tmoved == jmoved == [0, 1, 2]
    imgs = _finished(tlog)[1]
    assert sorted(imgs) == [0, 1, 2]
    for rid, img in imgs.items():
        assert np.array_equal(img, tplain[rid])     # same batch bucket: bits
        assert _close(jplain[rid], img)
    resumed = [e for e in tlog if type(e).__name__ == "Progress"
               and e.phase == "resume"]
    assert [e.rid for e in resumed] == [0, 1]     # rid 2 was still queued


def test_next_deadline_and_slack_without_cost_model(makers):
    """Without a cost model the slack is the deadline less the clock, over
    queued and in-flight requests, as in the reference."""
    seen = []
    for side in ("jax", "port"):
        _, diff, _, gen = makers[side]
        eng = diff(clock=_clock())
        vals = [(eng.next_deadline(), eng.next_slack())]
        eng.submit(gen(rid=0, tokens=_tokens(0), deadline_ms=50.0, **IMG))
        eng.submit(gen(rid=1, tokens=_tokens(1), deadline_ms=20.0, **IMG))
        eng.submit(gen(rid=2, tokens=_tokens(2), **IMG))
        for _ in range(4):
            vals.append((round(eng.next_deadline(), 9), round(eng.next_slack(), 9)))
            eng.step()
        seen.append(vals)
    assert seen[0] == seen[1]
    assert seen[1][0] == (float("inf"), float("inf"))
    assert all(dl > sl or dl == sl == float("inf") for dl, sl in seen[1][1:])
    assert seen[1][1][0] < float("inf")


# ------------------------------------------------------------ fleet level
def _fleet(makers, side, names, kw=None, clock=None, **fleet_kw):
    lm = makers[side][0]
    spec_cls, fleet_cls = (JSpec, JFleet) if side == "jax" else (ReplicaSpec, FleetManager)
    specs = [spec_cls(n, lambda: lm(**(kw or {}))) for n in names]
    if clock is not None:
        fleet_kw["clock"] = clock
    return fleet_cls(specs, **fleet_kw)


SCENARIOS = {
    # name: (requests (rid, max_new), fleet kwargs, injector plan)
    "kill": ([(i, 5) for i in range(4)], NO_WD, ("kill", "a", 2)),
    "mid_prefill": ([(5, 4)], NO_WD, ("kill", "a", 1)),
    "replace": ([(i, 5) for i in range(6)], dict(NO_WD, replace_evicted=True),
                ("kill", "a", 2)),
    "hang": ([(i, 4) for i in range(4)],
             dict(watchdog_threshold=3.0, suspect_limit=2), ("hang", "a", 2)),
    "slow": ([(i, 4) for i in range(4)],
             dict(watchdog_threshold=3.0, suspect_limit=2),
             ("slow", "a", 1, 0.5, 1)),
    "drain": ([(i, 3) for i in range(4)], NO_WD, None),
}


def _run_scenario(makers, side, name):
    reqs, fleet_kw, plan = SCENARIOS[name]
    req = makers[side][2]
    inj = None
    if plan is not None:
        inj = (JInjector if side == "jax" else FaultInjector)()
        getattr(inj, plan[0])(*plan[1:])
    # A constant virtual clock: measured quanta take 0 s, so the injected
    # durations are the watchdog's only signal.
    fleet = _fleet(makers, side, ("a", "b"), clock=lambda: 0.0, injector=inj,
                   **fleet_kw)
    if name == "drain":
        fleet.submit(req(rid=0, prompt=_prompt(SEEDS[0]), max_new=3))
        fleet.drain("a")
        reqs = reqs[1:]
    for rid, new in reqs:
        fleet.submit(req(rid=rid, prompt=_prompt(SEEDS[rid]), max_new=new))
    fleet.run()
    return fleet


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fleet_scenarios_match_reference(makers, name):
    jf = _run_scenario(makers, "jax", name)
    tf = _run_scenario(makers, "port", name)
    assert _events(tf.bus.log) == _events(jf.bus.log)
    assert tf.stats() == jf.stats()
    toks = _finished(tf.bus.log)[0]
    assert toks == _finished(jf.bus.log)[0]
    stats = tf.stats()
    assert not stats["lost"]
    want = {"kill": 2, "mid_prefill": 1, "replace": None, "hang": None,
            "slow": 0, "drain": 0}[name]
    if want is not None:
        assert stats["migrations"] == want
    if name == "hang":
        assert [n for n, _ in stats["evictions"]] == ["a"]
        assert "watchdog" in stats["evictions"][0][1]
    if name == "slow":
        assert tf._by_name("a").health.state == tft.HEALTHY
        assert len(tf._by_name("a").health.watchdog.suspects) == 1
    if name == "drain":
        assert stats["evictions"] == [("a", "drained")]
    if name == "replace":
        assert stats["replacements"] == [("a", "a~0")]
    # Every request ends once, and in an uninterrupted run's tokens.
    solo = _fleet(makers, "port", ("solo",), **NO_WD)
    for rid, new in SCENARIOS[name][0]:
        solo.submit(Request(rid=rid, prompt=_prompt(SEEDS[rid]), max_new=new))
    solo.run()
    assert toks == _finished(solo.bus.log)[0]


def test_router_replicas_migrate_both_types(makers):
    out = {}
    for side in ("jax", "port"):
        lm, diff, req, gen = makers[side]
        router_cls, spec_cls, fleet_cls, inj_cls = (
            (JRouter, JSpec, JFleet, JInjector) if side == "jax"
            else (EngineRouter, ReplicaSpec, FleetManager, FaultInjector))

        def build():
            return router_cls(diffusion=diff(), lm=lm())

        def reqs():
            return [gen(rid=0, tokens=_tokens(0), seed=0, **IMG),
                    gen(rid=1, tokens=_tokens(1), seed=1, **IMG),
                    req(rid=2, prompt=_prompt(SEEDS[2]), max_new=4),
                    req(rid=3, prompt=_prompt(SEEDS[3]), max_new=4)]
        logs = []
        for plan in (None, ("a", 2)):
            fleet = fleet_cls([spec_cls("a", build), spec_cls("b", build)],
                              injector=inj_cls().kill(*plan) if plan else None,
                              **NO_WD)
            for r in reqs():
                fleet.submit(r)
            fleet.run()
            assert not fleet.stats()["lost"]
            logs.append(fleet)
        out[side] = logs
    (jplain, jkill), (tplain, tkill) = out["jax"], out["port"]
    assert _events(tkill.bus.log) == _events(jkill.bus.log)
    assert tkill.stats() == jkill.stats() and tkill.stats()["migrations"] == 2
    ttok, timg = _finished(tkill.bus.log)
    assert ttok == _finished(jkill.bus.log)[0] == _finished(tplain.bus.log)[0]
    plain_img, jimg = _finished(tplain.bus.log)[1], _finished(jkill.bus.log)[1]
    for rid in (0, 1):
        assert np.array_equal(timg[rid], plain_img[rid])
        assert _close(jimg[rid], timg[rid])


# ------------------------------------------------------- health, injector
def test_replica_health_transitions_match():
    times = [1.0, 1.0, 10.0, 1.0, 10.0, 1.2, 9.0, 9.5, 1.0, 1.0]
    runs = []
    for mod, reg in ((jft, JRegistry()), (tft, MetricsRegistry())):
        h = mod.ReplicaHealth(mod.Watchdog(threshold=3.0), suspect_limit=2,
                              name="r", metrics=reg)
        states = [h.observe_step(k, t) for k, t in enumerate(times)]
        runs.append((states, h.reason, h.watchdog.suspects, h.watchdog.ewma,
                     reg.to_prometheus()))
    assert runs[0] == runs[1]
    assert runs[1][0][-1] == tft.EVICTED and "watchdog" in runs[1][1]
    drained = tft.ReplicaHealth()
    drained.drain()
    assert drained.live and not drained.dispatchable
    drained.evict("gone")
    drained.evict("again")
    assert drained.state == tft.EVICTED and drained.reason == "gone"
    ticks = iter([10.0, 10.5, 20.0, 20.25])
    wd = tft.Watchdog(threshold=100.0)
    timer = tft.StepTimer(wd, clock=lambda: next(ticks))
    for _ in range(2):
        with timer:
            pass
    assert wd.ewma == pytest.approx(0.5 * 0.8 + 0.25 * 0.2)


def test_fault_injector_matches():
    plans = []
    for cls in (JInjector, FaultInjector):
        inj = cls().kill("k", 3).hang("h", 2).slow("s", 1, 0.5, for_steps=2)
        row = [(inj.extra_s(n, k), n == "k" and k == 3)
               for n in ("k", "h", "s", "x") for k in range(5)]
        plans.append(row)
    assert plans[0] == plans[1]
    with pytest.raises(ReplicaFault, match="kill of k at step 3"):
        FaultInjector().kill("k", 3).check("k", 3)


# ------------------------------------------------------------ shared weights
def test_replicas_share_one_weight_tree(weights):
    tlm = weights[1][1]
    conf = EngineConfig(lm=LMEngineConfig(slots=1, max_len=16))
    fleet = FleetManager([ReplicaSpec(n, params=tlm, model_cfg=TCFG, config=conf,
                                      device="cpu") for n in ("a", "b")],
                         replace_evicted=True, injector=FaultInjector().kill("a", 0),
                         **NO_WD)
    a, b = (r.engine for r in fleet.replicas)
    for eng in (a, b):
        assert eng.params["embed"].w is tlm["embed"].w
        assert eng.params["layers"][1]["mlp"]["up"].w is tlm["layers"][1]["mlp"]["up"].w
    assert a.cache[0][0].data_ptr() != b.cache[0][0].data_ptr()
    fleet.submit(Request(rid=0, prompt=_prompt(SEEDS[0]), max_new=2))
    fleet.run()
    assert fleet.stats()["replacements"] == [("a", "a~0")]
    assert fleet._by_name("a~0").engine.params["embed"].w is tlm["embed"].w
    with pytest.raises(NotImplementedError, match="ASR"):
        ReplicaSpec("x", params=tlm, model_cfg=TCFG, engine="asr").make()
