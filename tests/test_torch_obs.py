"""Port parity: the telemetry copy (``repro_torch.obs``) and the engines'
instrumentation, against ``repro.obs`` and the JAX engines.

* The same registry calls give the same Prometheus text, rows and JSON
  snapshot; the same events and phase marks give the same traces.
* A mixed router workload on the same virtual clock with ``Telemetry``
  attached to both packages' routers gives the same Prometheus text,
  snapshot and Chrome trace: the port's phase histograms, queue, slot,
  trace and KV-pool gauges and event counters are the reference's.
* The phase counts reconcile with ``prefill_quanta`` / ``decode_quanta``
  and the diffusion engine's ``quanta``, each rid has one root span, and
  attaching telemetry changes no event and no output.
"""
import dataclasses
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs.base import ModelConfig as JCfg  # noqa: E402
from repro.engine import CostModel as JCostModel  # noqa: E402
from repro.engine import DiffusionEngine as JDiff  # noqa: E402
from repro.engine import EngineRouter as JRouter  # noqa: E402
from repro.engine import GenerateRequest as JGen  # noqa: E402
from repro.engine import diffusion_engine as jde  # noqa: E402
from repro.engine import events as jev  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs import TINY_SD  # noqa: E402
from repro_torch.configs.base import ModelConfig as TCfg  # noqa: E402
from repro_torch.engine import (CostModel, DiffusionEngine,  # noqa: E402
                                EngineRouter, GenerateRequest)
from repro_torch.engine import events as tev  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
              head_dim=32)
JCFG, TCFG = JCfg(**CFG_KW), TCfg(**CFG_KW)
LM_KW = dict(slots=2, max_len=24, block_size=4, prefill_chunk=4,
             prefix_share=True)
# Tie-stable prompts (see tests/test_torch_router.py).
SEEDS = (30, 31, 37, 38, 43, 49, 61, 62, 67, 80, 85)


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


# ------------------------------------------------------------ registry
def _drive_registry(mod):
    reg = mod.MetricsRegistry(clock=lambda: 5.0)
    c = reg.counter("reqs_total", 'all "requests", by engine\nand kind',
                    labels=("engine", "kind"))
    c.inc(engine="lm", kind="a\\b")
    c.inc(2.5, engine="diffusion", kind="x")
    g = reg.gauge("depth", "queue depth")
    g.set(4)
    g.inc(3)
    g.dec(0.5)
    h = reg.histogram("lat", "latency", labels=("phase",),
                      buckets=(0.001, 0.01, 0.1))
    for v, ph in ((0.0005, "a"), (0.01, "a"), (0.5, "b"), (0.05, "a")):
        h.observe(v, phase=ph)
    reg.histogram("err", buckets=mod.DEFAULT_ERROR_BUCKETS).observe(0.2)
    reg.counter("plain").inc()
    return reg


def test_registry_text_rows_and_snapshot_match():
    jreg, treg = _drive_registry(jobs), _drive_registry(tobs)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.rows() == jreg.rows()
    assert treg.snapshot_record("s", "b") == jreg.snapshot_record("s", "b")
    assert (tobs.DEFAULT_TIME_BUCKETS, tobs.DEFAULT_ERROR_BUCKETS,
            tobs.SNAPSHOT_SCHEMA_VERSION) == (
        jobs.DEFAULT_TIME_BUCKETS, jobs.DEFAULT_ERROR_BUCKETS,
        jobs.SNAPSHOT_SCHEMA_VERSION)
    with pytest.raises(ValueError, match="already registered"):
        treg.gauge("reqs_total", labels=("engine", "kind"))
    with pytest.raises(ValueError, match="labels"):
        treg.get("reqs_total").inc(engine="lm")


def test_telemetry_and_trace_from_the_same_events(tmp_path):
    """Each package's Telemetry on its own bus, fed the same events and
    phase marks: the same metrics and the same Chrome trace."""
    out = []
    for mod, ev in ((jobs, jev), (tobs, tev)):
        tele = mod.Telemetry(tracer=mod.TraceRecorder(), clock=lambda: 0.0)
        bus = ev.EventBus(_clock())
        tele.attach(bus)
        tele.request_submitted(0, "lm", 0.0)
        tele.request_submitted(1, "diffusion", 0.0)
        bus.emit(ev.Admitted, 0, slot=1)
        tele.phase("lm", "prefill", 0.001, 0.004, rids=(0,), args={"tokens": 4})
        bus.emit(ev.TokenDelta, 0, token=5, pos=0)
        bus.emit(ev.Preempted, 0, reason="deadline-overrun")
        bus.emit(ev.Progress, 0, phase="resume", step=1, total=3)
        bus.emit(ev.Finished, 0, result=None)
        bus.emit(ev.Rejected, 1, estimated_s=0.5, budget_s=0.001,
                 reason="infeasible")
        tele.phase("diffusion", "fused", 0.01, 0.03, rids=(2,), args=None)
        bus.emit(ev.Cancelled, 3)
        path = tmp_path / f"{mod.__name__}.json"
        tele.tracer.export(str(path))
        out.append((tele.registry.to_prometheus(), tele.tracer.to_chrome(),
                    path.read_text(), tele.tracer.rids(),
                    [tele.tracer.outcome(r) for r in range(4)]))
    assert out[0] == out[1]
    assert out[1][4] == ["finished", "rejected", None, "cancelled"]


def test_cost_model_error_histogram_matches():
    texts = []
    for mod, cm_cls in ((jobs, JCostModel), (tobs, CostModel)):
        reg = mod.MetricsRegistry()
        cm = cm_cls(metrics=reg)
        cm.seed(("lm", "m", "decode", False, None), 0.1)
        for a in (0.02, 0.03, 0.02, 0.5):
            cm.observe(("lm", "m", "decode", False, None), a)
        texts.append((reg.to_prometheus(), cm.snapshot()))
    assert texts[0] == texts[1]


# ------------------------------------------------------- engines, routers
@pytest.fixture(scope="module")
def weights():
    # One jitted init (one compile) instead of the op-by-op eager init.
    jsd = jax.jit(lambda k: jde.init_pipeline(k, jde.TINY_SD))(jax.random.PRNGKey(0))
    jlm = jinit_lm(jax.random.PRNGKey(0), JCFG)
    return (jsd, jlm), (from_reference(jsd, "cpu"), from_reference(jlm, "cpu"))


# (rid, kind, kwargs): fused and segmented images (latent previews), LM
# requests sharing a prompt prefix, one with a deadline.
WORKLOAD = [(0, "img", {}), (1, "lm", dict(seed=0)),
            (2, "img", dict(sampler="euler", steps=2, preview_every=1)),
            (3, "lm", dict(seed=1, deadline_ms=900.0)), (4, "lm", dict(seed=0)),
            (5, "img", {})]


def _serve(side, weights, telemetry: bool):
    sdp, lmp = weights[0 if side == "jax" else 1]
    clock = _clock()
    mod = jobs if side == "jax" else tobs
    tele = mod.Telemetry(tracer=mod.TraceRecorder(), clock=clock) if telemetry else None
    if side == "jax":
        d = JDiff(sdp, jde.TINY_SD, max_batch=2, clock=clock, metrics=tele)
        lm = JCB(lmp, JCFG, clock=clock, metrics=tele, **LM_KW)
        router = JRouter(diffusion=d, lm=lm, metrics=tele)
        gen, req = JGen, JReq
    else:
        d = DiffusionEngine(sdp, TINY_SD, max_batch=2, clock=clock, metrics=tele,
                            device="cpu", noise_fn=jax_noise)
        lm = ContinuousBatcher(lmp, TCFG, clock=clock, metrics=tele,
                               device="cpu", **LM_KW)
        router = EngineRouter(diffusion=d, lm=lm, metrics=tele)
        gen, req = GenerateRequest, Request
    if tele is not None:
        tele.attach(router.bus)
    for rid, kind, kw in WORKLOAD:
        if kind == "img":
            router.submit(gen(rid=rid, tokens=_tokens(rid), seed=rid, **kw))
        else:
            kw = dict(kw)
            router.submit(req(rid=rid, prompt=_prompt(SEEDS[kw.pop("seed")]),
                              max_new=4, **kw))
    router.run()
    return router, tele


@pytest.fixture(scope="module")
def served(weights):
    return {side: _serve(side, weights, True) for side in ("jax", "port")}


def _events(router):
    skip = ("result", "latent")
    return [(type(e).__name__,) + tuple(
        (f.name, getattr(e, f.name)) for f in dataclasses.fields(e)
        if f.name not in skip) for e in router.bus.log]


def test_engine_metrics_and_trace_match_reference(served):
    (jr, jt), (tr, tt) = served["jax"], served["port"]
    assert _events(tr) == _events(jr)
    assert tt.registry.to_prometheus() == jt.registry.to_prometheus()
    assert tt.registry.snapshot_record() == jt.registry.snapshot_record()
    assert tt.tracer.to_chrome() == jt.tracer.to_chrome()
    assert tr.diffusion.traces == jr.diffusion.traces
    # The gauge is read at the start of each quantum, as in the reference.
    assert 0 < tt.registry.get("diffusion_traces").value() <= tr.diffusion.traces == 4


def test_phase_counts_reconcile_with_quanta(served):
    router, tele = served["port"]
    d, lm = router.diffusion, router.lm
    ph = tele.registry.get("phase_seconds")
    assert ph.count(engine="lm", phase="prefill") == lm.prefill_quanta > 0
    assert ph.count(engine="lm", phase="decode") == lm.decode_quanta > 0
    assert (ph.count(engine="diffusion", phase="fused")
            + ph.count(engine="diffusion", phase="unet_step")) == d.quanta > 0
    assert ph.count(engine="diffusion", phase="clip") == 1     # one segmented batch
    steps = tele.registry.get("router_steps_total")
    assert steps.value(engine="diffusion") + steps.value(engine="lm") == \
        d.quanta + lm.prefill_quanta + lm.decode_quanta
    rids = sorted({e.rid for e in router.bus.log})
    assert tele.tracer.rids() == rids
    for rid in rids:
        root, children = tele.tracer.request_tree(rid)
        assert root is not None and root.args["outcome"] == "finished"
        assert sum(s.name == "request" for s in tele.tracer.request_spans(rid)) == 1
        assert children and children[0].name == "queue_wait"
    kv = tele.registry.get("kv_pool_blocks")
    assert kv.value(state="allocated") == lm.runtime.allocated_blocks
    assert tele.registry.get("kv_prefix_hits").value() == lm.runtime.prefix.hits > 0
    assert tele.registry.get("requests_terminal_total").value(
        engine="lm", outcome="finished") == 3


def test_telemetry_changes_no_event_or_output(weights, served):
    plain, _ = _serve("port", weights, False)
    traced, _ = served["port"]
    assert _events(plain)[0][0] == "Admitted"
    strip = [[f for f in e if f[0] not in ("ts", "seq")] for e in _events(plain)]
    assert strip == [[f for f in e if f[0] not in ("ts", "seq")]
                     for e in _events(traced)]
    for a, b in zip(plain.diffusion.finished, traced.diffusion.finished):
        assert torch.equal(a.image, b.image)
    assert [r.out for r in plain.lm.finished] == [r.out for r in traced.lm.finished]
