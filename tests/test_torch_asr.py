"""Port parity: the streaming ``AsrEngine`` against the JAX ``AsrEngine``.

The reduced whisper-large-v3 of the reference's ASR tests, the same
weights (``weights.from_reference``) and the same audio (the reference's
``synthetic_audio``; ``jax.random`` cannot be drawn in torch), both
engines on one virtual clock.  Transcripts and event logs are identical
for: chunked = one-shot encodes (and the same cross-pool bits after the
last quantum); audio sharing (hits, the shared blocks read-only); fused
and scan prefill, each against the same reference path (fewer
``prefill_launches`` fused); cancel and preempt freeing both pools;
``evacuate`` / ``adopt``; cost-model rejection and the queue sweep;
``quantized_kv=True`` and ``weight_quant="q8_0"``; a router and a
two-replica fleet with one replica killed mid-encode; and
``build_engine("asr")``.  ``launch.serve.main()`` serves ``--asr`` on
the CPU.

The reference runs op by op (``jax.disable_jit()``): this model's top-2
logit margins are a few bf16 ulps, so only the same rounding gives the
same tokens; run so, it rounds where the port does.
"""
import dataclasses
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.whisper_large_v3 import config as JWHISPER  # noqa: E402
from repro.engine import AsrEngine as JAsr  # noqa: E402
from repro.engine import CostModel as JCostModel  # noqa: E402
from repro.engine import EngineRouter as JRouter  # noqa: E402
from repro.engine import EventBus as JBus  # noqa: E402
from repro.engine import FaultInjector as JInjector  # noqa: E402
from repro.engine import FleetManager as JFleet  # noqa: E402
from repro.engine import ReplicaSpec as JSpec  # noqa: E402
from repro.engine import TranscribeRequest as JReq  # noqa: E402
from repro.models.frontend import synthetic_audio  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.engine import (AsrEngine, AsrEngineConfig,  # noqa: E402
                                CostModel, EngineConfig, EngineRouter,
                                EventBus, FaultInjector, FleetManager,
                                ReplicaSpec, TranscribeRequest, build_engine)
from repro_torch.engine.asr_engine import audio_fingerprint  # noqa: E402
from repro_torch.weights import from_reference, to_tensor  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

SIZE = dict(d_model=64, head_dim=16, d_ff=128, vocab_size=96, encoder_seq=32)
JCFG = jreduced(JWHISPER, **SIZE)
TCFG = reduced(get_config("whisper-large-v3"), **SIZE)
ENG = dict(slots=2, max_len=16, audio_chunk=16, prefill_chunk=4)
NO_WD = dict(watchdog_threshold=1e9)


def _clock(tick=1e-3):
    ticks = itertools.count()
    return lambda: next(ticks) * tick


def _prompt(seed, n=5):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 95, n)]


@pytest.fixture(scope="module")
def side():
    """Per package: (params, audio by seed, engine class, request class,
    event bus class)."""
    jp = jinit_lm(jax.random.PRNGKey(0), JCFG)
    audios = {s: synthetic_audio(jax.random.PRNGKey(s), JCFG) for s in (1, 2, 3)}
    return {"jax": (jp, audios, JAsr, JReq, JBus),
            "port": (from_reference(jp, "cpu"),
                     {s: to_tensor(a) for s, a in audios.items()},
                     AsrEngine, TranscribeRequest, EventBus)}


def _engine(side, name, **kw):
    params, _, cls, _, _ = side[name]
    kw = {**ENG, **kw}
    kw.setdefault("clock", _clock())
    if name == "port":
        return cls(params, TCFG, device="cpu", **kw)
    return cls(params, JCFG, **kw)


def _req(side, name, rid, audio=1, prompt=1, max_new=6, n=5, **kw):
    _, audios, _, req, _ = side[name]
    return req(rid=rid, audio=audios[audio], prompt=_prompt(prompt, n),
               max_new=max_new, **kw)


def _events(log):
    skip = ("result", "latent", "ts", "seq")

    def val(v):
        return round(v, 9) if isinstance(v, float) else v
    return [(type(e).__name__,) + tuple(
        (f.name, val(getattr(e, f.name))) for f in dataclasses.fields(e)
        if f.name not in skip) for e in log]


def _serve(eng, reqs, steps=None):
    """Submit ``reqs`` and step (``steps`` quanta, or to the end), the
    reference op by op."""
    with jax.disable_jit():
        for r in reqs:
            eng.submit(r)
        if steps is None:
            eng.run()
        else:
            for _ in range(steps):
                eng.step()
    return eng


def _outs(eng):
    return {r.rid: list(r.out) for r in eng.finished}


def _both(side, reqs_of, steps=None, **kw):
    """The same workload through a JAX and a port engine: (jax, port)."""
    return tuple(_serve(_engine(side, n, **kw), reqs_of(n), steps)
                 for n in ("jax", "port"))


def _cross_bits(eng, blocks):
    return [(c.cross_k[blocks].view(torch.int16).clone(),
             c.cross_v[blocks].view(torch.int16).clone()) for c in eng.cache]


def test_chunked_encode_equals_one_shot(side):
    """Encodes of 8 and 32 frames per quantum: the same transcripts, the
    same cross-pool bits after the last quantum, the reference's events."""
    outs, bits = {}, {}
    for chunk in (8, 32):
        def reqs(n):
            return [_req(side, n, 0, max_new=3)]
        j, t = _both(side, reqs, steps=-(-32 // chunk), slots=1,
                     audio_chunk=chunk, audio_share=False)
        assert t._audio_left == [0] and t.encode_quanta == -(-32 // chunk)
        bits[chunk] = _cross_bits(t, t.runtime.cross_tables[0])
        _serve(j, [])
        _serve(t, [])
        assert _events(t.bus.log) == _events(j.bus.log)
        assert _outs(t) == _outs(j)
        assert t.finished[0].encode_steps == -(-32 // chunk)
        outs[chunk] = _outs(t)
    assert outs[8] == outs[32]
    for (k8, v8), (k32, v32) in zip(bits[8], bits[32]):
        assert torch.equal(k8, k32) and torch.equal(v8, v32)


def test_audio_sharing_skips_encode_and_reads_only(side):
    """One slot: rid 1 repeats rid 0's audio and adopts its published
    chain (no encode, blocks read-only, the same transcript); rid 2 has
    other audio and encodes."""
    def reqs(n):
        return [_req(side, n, 0), _req(side, n, 1), _req(side, n, 2, audio=2)]
    j, t = _both(side, lambda n: reqs(n)[:1], slots=1)
    before = _cross_bits(t, list(range(t.runtime.cross_num_blocks)))
    held = t.runtime.allocated_cross_blocks
    for eng in (j, t):
        _serve(eng, reqs("jax" if eng is j else "port")[1:2])
    after = _cross_bits(t, list(range(t.runtime.cross_num_blocks)))
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(before, after))
    assert t.runtime.allocated_cross_blocks == held
    for eng in (j, t):
        _serve(eng, reqs("jax" if eng is j else "port")[2:])
    assert _events(t.bus.log) == _events(j.bus.log)
    assert _outs(t) == _outs(j)
    assert t.audio_hits == j.audio_hits == 1 and t.encode_quanta == j.encode_quanta
    done = {r.rid: r for r in t.finished}
    assert done[1].encode_steps == 0 and done[1].out == done[0].out
    assert t.runtime.cross_prefix.hits == j.runtime.cross_prefix.hits > 0


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("weight_quant", [None, "q8_0"])
def test_prefill_paths_match_reference(side, fused, weight_quant):
    """Fused against fused, scan against scan (7-token prompts in chunks
    of 4), two requests on two slots, bf16 or q8_0 weights."""
    def reqs(n):
        return [_req(side, n, i, audio=1 + i, prompt=10 + i, max_new=4, n=7)
                for i in range(2)]
    j, t = _both(side, reqs, fused_prefill=fused, weight_quant=weight_quant,
                 audio_share=False)
    assert t.fused_prefill is j.fused_prefill is fused
    assert _events(t.bus.log) == _events(j.bus.log)
    assert _outs(t) == _outs(j)
    assert (t.prefill_launches, t.prefill_quanta, t.decode_quanta,
            t.encode_quanta) == (j.prefill_launches, j.prefill_quanta,
                                 j.decode_quanta, j.encode_quanta)
    assert t.prefill_launches == (2 * 2 if fused else 2 * 7)


def test_nan_poisoned_recycled_cross_blocks(side):
    """Every free cross block NaN after a first request: the second
    (other audio) transcribes as on a fresh engine."""
    t = _serve(_engine(side, "port", slots=1, audio_share=False),
               [_req(side, "port", 0)])
    free = t.runtime.free_cross_block_ids()
    assert free
    for c in t.cache:
        c.cross_k[free] = float("nan")
        c.cross_v[free] = float("nan")
    _serve(t, [_req(side, "port", 1, audio=2)])
    fresh = _serve(_engine(side, "port", slots=1, audio_share=False),
                   [_req(side, "port", 1, audio=2)])
    assert _outs(t)[1] == _outs(fresh)[1]


def test_quantized_kv_matches_reference():
    """A Q8_0 decoder pool (head_dim 32: Q8_0 blocks run along the head
    dim), fused prefill on it: the reference's transcripts and events."""
    size = dict(SIZE, head_dim=32, d_model=128)
    jcfg = jreduced(JWHISPER, **size)
    tcfg = reduced(get_config("whisper-large-v3"), **size)
    jp = jinit_lm(jax.random.PRNGKey(0), jcfg)
    audios = [synthetic_audio(jax.random.PRNGKey(1), jcfg)]
    kw = dict(ENG, quantized_kv=True)
    j = JAsr(jp, jcfg, clock=_clock(), **kw)
    t = AsrEngine(from_reference(jp, "cpu"), tcfg, clock=_clock(), device="cpu", **kw)
    _serve(j, [JReq(rid=i, audio=a, prompt=_prompt(20 + i), max_new=4)
               for i, a in enumerate(audios)])
    _serve(t, [TranscribeRequest(rid=i, audio=to_tensor(a), prompt=_prompt(20 + i),
                                 max_new=4) for i, a in enumerate(audios)])
    assert _events(t.bus.log) == _events(j.bus.log) and _outs(t) == _outs(j)
    assert t.cache[0].kv.k.dtype == torch.int8 and t.fused_prefill


def test_cancel_and_preempt_free_both_pools(side):
    """rid 0 cancelled mid-encode, rid 1 preempted in decode (re-adopts its
    published audio, no re-encode), rid 2 runs through: the reference's
    events and transcripts; every decoder block back, the cross pool
    holding only the published chains."""
    logs = {}
    for name in ("jax", "port"):
        eng = _engine(side, name)
        with jax.disable_jit():
            for i in range(3):
                eng.submit(_req(side, name, i, audio=1 + i, prompt=30 + i))
            eng.step()                       # rid 0: one encode quantum
            held = eng.runtime.allocated_cross_blocks
            assert eng.cancel(0)
            assert eng.runtime.allocated_cross_blocks < held
            while not (eng.slots[1] is not None and len(eng.slots[1].out) >= 2):
                eng.step()
            enc = eng.encode_quanta
            assert eng.preempt(1)
            eng.run()
        assert eng.encode_quanta == enc and eng.audio_hits == 1
        assert eng.runtime.allocated_blocks == 0
        eng.runtime.check_consistency()
        logs[name] = eng
    j, t = logs["jax"], logs["port"]
    assert _events(t.bus.log) == _events(j.bus.log)
    assert _outs(t) == _outs(j)
    assert t.runtime.allocated_cross_blocks == j.runtime.allocated_cross_blocks
    assert t.runtime.free_cross_block_ids() == j.runtime.free_cross_block_ids()
    kinds = [(e[0], e[1]) for e in _events(t.bus.log)]
    assert ("Cancelled", ("rid", 0)) in kinds and ("Preempted", ("rid", 1)) in kinds


def test_evacuate_adopt_keeps_transcripts(side):
    """Engine A serves three requests for 3 quanta (rid 0 mid-encode),
    evacuates; engine B on the same bus adopts them and re-encodes: the
    uninterrupted transcripts and the reference's events."""
    out = {}
    for name in ("jax", "port"):
        bus = side[name][4](_clock())

        def reqs():
            return [_req(side, name, i, audio=1 + i % 2, prompt=40 + i)
                    for i in range(3)]
        a, b = _engine(side, name, bus=bus), _engine(side, name, bus=bus)
        _serve(a, reqs(), steps=3)
        with jax.disable_jit():
            moved = a.evacuate("replica-evicted")
            for r in moved:
                b.adopt(r)
            b.run()
        plain = _serve(_engine(side, name), reqs())
        out[name] = (bus.log, [r.rid for r in moved], _outs(plain),
                     {r.rid: list(r.out) for r in b.finished})
    (jlog, jmoved, jplain, jdone), (tlog, tmoved, tplain, tdone) = out["jax"], out["port"]
    assert _events(tlog) == _events(jlog)
    assert tmoved == jmoved == [0, 1, 2]
    assert tdone == tplain == jplain == jdone


ASR_COSTS = (0.02, 0.004, 0.01)     # seeded (encode chunk, prefill chunk, decode token) s
# (rid, max_new, deadline_ms) on one slot at 5 ms per clock read, after
# rid 0 (8 tokens, no deadline) took the slot: rid 3's budget no estimate
# meets (rejected at submit); rid 2 fits with the queue's wait at submit,
# becomes infeasible while it waits (rejected from the queue); rid 1 runs.
ASR_WORKLOAD = [(1, 3, 5000.0), (2, 2, 250.0), (3, 4, 1.0)]


def test_cost_model_rejection_and_sweep(side):
    engines = {}
    for name in ("jax", "port"):
        cm = (JCostModel if name == "jax" else CostModel)()
        eng = _engine(side, name, slots=1, clock=_clock(5e-3), cost_model=cm)
        for key, c in zip(cm.asr_keys(eng), ASR_COSTS):
            cm.seed(key, c)
        _serve(eng, [_req(side, name, 0, max_new=8)], steps=1)
        slack = []
        with jax.disable_jit():
            for rid, new, dl in ASR_WORKLOAD:
                eng.submit(_req(side, name, rid, audio=1 + rid % 2, prompt=50 + rid,
                                max_new=new, deadline_ms=dl))
                slack.append((round(eng.next_deadline(), 9), round(eng.next_slack(), 9)))
            eng.run()
        engines[name] = (eng, slack)
    (j, jslack), (t, tslack) = engines["jax"], engines["port"]
    assert tslack == jslack
    assert _events(t.bus.log) == _events(j.bus.log)
    rejected = [(e.rid, e.reason) for e in t.bus.log if type(e).__name__ == "Rejected"]
    assert rejected == [(3, "infeasible"), (2, "infeasible")]
    first_token = next(i for i, e in enumerate(t.bus.log) if type(e).__name__ == "TokenDelta")
    swept = next(i for i, e in enumerate(t.bus.log)
                 if type(e).__name__ == "Rejected" and e.rid == 2)
    assert swept > first_token                 # from the queue, not at submit
    assert t.cost_model.snapshot() == j.cost_model.snapshot()
    assert _outs(t) == _outs(j) and sorted(_outs(t)) == [0, 1]


def test_router_and_fleet_kill_mid_encode(side):
    """An ``EngineRouter`` with only ``asr=``, and a fleet of two ASR
    replicas whose replica a is killed at its second quantum (mid-encode):
    the reference's events and stats, transcripts of an uninterrupted run."""
    got = {}
    for name in ("jax", "port"):
        if name == "jax":
            router_cls, spec_cls, fleet_cls, inj = JRouter, JSpec, JFleet, JInjector()
        else:
            router_cls, spec_cls, fleet_cls, inj = (EngineRouter, ReplicaSpec,
                                                   FleetManager, FaultInjector())

        def reqs():
            return [_req(side, name, i, audio=1 + i % 3, prompt=60 + i, max_new=4)
                    for i in range(3)]
        router = router_cls(asr=_engine(side, name))
        _serve(router, reqs())

        def make(name=name):
            return _engine(side, name, clock=lambda: 0.0)
        fleet = fleet_cls([spec_cls(n, make) for n in ("a", "b")],
                          injector=inj.kill("a", 1), clock=lambda: 0.0, **NO_WD)
        _serve(fleet, reqs())
        got[name] = (router, fleet)
    (jr, jf), (tr, tf) = got["jax"], got["port"]
    assert _events(tr.bus.log) == _events(jr.bus.log)
    assert _events(tf.bus.log) == _events(jf.bus.log)
    assert tf.stats() == jf.stats() and tf.stats()["migrations"]
    plain = {e.rid: list(e.result.out) for e in tr.bus.log
             if type(e).__name__ == "Finished"}
    killed = {e.rid: list(e.result.out) for e in tf.bus.log
              if type(e).__name__ == "Finished"}
    assert killed == plain and sorted(plain) == [0, 1, 2]
    assert not tf.stats()["lost"]


def test_build_engine_and_validation(side):
    params = side["port"][0]
    conf = EngineConfig(asr=AsrEngineConfig(slots=1, max_len=12, audio_chunk=32))
    a = build_engine("asr", params, TCFG, conf, device="cpu", clock=_clock())
    b = AsrEngine(params, TCFG, slots=1, max_len=12, audio_chunk=32, device="cpu",
                  clock=_clock())
    assert _outs(_serve(a, [_req(side, "port", 0)])) == \
        _outs(_serve(b, [_req(side, "port", 0)]))
    eng = _engine(side, "port", slots=1)
    with pytest.raises(ValueError, match="non-empty decoder prompt"):
        eng.submit(TranscribeRequest(rid=0, audio=side["port"][1][1]))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(_req(side, "port", 1, max_new=64))
    with pytest.raises(ValueError, match="audio shape"):
        eng.submit(TranscribeRequest(rid=2, audio=torch.zeros((4, 4)), prompt=[1]))
    eng.submit(_req(side, "port", 3))
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(_req(side, "port", 3))
    with pytest.raises(ValueError, match="max_len is required"):
        AsrEngine(params, TCFG, device="cpu")
    # The fingerprint hashes each frame's bits: bf16 through int16, the
    # same chain as the reference's bytes of the same array.
    jaudio = side["jax"][1][1]
    keys = audio_fingerprint(side["port"][1][1])
    assert len(keys) == 32 and keys == [hash(np.asarray(jaudio)[f].tobytes())
                                        for f in range(32)]


def test_launch_serve_asr_on_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "whisper-large-v3", "--asr",
                                     "--device", "cpu", "--slots", "2",
                                     "--requests", "3", "--gen", "3", "--admission",
                                     "--deadline-ms", "60000"])
    serve.main()
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "audio-cache hits" in out
    assert "calibrated: encode chunk" in out
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "granite-8b", "--asr",
                                     "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve.main()
