"""Port parity: speculative decoding and the batcher's switches.

The port's ``ContinuousBatcher`` (``device="cpu"``, plain versions of
the kernels) runs draft-model speculation with the 2-layer ``CFG`` of
``tests/test_spec_decode.py``:

* draft = target on the scan path gives exactly the plain batcher's
  tokens (the scan verify is the decode step itself);
* against ``repro.serving.ContinuousBatcher`` on the same weights
  (``weights.from_reference``), requests and virtual clock, the fused
  path gives the same tokens, events ``(type, rid, pos)``, quantum and
  launch counters and speculation counters, with a self-draft, an
  always-wrong draft, a Q8_0 pool and a smaller draft; on these
  tie-stable workloads no two top logits lie within the difference of
  the two packages' roundings (prompt seeds whose every generated token
  has a top-2 margin of at least 0.1 in the reference's ``lm_forward``);
* an always-wrong draft still gives exact tokens at acceptance 0;
  rollback across a block boundary, a CoW-shared block left
  bit-identical, preempt mid-speculation resuming bit-exact;
* ``edf=False``, ``extra_blocks`` and ``decode_fn`` against the JAX
  batcher, and kwargs against ``EngineConfig``.
"""
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JCfg  # noqa: E402
from repro.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.engine import LMEngineConfig as JLMConfig  # noqa: E402
from repro.engine import SpecDecodeConfig as JSpec  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro.serving.scheduler import make_paged_decode as jmake_decode  # noqa: E402
from repro_torch.configs.base import ModelConfig as TCfg  # noqa: E402
from repro_torch.engine import (EngineConfig, LMEngineConfig,  # noqa: E402
                                SpecDecodeConfig, build_engine)
from repro_torch.engine import events as tev  # noqa: E402
from repro_torch.engine.config import resolve  # noqa: E402
from repro_torch.serving import ContinuousBatcher as TCB  # noqa: E402
from repro_torch.serving import Request as TReq  # noqa: E402
from repro_torch.serving.scheduler import make_paged_decode  # noqa: E402
from repro_torch.engine.costmodel import CostModel  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
              head_dim=16)
DRAFT_KW = dict(CFG_KW, name="d", num_layers=1)
HD32_KW = dict(CFG_KW, head_dim=32)      # the reference's Q8_0 pool needs it
JCFG, TCFG = JCfg(**CFG_KW), TCfg(**CFG_KW)
JDCFG, TDCFG = JCfg(**DRAFT_KW), TCfg(**DRAFT_KW)
CFGS = {"target": (JCFG, TCFG), "hd32": (JCfg(**HD32_KW), TCfg(**HD32_KW))}
# Tie-stable prompt seeds (see the module docstring) at 5 prompt tokens.
SEEDS = (6, 7, 11, 14)
COUNTERS = ("prefill_quanta", "decode_quanta", "prefill_launches",
            "decode_launches", "draft_launches", "spec_rounds",
            "spec_verifies", "spec_proposed", "spec_accepted")


@pytest.fixture(scope="module")
def weights():
    jp = jinit_lm(jax.random.PRNGKey(0), JCFG)
    jd = jinit_lm(jax.random.PRNGKey(3), JDCFG)
    jh = jinit_lm(jax.random.PRNGKey(0), CFGS["hd32"][0])
    return {"target": (jp, from_reference(jp, "cpu")),
            "draft": (jd, from_reference(jd, "cpu")),
            "hd32": (jh, from_reference(jh, "cpu"))}


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 90, n)]


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _anti(inner):
    """A draft that is always wrong: (greedy + 1) mod V."""
    def step(dparams, toks, poss, tab, cache):
        nxt, cache = inner(dparams, toks, poss, tab, cache)
        return (nxt + 1) % CFG_KW["vocab_size"], cache
    return step


def _spec(weights, side, draft="self", k=3, anti=False, model="target",
          draft_fused=True):
    """The SpecDecodeConfig of one package (side 0: JAX, 1: the port);
    ``draft_fused=False`` ingests the draft's prompt by the decode-step
    scan."""
    if draft == "self":
        dparams = weights[model][side]
        jdcfg, tdcfg = CFGS[model]
    else:
        dparams, jdcfg, tdcfg = weights["draft"][side], JDCFG, TDCFG
    if side == 0:
        step = _anti(jmake_decode(jdcfg)) if anti else None
        return JSpec(draft_params=dparams, draft_cfg=jdcfg, k=k,
                     draft_step_fn=step, draft_fused_prefill=draft_fused)
    step = _anti(make_paged_decode(tdcfg)) if anti else None
    return SpecDecodeConfig(draft_params=dparams, draft_cfg=tdcfg, k=k,
                            draft_step_fn=step, draft_fused_prefill=draft_fused)


def _build(side, weights, spec=None, model="target", edf=True, **kw):
    """A batcher of one package (side 0: JAX, 1: the port) built from an
    EngineConfig: ``edf`` is a shared field, the rest the lm section."""
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 32)
    if side == 0:
        conf = JEngineConfig(clock=_clock(), edf=edf,
                             lm=JLMConfig(spec_decode=spec, **kw))
        return JCB(weights[model][0], CFGS[model][0], config=conf)
    conf = EngineConfig(clock=_clock(), edf=edf,
                        lm=LMEngineConfig(spec_decode=spec, **kw))
    return TCB(weights[model][1], CFGS[model][1], config=conf, device="cpu")


def _port(weights, spec=None, **kw):
    return _build(1, weights, spec, **kw)


def _jax(weights, spec=None, **kw):
    return _build(0, weights, spec, **kw)


def _reqs(cls, n=3, plen=5, max_new=8, seeds=SEEDS, **kw):
    return [cls(rid=i, prompt=_prompt(seeds[i], plen), max_new=max_new,
                **kw) for i in range(n)]


def _serve(cb, reqs):
    for r in reqs:
        cb.submit(r)
    cb.run()
    cb.runtime.check_consistency()
    if getattr(cb, "spec", None) is not None:
        cb.draft_runtime.check_consistency()
        assert cb.draft_runtime.allocated_blocks == 0
    return ({r.rid: list(r.out) for r in cb.finished},
            [(type(e).__name__, e.rid, getattr(e, "pos", None))
             for e in cb.bus.log],
            {c: getattr(cb, c, 0) for c in COUNTERS},
            {r.rid: (r.proposed, r.accepted) for r in cb.finished})


# ------------------------------------------------------ bit-exactness
@pytest.mark.parametrize("anti", [False, True])
def test_scan_spec_tokens_equal_plain(weights, anti):
    """Scan verify is the decode step, so the tokens are the plain
    batcher's exactly; the self-draft accepts all, the anti-draft none."""
    base = _serve(_port(weights, fused_prefill=False), _reqs(TReq))
    cb = _port(weights, _spec(weights, 1, anti=anti), fused_prefill=False)
    draft_steps = []
    inner = cb._draft_step

    def counted(*args):
        draft_steps.append(1)
        return inner(*args)
    cb._draft_step = counted
    got = _serve(cb, _reqs(TReq))
    assert got[0] == base[0]
    for prop, acc in got[3].values():
        assert prop > 0 and acc == (0 if anti else prop)
    # One host read per draft step and per verify.
    assert cb.host_reads == len(draft_steps) + cb.spec_verifies


# name: (spec args, batcher kwargs, request kwargs)
WORKLOADS = {
    "self_fused": (dict(), dict(), dict()),
    "anti_fused": (dict(anti=True), dict(slots=1), dict(n=2)),
    "q8_pool": (dict(k=2, model="hd32"),
                dict(model="hd32", quantized_kv=True, block_size=4,
                     prefill_chunk=4), dict(n=2, plen=6, seeds=(1, 6))),
    "small_draft": (dict(draft="small", k=4), dict(block_size=4),
                    dict(plen=7, seeds=(7, 12, 13))),
    "small_draft_scan_prefill": (dict(draft="small", k=4, draft_fused=False),
                                 dict(block_size=4),
                                 dict(plen=7, seeds=(7, 12, 13))),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_spec_matches_jax(weights, name):
    sp_kw, kw, rq = WORKLOADS[name]
    want = _serve(_jax(weights, _spec(weights, 0, **sp_kw), **kw),
                  _reqs(JReq, **rq))
    got = _serve(_port(weights, _spec(weights, 1, **sp_kw), **kw),
                 _reqs(TReq, **rq))
    assert got[0] == want[0]                       # token streams
    assert got[1] == want[1]                       # (type, rid, pos) events
    assert got[2] == want[2]                       # counters
    assert got[3] == want[3]                       # per-request accounting
    assert got[2]["spec_rounds"] > 0


def test_counters_reconcile_with_requests(weights):
    cb = _port(weights, _spec(weights, 1))
    hs = [cb.submit(r) for r in _reqs(TReq)]
    cb.run()
    reqs = [e.result for e in cb.bus.log if isinstance(e, tev.Finished)]
    assert sum(r.proposed for r in reqs) == cb.spec_proposed
    assert sum(r.accepted for r in reqs) == cb.spec_accepted
    assert cb.spec_accepted <= cb.spec_proposed
    assert cb.spec_tokens_per_round() > 1.0
    for h, r in zip(hs, sorted(reqs, key=lambda r: r.rid)):
        res = h.result()
        assert res.outcome == "finished"
        assert (res.stats.proposed, res.stats.accepted) == (r.proposed,
                                                            r.accepted)


# ----------------------------------------------------------- rollback
def test_rejection_across_block_boundary(weights):
    """block_size 4, k 3, an always-wrong draft: every rollback window
    straddles a block boundary; tokens stay exact."""
    kw = dict(slots=1, block_size=4, fused_prefill=False)
    base = _serve(_port(weights, **kw), _reqs(TReq, n=1, plen=6, max_new=10))
    got = _serve(_port(weights, _spec(weights, 1, anti=True), **kw),
                 _reqs(TReq, n=1, plen=6, max_new=10))
    assert got[0] == base[0]
    assert got[3][0][1] == 0


def test_shared_block_stays_pristine(weights):
    """A refcount-shared block at the speculative write position is
    copied before the verify writes, so its bytes stay as they were."""
    cb = _port(weights, _spec(weights, 1), slots=1, block_size=4)
    req = TReq(rid=0, prompt=_prompt(3, 7), max_new=6)
    cb.submit(req)
    while cb.slots[0] is None or cb._pending[0] or cb._draft_pending[0]:
        cb.step()
    rt = cb.runtime
    bi = rt.pos[0] // rt.block_size
    bid = rt.tables[0][bi]
    rt.alloc.share(bid)
    before = [p[bid].clone() for c in cb.cache for p in c if p is not None]
    cows = rt.cow_copies
    cb.step()
    assert rt.cow_copies == cows + 1 and rt.tables[0][bi] != bid
    assert rt.alloc.refcount(bid) == 1
    after = [p[bid] for c in cb.cache for p in c if p is not None]
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    cb.run()
    ref = _serve(_port(weights, slots=1, block_size=4),
                 [TReq(rid=0, prompt=_prompt(3, 7), max_new=6)])
    assert req.out == ref[0][0]


def test_preempt_mid_speculation_resumes_bit_exact(weights):
    kw = dict(slots=1, fused_prefill=False)
    expect = _serve(_port(weights, **kw),
                    [TReq(rid=0, prompt=_prompt(8, 6), max_new=10)])[0][0]
    cb = _port(weights, _spec(weights, 1), **kw)
    cb.submit(TReq(rid=0, prompt=_prompt(8, 6), max_new=10))
    while len(cb.slots[0].out if cb.slots[0] else []) < 4:
        cb.step()
    assert cb.preempt(0)
    assert cb.runtime.allocated_blocks == 0
    assert cb.draft_runtime.allocated_blocks == 0
    assert cb.run()[0].out == expect


def test_cancel_mid_speculation_frees_both_pools(weights):
    cb = _port(weights, _spec(weights, 1))
    for r in _reqs(TReq):
        cb.submit(r)
    while cb.spec_rounds == 0:
        cb.step()
    assert cb.cancel(0)
    assert cb.draft_runtime.tables[0] == [0] * cb.draft_runtime.blocks_per_slot
    cb.run()
    assert [r.rid for r in cb.finished] == [1, 2]
    assert cb.runtime.allocated_blocks == cb.draft_runtime.allocated_blocks == 0


# --------------------------------------------------------- validation
def test_spec_config_validation(weights):
    bad = TCfg(**dict(CFG_KW, vocab_size=64))
    with pytest.raises(ValueError, match="vocab"):
        _port(weights, SpecDecodeConfig(draft_params=weights["target"][1],
                                        draft_cfg=bad))
    with pytest.raises(ValueError, match="k must be"):
        _port(weights, _spec(weights, 1, k=0))
    hyb = TCfg(**dict(CFG_KW, family="hybrid", block_pattern=("attn", "mamba"),
                      ssm_state=8))
    conf = EngineConfig(lm=LMEngineConfig(
        slots=1, max_len=32, spec_decode=_spec(weights, 1)))
    with pytest.raises(ValueError, match="pure-attention"):
        TCB(weights["target"][1], hyb, config=conf, device="cpu")
    # cost_model= and metrics= reach the batcher (by kwarg or by config).
    for knob, obj in (("cost_model", CostModel()), ("metrics", Telemetry())):
        assert getattr(TCB(weights["target"][1], TCFG, max_len=8, device="cpu",
                           **{knob: obj}), knob) is obj
        assert getattr(TCB(weights["target"][1], TCFG, device="cpu",
                           config=EngineConfig(**{knob: obj}, lm=LMEngineConfig(
                               max_len=8))), knob) is obj
    with pytest.raises(TypeError, match="unknown engine kwargs"):
        resolve(None, "lm", {"max_batch": 2})


# ----------------------------------------------------------- switches
def _deadline_reqs(cls):
    """Later arrivals carry earlier deadlines: EDF and FIFO differ."""
    return [cls(rid=i, prompt=_prompt(SEEDS[i], 5), max_new=3,
                deadline_ms=1e3 * (4 - i)) for i in range(4)]


def test_edf_off_pops_in_arrival_order(weights):
    got = {}
    for edf in (True, False):
        want = _serve(_jax(weights, slots=1, edf=edf), _deadline_reqs(JReq))
        got[edf] = _serve(_port(weights, slots=1, edf=edf),
                          _deadline_reqs(TReq))
        assert got[edf][:3] == want[:3]
    done = [e[1] for e in got[False][1] if e[0] == "Finished"]
    assert done == [0, 1, 2, 3]
    assert [e[1] for e in got[True][1] if e[0] == "Finished"] != done


def test_extra_blocks_grow_the_pool(weights):
    kw = dict(slots=2, block_size=4, prefix_share=True, extra_blocks=5)
    jcb, tcb = _jax(weights, **kw), _port(weights, **kw)
    plain = _port(weights, **dict(kw, extra_blocks=0))
    assert tcb.runtime.num_blocks == jcb.runtime.num_blocks \
        == plain.runtime.num_blocks + 5
    assert _serve(tcb, _reqs(TReq, n=4)) == _serve(jcb, _reqs(JReq, n=4))


def test_decode_fn_replaces_the_decode_quantum(weights):
    """A decode_fn that shifts every greedy token by one: the port's
    tokens follow it as the reference's do."""
    want = _serve(_jax(weights, decode_fn=_anti(jmake_decode(JCFG))),
                  _reqs(JReq))
    got = _serve(_port(weights, decode_fn=_anti(make_paged_decode(TCFG))),
                 _reqs(TReq))
    assert got == want
    assert got[0] != _serve(_port(weights), _reqs(TReq))[0]


def test_kwargs_and_engine_config_build_the_same_engine(weights):
    sp = _spec(weights, 1)
    kw = dict(slots=2, max_len=32, block_size=8, prefill_chunk=4)
    conf = EngineConfig(clock=_clock(),
                        lm=LMEngineConfig(spec_decode=sp, **kw))
    by_kwargs = TCB(weights["target"][1], TCFG, device="cpu", clock=_clock(),
                    config=EngineConfig(lm=LMEngineConfig(spec_decode=sp)),
                    **kw)
    by_config = build_engine("lm", weights["target"][1], TCFG, conf,
                             device="cpu")
    assert _serve(by_kwargs, _reqs(TReq)) == _serve(by_config, _reqs(TReq))
    # Explicit kwargs win over the config.
    over = TCB(weights["target"][1], TCFG, device="cpu", slots=3,
               config=EngineConfig(lm=LMEngineConfig(slots=1, max_len=8)))
    assert len(over.slots) == 3 and over.max_len == 8
    # build_engine("asr") builds the ASR engine; a decoder-only model is
    # refused with the reference's ValueError.
    from repro_torch.configs import get_config, reduced
    from repro_torch.engine import AsrEngine, AsrEngineConfig
    from repro_torch.models.transformer import init_lm
    wcfg = reduced(get_config("whisper-large-v3"))
    aconf = EngineConfig(asr=AsrEngineConfig(max_len=8))
    asr = build_engine("asr", init_lm(torch.Generator().manual_seed(0), wcfg), wcfg,
                       aconf, device="cpu")
    assert isinstance(asr, AsrEngine) and asr.max_len == 8
    with pytest.raises(ValueError, match="encoder-decoder"):
        build_engine("asr", weights["target"][1], TCFG, aconf, device="cpu")
    with pytest.raises(ValueError, match="unknown engine kind"):
        build_engine("tts", None, TCFG)
