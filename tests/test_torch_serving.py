"""Port parity: LM serving through ``ContinuousBatcher`` at TINY sizes.

The port's batcher (``device="cpu"``, plain versions of the kernels)
and ``repro.serving.ContinuousBatcher`` get the same weights
(``weights.from_reference``), the same requests and the same virtual
clock.  On these tie-stable workloads (no two top logits within the
difference of the two packages' roundings) the token streams, the event
sequences ``(type, rid, pos)`` and the quantum/launch counters are
identical: bf16 and Q8_0 KV pools, fused and scanned prefill, prefix
sharing, several admission waves, cancellation mid-prefill and
mid-decode, and preemption with resume on the scan path.
"""
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.engine import events as tev  # noqa: E402
from repro_torch.serving import ContinuousBatcher as TCB  # noqa: E402
from repro_torch.serving import Request as TReq  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
              head_dim=32)
MODELS = {
    "tiny": (jbase.ModelConfig(**CFG_KW), tbase.ModelConfig(**CFG_KW), 0),
    "granite": (jbase.reduced(jget_config("granite-8b")),
                tbase.reduced(tget_config("granite-8b")), 1),
}


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, (jcfg, tcfg, seed) in MODELS.items():
        jp = jinit_lm(jax.random.PRNGKey(seed), jcfg)
        out[name] = (jp, from_reference(jp, "cpu"))
    return out


def _prompt(seed, n, vocab=90):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _batchers(weights, model, **kw):
    jcfg, tcfg, _ = MODELS[model]
    jp, tp = weights[model]
    return (JCB(jp, jcfg, clock=_clock(), **kw),
            TCB(tp, tcfg, clock=_clock(), device="cpu", **kw))


def _events(cb):
    return [(type(e).__name__, e.rid, getattr(e, "pos", None))
            for e in cb.bus.log]


def _state(cb):
    return ({r.rid: list(r.out) for r in cb.finished}, _events(cb),
            (cb.prefill_quanta, cb.decode_quanta, cb.prefill_launches,
             cb.decode_launches))


def _serve(cb, reqs):
    for r in reqs:
        cb.submit(r)
    cb.run()
    cb.runtime.check_consistency()
    assert cb.runtime.allocated_blocks == (len(cb.runtime.prefix)
                                           if cb.runtime.prefix else 0)
    return _state(cb)


def _reqs(cls, lens, max_new, *, shared=0):
    base = _prompt(99, shared)
    return [cls(rid=i, prompt=base + _prompt(i + 30, n), max_new=max_new)
            for i, n in enumerate(lens)]


WORKLOADS = {
    # name: (model, batcher kwargs, prompt lengths, max_new, shared prefix)
    "bf16_fused": ("tiny", dict(slots=2, max_len=24, block_size=4,
                                prefill_chunk=4), (6, 7, 9, 5), 6, 0),
    "q8_fused": ("tiny", dict(slots=2, max_len=24, block_size=4,
                              prefill_chunk=4, quantized_kv=True),
                 (6, 7, 9, 5), 6, 0),
    "bf16_scan": ("tiny", dict(slots=2, max_len=24, block_size=4,
                               prefill_chunk=4, fused_prefill=False),
                  (6, 7, 9, 5), 6, 0),
    "q8_scan": ("tiny", dict(slots=2, max_len=24, block_size=4,
                             prefill_chunk=3, quantized_kv=True,
                             fused_prefill=False), (6, 8, 5), 5, 0),
    "prefix_share": ("tiny", dict(slots=1, max_len=28, block_size=4,
                                  prefill_chunk=4, prefix_share=True),
                     (5, 3, 6), 5, 12),
    "granite_q8_prefix": ("granite", dict(slots=2, max_len=30, block_size=8,
                                          prefill_chunk=8, quantized_kv=True,
                                          prefix_share=True), (9, 4, 12), 6, 8),
    "granite_weight_q8": ("granite", dict(slots=4, max_len=20, block_size=16,
                                          weight_quant="q8_0"),
                          (7, 11, 5, 9, 6), 5, 0),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_token_streams_and_events_match(weights, name):
    model, kw, lens, max_new, shared = WORKLOADS[name]
    jcb, tcb = _batchers(weights, model, **kw)
    want = _serve(jcb, _reqs(JReq, lens, max_new, shared=shared))
    got = _serve(tcb, _reqs(TReq, lens, max_new, shared=shared))
    assert got[0] == want[0]                       # token streams
    assert got[1] == want[1]                       # (type, rid, pos) events
    assert got[2] == want[2]                       # quanta and launches
    assert len(got[0]) == len(lens)
    if kw.get("prefix_share"):
        assert tcb.runtime.prefix.hits == jcb.runtime.prefix.hits > 0


def _drive_with_interrupts(cb, req_cls, script):
    """Submit four requests, then step; ``script`` maps a step index to
    ('cancel' | 'preempt', rid)."""
    for i, n in enumerate((9, 6, 10, 4)):
        cb.submit(req_cls(rid=i, prompt=_prompt(40 + i, n), max_new=6))
    for step in range(200):
        if step in script:
            op, rid = script[step]
            assert getattr(cb, op)(rid)
        if not cb.has_work():
            break
        cb.step()
    cb.runtime.check_consistency()
    return _state(cb)


@pytest.mark.parametrize("fused", [True, False])
def test_cancel_mid_prefill_and_mid_decode(weights, fused):
    # Step 1 is rid 0's second prefill chunk; by step 8 rid 1 decodes.
    script = {1: ("cancel", 0), 8: ("cancel", 1)}
    kw = dict(slots=2, max_len=20, block_size=4, prefill_chunk=4,
              fused_prefill=fused)
    jcb, tcb = _batchers(weights, "tiny", **kw)
    want = _drive_with_interrupts(jcb, JReq, script)
    got = _drive_with_interrupts(tcb, TReq, script)
    assert got == want
    assert [e for e in tcb.bus.log if isinstance(e, tev.Cancelled)]
    assert sorted(got[0]) == [2, 3]
    assert tcb.runtime.allocated_blocks == 0


def test_preempt_resume_on_the_scan_path(weights):
    """A preempted request re-ingests prompt + generated tokens and ends
    with the tokens of an uninterrupted run (scan path: bit-exact)."""
    kw = dict(slots=2, max_len=20, block_size=4, prefill_chunk=4,
              fused_prefill=False)
    script = {9: ("preempt", 1)}
    jcb, tcb = _batchers(weights, "tiny", **kw)
    want = _drive_with_interrupts(jcb, JReq, script)
    got = _drive_with_interrupts(tcb, TReq, script)
    assert got == want
    assert tcb.preemptions == 1
    assert any(e[0] == "Preempted" for e in got[1])
    plain = TCB(weights["tiny"][1], MODELS["tiny"][1], device="cpu", **kw)
    assert _drive_with_interrupts(plain, TReq, {})[0] == got[0]


def test_stream_and_handles(weights):
    """``stream()`` yields the bus's events in order; a handle resolves to
    the request once it finishes."""
    tcb = TCB(weights["tiny"][1], MODELS["tiny"][1], slots=2, max_len=16,
              block_size=4, device="cpu", clock=_clock())
    h = tcb.submit(TReq(rid=7, prompt=_prompt(1, 5), max_new=4))
    tcb.submit(TReq(rid=8, prompt=_prompt(2, 3), max_new=3))
    seen = list(tcb.stream())
    assert seen == tcb.bus.log
    assert h.done and h.result().rid == 7 and len(h.result().tokens) == 4
    pos = [e.pos for e in seen if isinstance(e, tev.TokenDelta) and e.rid == 7]
    assert pos == sorted(pos) == list(range(4))


def test_round_robin_groups_and_edf(weights):
    tcb = TCB(weights["tiny"][1], MODELS["tiny"][1], slots=1, max_len=8,
              device="cpu", clock=_clock())
    for rid, group, deadline in ((0, 0, None), (1, 0, None), (2, 0, 50.0),
                                 (3, 1, None), (4, 1, None)):
        tcb.submit(TReq(rid=rid, prompt=_prompt(rid, 3), max_new=2,
                        group=group, deadline_ms=deadline))
    done = [r.rid for r in tcb.run()]
    # Groups alternate; within group 0 the deadline-carrying request
    # jumps ahead of the FIFO ones.
    assert done == [2, 3, 0, 4, 1]


def test_submit_validation_and_sizing(weights):
    tcb = TCB(weights["tiny"][1], MODELS["tiny"][1], slots=1, max_len=16,
              device="cpu")
    assert TCB.required_len(100, 2, 8, 4) == 11
    with pytest.raises(ValueError, match="capacity"):
        tcb.submit(TReq(rid=0, prompt=_prompt(0, 15), max_new=16))
    tcb.submit(TReq(rid=1, prompt=_prompt(1, 13), max_new=4))
    with pytest.raises(ValueError, match="duplicate"):
        tcb.submit(TReq(rid=1, prompt=_prompt(1, 3), max_new=1))
    (req,) = tcb.run()
    assert len(req.out) == 4 and req.done
    with pytest.raises(ValueError, match="max_len"):
        TCB(weights["tiny"][1], MODELS["tiny"][1], device="cpu")


def test_defaults_and_device(weights):
    tcb = TCB(weights["tiny"][1], MODELS["tiny"][1], max_len=8, device="cpu")
    assert (len(tcb.slots), tcb.runtime.block_size, tcb.prefill_chunk,
            tcb.fused_prefill) == (4, 16, 8, True)
    assert all(p.device.type == "cpu" for c in tcb.cache for p in c
               if p is not None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TCB(weights["tiny"][1], MODELS["tiny"][1], max_len=8)


def test_copy_on_write_copies_every_pool(weights):
    """The CoW hook copies quants and scales of a block in place."""
    tcb = TCB(weights["tiny"][1], MODELS["tiny"][1], slots=1, max_len=8,
              block_size=4, quantized_kv=True, device="cpu")
    for c in tcb.cache:
        for p in c:
            p[2] = 3
    tcb._copy_block(2, 1)
    assert all(torch.equal(p[1], p[2]) for c in tcb.cache for p in c)
