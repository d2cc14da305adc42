"""Port parity: ``EngineRouter`` over the diffusion engine and the LM batcher.

A mixed workload (TINY_SD images, tiny-LM requests with and without
deadlines) goes through the JAX router and the port's with the same
weights (``weights.from_reference``), the reference's noise
(``noise_fn``) and the same virtual clock: the routers advance their
engines in the same order and emit the same event log (type, rid and
every scalar payload, the cost model's estimates included), the tokens
are equal and the images within the engine's bound (corr > 0.9999,
max|d| <= 5e-2: the reference's compiled programs keep some bf16
intermediates in f32).  With cost models (seeded alike, refined online
under the clock) the routers multiplex on slack and the final tables
are equal.  Also: ``cancel`` goes to the owning engine, a rid is unique
across engines, slack outranks the raw deadline, a ``TranscribeRequest``
raises with no ASR engine, and both engines and the router satisfy the
``Engine`` protocol.
"""
import dataclasses
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.base import ModelConfig as JCfg  # noqa: E402
from repro.engine import CostModel as JCostModel  # noqa: E402
from repro.engine import DiffusionEngine as JDiff  # noqa: E402
from repro.engine import EngineRouter as JRouter  # noqa: E402
from repro.engine import GenerateRequest as JGen  # noqa: E402
from repro.engine import diffusion_engine as jde  # noqa: E402
from repro.models.transformer import init_lm as jinit_lm  # noqa: E402
from repro.serving import ContinuousBatcher as JCB  # noqa: E402
from repro.serving import Request as JReq  # noqa: E402
from repro_torch.configs import TINY_SD  # noqa: E402
from repro_torch.configs.base import ModelConfig as TCfg  # noqa: E402
from repro_torch.engine import (CostModel, DiffusionEngine, Engine,  # noqa: E402
                                EngineRouter, GenerateRequest)
from repro_torch.serving import ContinuousBatcher, Request  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


pytestmark = pytest.mark.serving

CORR, MAX_ABS = 0.9999, 5e-2
CFG_KW = dict(name="t", family="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=96,
              head_dim=32)
JCFG, TCFG = JCfg(**CFG_KW), TCfg(**CFG_KW)
LM_KW = dict(slots=2, max_len=24, block_size=4, prefill_chunk=4)
# Seeded phase costs (seconds) for the cost-model runs.
COSTS = {"fused": 0.030, "prefill": 0.004, "decode": 0.002}


def jax_noise(req, hw):
    return torch.from_numpy(np.array(jde.request_noise(req, hw)))


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


# Tie-stable prompts: at each of 6 greedy steps from _prompt(seed,
# 5 + seed % 5) the reference's lm_forward has a top-2 logit margin of at
# least 0.1 (bf16 logits: the two packages round differently, so a
# near-tie may go either way).
SEEDS = (30, 31, 37, 38, 43, 49, 61, 62, 67, 80, 85)


def _prompt(seed, n=None):
    n = 5 + seed % 5 if n is None else n
    return [int(t) for t in np.random.default_rng(seed).integers(1, 90, n)]


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
    """Jitted programs shared by this module's JAX engines (each would
    compile its own): the batcher's always (its cost model skips a
    quantum by shape), the diffusion engine's only where the test reads
    no cost model (it skips the quanta that paid its own jit trace)."""
    return {}


def _routers(weights, cost=False, jit=None, share_diffusion=False):
    """The JAX router and the port's, each with its engines on its own
    copy of the virtual clock; with ``cost`` each engine gets a cost
    model seeded with ``COSTS``."""
    out = []
    for side, (sdp, lmp) in zip(("jax", "port"), weights):
        clock = _clock()
        cm = (JCostModel if side == "jax" else CostModel)() if cost else None
        if side == "jax":
            d = JDiff(sdp, jde.TINY_SD, max_batch=2, clock=clock, cost_model=cm)
            lm = JCB(lmp, JCFG, clock=clock, cost_model=cm, **LM_KW)
            r = JRouter(diffusion=d, lm=lm)
            if jit is not None:
                for name in ("step_fn", "_prefill_raw", "_reset_fn", "_copy_fn"):
                    setattr(lm, name, jit.setdefault(name, getattr(lm, name)))
                if share_diffusion:
                    d._fns = jit.setdefault("diffusion", {})
        else:
            d = DiffusionEngine(sdp, TINY_SD, max_batch=2, clock=clock,
                                cost_model=cm, device="cpu", noise_fn=jax_noise)
            lm = ContinuousBatcher(lmp, TCFG, clock=clock, cost_model=cm,
                                   device="cpu", **LM_KW)
            r = EngineRouter(diffusion=d, lm=lm)
        if cost:
            kd = cm._diff_keys(d, (JGen if side == "jax" else GenerateRequest)(
                rid=0, tokens=_tokens(0)))
            kp, kdec = cm.lm_keys(lm)
            cm.seed(kd["fused"], COSTS["fused"])
            cm.seed(kp, COSTS["prefill"])
            cm.seed(kdec, COSTS["decode"])
        order = []
        for name, eng in (("diffusion", d), ("lm", lm)):
            inner = eng.step

            def step(_inner=inner, _name=name, _order=order):
                _order.append(_name)
                return _inner()
            eng.step = step
        out.append((r, order, cm))
    return out


# (rid, kind, deadline_ms): images are turbo requests of batch bucket 2;
# LM requests have the tie-stable prompt SEEDS[rid] and 4 new tokens.
WORKLOAD = [(0, "img", None), (1, "lm", 400.0), (2, "img", 150.0),
            (3, "lm", None), (4, "img", None), (5, "lm", 90.0),
            (6, "lm", 250.0)]


def _requests(side, workload=WORKLOAD):
    gen, req = (JGen, JReq) if side == "jax" else (GenerateRequest, Request)
    out = []
    for rid, kind, dl in workload:
        if kind == "img":
            out.append(gen(rid=rid, tokens=_tokens(rid), seed=rid,
                           deadline_ms=dl))
        else:
            out.append(req(rid=rid, prompt=_prompt(SEEDS[rid]), max_new=4,
                           deadline_ms=dl))
    return out


def _events(bus):
    def scalar(v):
        return round(v, 9) if isinstance(v, float) else v
    rows = []
    for e in bus.log:
        fields = {f.name: getattr(e, f.name) for f in dataclasses.fields(e)
                  if f.name not in ("result", "latent", "ts", "seq")}
        rows.append((type(e).__name__,) + tuple(
            (k, scalar(v)) for k, v in sorted(fields.items())))
    return rows


def _drive(router, reqs):
    for r in reqs:
        router.submit(r)
    return router.run()


def _outputs(router):
    imgs = {r.rid: np.asarray(r.image, np.float32) if not isinstance(
        r.image, torch.Tensor) else r.image.float().numpy()
        for r in router.diffusion.finished}
    toks = {r.rid: list(r.out) for r in router.lm.finished}
    return imgs, toks


@pytest.fixture(scope="module", params=[False, True], ids=["deadline", "slack"])
def served(request, weights, jit):
    cost = request.param
    (jr, jorder, jcm), (tr, torder, tcm) = _routers(weights, cost, jit,
                                                    share_diffusion=not cost)
    reqs = _requests("jax"), _requests("port")
    if cost:       # one request no engine can serve in 1 ms
        extra = [(7, "img", 1.0), (8, "lm", 1.0)]
        reqs = (reqs[0] + _requests("jax", extra),
                reqs[1] + _requests("port", extra))
    jout, tout = _drive(jr, reqs[0]), _drive(tr, reqs[1])
    return cost, (jr, jorder, jcm, jout), (tr, torder, tcm, tout)


def test_same_step_order_and_events(served):
    cost, (jr, jorder, jcm, _), (tr, torder, tcm, _) = served
    assert torder == jorder
    assert set(torder) == {"diffusion", "lm"}
    assert _events(tr.bus) == _events(jr.bus)
    if cost:
        assert [e[1] for e in _events(tr.bus) if e[0] == "Rejected"] == \
            [("budget_s", 0.001)] * 2
        assert tcm.snapshot() == pytest.approx(jcm.snapshot())
        assert {k: n for k, (_, n) in tcm.snapshot().items()} == \
            {k: n for k, (_, n) in jcm.snapshot().items()}


def test_same_tokens_and_images(served):
    _, (jr, *_), (tr, *_) = served
    jimg, jtok = _outputs(jr)
    timg, ttok = _outputs(tr)
    assert ttok == jtok and len(ttok) == 4
    assert sorted(timg) == sorted(jimg) == [0, 2, 4]
    for rid in jimg:
        a, b = jimg[rid].ravel(), timg[rid].ravel()
        assert np.corrcoef(a, b)[0, 1] > CORR and np.abs(a - b).max() <= MAX_ABS


def test_run_returns_every_finished_payload(served):
    cost, (jr, *_, jout), (tr, *_, tout) = served
    assert [r.rid for r in tout] == [r.rid for r in jout]
    assert len(tout) == 7


def test_slack_outranks_raw_deadline(weights, jit):
    """An image with the later deadline but a long estimated service goes
    first under cost models; by raw deadline the LM request goes first."""
    for cost, first in ((False, "lm"), (True, "diffusion")):
        orders = []
        for r, order, cm in _routers(weights, cost, jit, share_diffusion=True):
            side = "jax" if isinstance(r, JRouter) else "port"
            if cost:
                kd = cm._diff_keys(r.diffusion, _requests(side, [(0, "img", None)])[0])
                cm.seed(kd["fused"], 0.5)
            for q in _requests(side, [(0, "img", 700.0), (1, "lm", 600.0)]):
                r.submit(q)
            r.step()
            orders.append(order)
            assert order == [first]
        assert orders[0] == orders[1]


def test_cancel_routes_to_the_owner_and_rids_are_unique(weights):
    (_, _, _), (tr, order, _) = _routers(weights)
    tr.submit(GenerateRequest(rid=0, tokens=_tokens(0)))
    tr.submit(Request(rid=1, prompt=_prompt(1, 5), max_new=3))
    with pytest.raises(ValueError, match="duplicate rid 1 across router"):
        tr.submit(GenerateRequest(rid=1, tokens=_tokens(1)))
    with pytest.raises(ValueError, match="duplicate rid 0 across router"):
        tr.submit(Request(rid=0, prompt=_prompt(0, 5), max_new=3))
    assert tr.cancel(1) and not tr.cancel(1) and not tr.cancel(99)
    assert not tr.lm.has_work() and tr.diffusion.has_work()
    kinds = [type(e).__name__ for e in tr.bus.log]
    assert kinds == ["Cancelled"]
    done = tr.run()
    assert [r.rid for r in done] == [0] and order == ["diffusion"]


def test_transcribe_without_asr_engine_raises(weights):
    from repro_torch.engine import TranscribeRequest
    (_, _, _), (tr, _, _) = _routers(weights)
    req = TranscribeRequest(rid=3, audio=torch.zeros((32, 64)), prompt=[1])
    with pytest.raises(ValueError, match="no engine for TranscribeRequest"):
        tr.submit(req)
    with pytest.raises(ValueError, match="no engine for adopted"):
        tr.adopt(req)


def test_engine_protocol_and_bus_rebinding(weights):
    (_, _, _), (tr, _, _) = _routers(weights)
    assert isinstance(tr, Engine)
    assert isinstance(tr.diffusion, Engine) and isinstance(tr.lm, Engine)
    assert tr.diffusion.bus is tr.lm.bus is tr.bus
    assert tr.cost_model is None
    busy = ContinuousBatcher(weights[1][1], TCFG, device="cpu", **LM_KW)
    busy.submit(Request(rid=0, prompt=_prompt(0, 5), max_new=2))
    busy.step()
    with pytest.raises(ValueError, match="before emitting"):
        EngineRouter(lm=busy)
    with pytest.raises(ValueError, match="at least one engine"):
        EngineRouter()
