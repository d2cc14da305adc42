"""Port parity: the diffusion engine's segmented preview path at TINY_SD.

* The port's segmented images, its latent and decoded previews and its
  event sequence against the JAX engine's *segmented* path (never its
  fused scan: the two disagree in the reference itself), with the same
  weights (``weights.from_reference``) and the reference's noise fed
  through ``noise_fn``.  Images and decoded previews: corr > 0.9999 and
  max|d| <= 5e-2, the bound of ``tests/test_torch_engine.py`` (the
  reference's compiled programs keep some bf16 intermediates in f32).
* The port's segmented images equal its fused images bit for bit: both
  run ``build_denoise_step`` for every valid step.
* Cadence, group keys, cancel while queued and mid-denoise, and a fully
  cancelled batch that must not stall a handle.
"""
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.engine import DiffusionEngine as JEngine  # noqa: E402
from repro.engine import GenerateRequest as JRequest  # noqa: E402
from repro.engine import diffusion_engine as jde  # noqa: E402
from repro_torch.configs import TINY_SD  # noqa: E402
from repro_torch.engine import (Cancelled, DiffusionEngine,  # noqa: E402
                                DiffusionEngineConfig, EngineConfig,
                                Finished, GenerateRequest, PreviewLatent,
                                Progress, build_engine)
from repro_torch.engine import diffusion_engine as tde  # noqa: E402
from repro_torch.engine.costmodel import CostModel  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


CORR, MAX_ABS = 0.9999, 5e-2
# Two ddim rows co-batched, one euler row with pixel previews.
SPECS = [dict(rid=0, sampler="ddim", steps=3, seed=5, preview_every=1),
         dict(rid=1, sampler="ddim", steps=3, seed=6, preview_every=1),
         dict(rid=2, sampler="euler", steps=2, seed=7, preview_every=1,
              preview_decode=True)]


def jax_noise(req, hw):
    return torch.from_numpy(np.array(jde.request_noise(req, hw)))


def _clock():
    ticks = itertools.count()
    return lambda: next(ticks) * 1e-3


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (n, 77)).tolist()


TOKS = _tokens(3)


@pytest.fixture(scope="module")
def params():
    jp = jde.init_pipeline(jax.random.PRNGKey(0), jde.TINY_SD)
    return jp, from_reference(jp, "cpu")


def _port(params, max_batch=2):
    return DiffusionEngine(params[1], TINY_SD, max_batch=max_batch,
                           device="cpu", noise_fn=jax_noise, clock=_clock())


def _events(eng):
    return [(type(e).__name__, e.rid, getattr(e, "step", None),
             getattr(e, "total", None), getattr(e, "decoded", None),
             getattr(e, "phase", None)) for e in eng.bus.log]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _payloads(eng):
    """{(rid, step): preview payload} and {rid: image} as float32 numpy."""
    pv = {(e.rid, e.step): _np(e.latent) for e in eng.bus.log
          if type(e).__name__ == "PreviewLatent"}
    return pv, {r.rid: _np(r.image) for r in eng.finished}


@pytest.fixture(scope="module")
def pair(params):
    """The same segmented workload through both engines."""
    je = JEngine(params[0], jde.TINY_SD, max_batch=2, clock=_clock())
    te = _port(params)
    for spec in SPECS:
        je.submit(JRequest(tokens=TOKS[spec["rid"]], **spec))
        te.submit(GenerateRequest(tokens=TOKS[spec["rid"]], **spec))
    je.run()
    te.run()
    return je, te


def _close(a, b):
    assert a.shape == b.shape
    c = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    d = np.abs(a - b).max()
    return c, d


def test_segmented_images_match_jax_segmented(pair):
    je, te = pair
    jimg, timg = _payloads(je)[1], _payloads(te)[1]
    assert sorted(timg) == [0, 1, 2]
    for rid in jimg:
        c, d = _close(jimg[rid], timg[rid])
        assert c > CORR and d <= MAX_ABS, (rid, c, d)


def test_previews_match_jax(pair):
    """Decoded previews at the image bound; x0 latent previews at the
    correlation bound (their scale is the latent's, not [-1, 1])."""
    je, te = pair
    jpv, tpv = _payloads(je)[0], _payloads(te)[0]
    assert sorted(jpv) == sorted(tpv)
    for key in jpv:
        c, d = _close(jpv[key], tpv[key])
        assert c > CORR, (key, c, d)
        if key[0] == 2:                          # preview_decode rows
            assert tpv[key].shape == (16, 16, 3) and d <= MAX_ABS, (key, d)
        else:
            assert tpv[key].shape == (8, 8, 4)


def test_event_sequence_matches_jax(pair):
    je, te = pair
    assert _events(te) == _events(je)
    kinds = [e[0] for e in _events(te) if e[1] == 2]
    assert kinds == ["Admitted", "Progress", "PreviewLatent", "Progress",
                     "PreviewLatent", "Finished"]


@pytest.mark.parametrize("steps", [4, 3])
def test_segmented_equals_fused_bit_for_bit(params, steps):
    """At 3 steps the fused plan is padded to its bucket of 4 and the
    segmented plan is not; the valid steps agree, so do the images."""
    imgs = {}
    for every in (0, 2):
        eng = _port(params)
        for rid in (0, 1):
            eng.submit(GenerateRequest(rid=rid, tokens=TOKS[rid],
                                       sampler="ddim", steps=steps,
                                       seed=rid, preview_every=every,
                                       guidance_scale=2.0 if rid else 1.0))
        imgs[every] = {r.rid: r.image for r in eng.run()}
    for rid in (0, 1):
        assert torch.equal(imgs[0][rid], imgs[2][rid])


def test_preview_cadence_and_final_step(params):
    eng = _port(params, max_batch=1)
    h = eng.submit(GenerateRequest(rid=0, tokens=TOKS[0], sampler="ddim",
                                   steps=5, seed=1, preview_every=2))
    evs = list(h.events())
    assert [e.step for e in evs if isinstance(e, PreviewLatent)] == [2, 4, 5]
    assert [e.step for e in evs if isinstance(e, Progress)] == [1, 2, 3, 4, 5]
    assert all(e.phase == "denoise" for e in evs if isinstance(e, Progress))


def test_preview_requests_never_cobatch_with_plain(params):
    eng = _port(params)
    eng.submit(GenerateRequest(rid=0, tokens=TOKS[0], sampler="ddim",
                               steps=2, seed=1))
    eng.submit(GenerateRequest(rid=1, tokens=TOKS[1], sampler="ddim",
                               steps=2, seed=2, preview_every=1))
    assert eng.step() == 1                  # the plain batch runs alone
    assert not any(isinstance(e, PreviewLatent) for e in eng.bus.log)
    assert sorted(r.rid for r in eng.run()) == [0, 1]
    assert any(isinstance(e, PreviewLatent) for e in eng.bus.log)


def test_cancel_queued_and_mid_denoise(params):
    eng = _port(params, max_batch=1)
    eng.submit(GenerateRequest(rid=0, tokens=TOKS[0], sampler="ddim",
                               steps=3, seed=1, preview_every=1))
    h1 = eng.submit(GenerateRequest(rid=1, tokens=TOKS[1], sampler="ddim",
                                    steps=3, seed=2))
    assert h1.cancel() and h1.state == "CANCELLED"
    eng.step()                              # admit rid 0, first step
    assert eng.cancel(0)
    assert not eng.cancel(0)                # already cancelled
    assert eng.run() == [] and not eng.has_work()
    for rid in (0, 1):
        assert isinstance([e for e in eng.bus.log if e.rid == rid][-1],
                          Cancelled)
    assert not eng.cancel(7)


def test_cancelled_row_keeps_its_batch_and_the_survivor_its_bits(params):
    """A row cancelled mid-denoise keeps computing; its batch-mate ends
    with the image a fused run of the same two requests gives."""
    reqs = [dict(rid=r, tokens=TOKS[r], sampler="euler", steps=4, seed=r)
            for r in (0, 1)]
    fused = _port(params)
    for spec in reqs:
        fused.submit(GenerateRequest(**spec))
    want = {r.rid: r.image for r in fused.run()}
    eng = _port(params)
    for spec in reqs:
        eng.submit(GenerateRequest(preview_every=2, preview_decode=True,
                                   **spec))
    eng.step()
    assert eng.cancel(1)
    (res,) = eng.run()
    assert res.rid == 0 and torch.equal(res.image, want[0])
    assert not any(isinstance(e, (Progress, PreviewLatent, Finished))
                   and e.rid == 1 and e.seq > eng.bus.terminal(1).seq
                   for e in eng.bus.log)


def test_last_decoded_preview_and_the_image_share_one_vae_pass(params,
                                                               monkeypatch):
    """Decoded previews at steps 2 and 3 of 3: the last one is the image,
    so the VAE runs twice in all, not three times."""
    calls = []
    inner = tde.build_finalize_decode

    def counted(cfg, sampler_name):
        fn = inner(cfg, sampler_name)

        def run(p, x):
            calls.append(1)
            return fn(p, x)
        return run
    monkeypatch.setattr(tde, "build_finalize_decode", counted)
    eng = _port(params, max_batch=1)
    h = eng.submit(GenerateRequest(rid=0, tokens=TOKS[0], sampler="euler",
                                   steps=3, seed=4, preview_every=2,
                                   preview_decode=True))
    image = h.result().image
    pv = [e for e in eng.bus.log if isinstance(e, PreviewLatent)]
    assert [(e.step, e.decoded) for e in pv] == [(2, True), (3, True)]
    assert torch.equal(pv[-1].latent, image)
    assert len(calls) == 2


def test_handle_survives_zero_progress_quantum(params):
    eng = _port(params, max_batch=1)
    eng.submit(GenerateRequest(rid=0, tokens=TOKS[0], sampler="ddim",
                               steps=3, seed=1, preview_every=1))
    eng.step()
    assert eng.cancel(0)
    h = eng.submit(GenerateRequest(rid=1, tokens=TOKS[1], sampler="turbo",
                                   steps=1, seed=2))
    assert eng.step() == 0                  # clears the dead batch
    assert h.result().outcome == "finished" and h.state == "FINISHED"


def test_engine_config_builds_the_same_engine(params):
    def run(eng):
        h = eng.submit(GenerateRequest(rid=0, tokens=TOKS[0], sampler="ddim",
                                       steps=2, seed=3, preview_every=1))
        return h.result().image, _events(eng)

    conf = EngineConfig(clock=_clock(),
                        diffusion=DiffusionEngineConfig(max_batch=2))
    a = run(_port(params))
    b = run(build_engine("diffusion", params[1], TINY_SD, conf, device="cpu",
                         noise_fn=jax_noise))
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    # cost_model= and metrics= reach the engine by kwarg or by config.
    for knob, obj in (("cost_model", CostModel()), ("metrics", Telemetry())):
        assert getattr(DiffusionEngine(params[1], TINY_SD, device="cpu",
                                       **{knob: obj}), knob) is obj
        assert getattr(build_engine("diffusion", params[1], TINY_SD,
                                    EngineConfig(**{knob: obj}),
                                    device="cpu"), knob) is obj
