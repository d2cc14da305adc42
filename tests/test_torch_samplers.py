"""Port parity: ddim / euler samplers, classifier-free guidance, the
step plans, the engine's event stream and ``pipeline.generate``.

Images use the bounds of ``tests/test_torch_engine.py`` (same reason).
With guidance the bound is corr > 0.999 and max|d| <= 0.1: CFG at scale
3 multiplies the difference of two UNet passes by 3, and with it the
bf16-rounding disagreement between the reference's compiled program and
the port.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.diffusion import pipeline as jpipe  # noqa: E402
from repro.diffusion import schedule as jsched  # noqa: E402
from repro.engine import DiffusionEngine as JEngine  # noqa: E402
from repro.engine import GenerateRequest as JRequest  # noqa: E402
from repro.engine import diffusion_engine as jde  # noqa: E402
from repro.engine import samplers as jsamp  # noqa: E402
from repro_torch.configs import TINY_SD  # noqa: E402
from repro_torch.diffusion import pipeline as tpipe  # noqa: E402
from repro_torch.diffusion import schedule as tsched  # noqa: E402
from repro_torch.engine import DiffusionEngine as TEngine  # noqa: E402
from repro_torch.engine import GenerateRequest as TRequest  # noqa: E402
from repro_torch.engine import events as tev  # noqa: E402
from repro_torch.engine import samplers as tsamp  # noqa: E402
from repro_torch.engine import steps_bucket  # noqa: E402
from repro_torch.weights import from_reference  # noqa: E402
from test_torch_engine import (_tokens, assert_images_close,  # noqa: E402
                               jax_noise, run_pair)
from test_torch_api import _one_torch_thread  # noqa: E402,F401  (autouse)


@pytest.fixture(scope="module")
def params():
    jp = jde.init_pipeline(jax.random.PRNGKey(0), jde.TINY_SD)
    return jp, from_reference(jp, "cpu")


def test_schedule_matches():
    js, ts = jsched.NoiseSchedule(), tsched.NoiseSchedule()
    np.testing.assert_allclose(ts.alphas_cumprod().numpy(),
                               np.asarray(js.alphas_cumprod()), rtol=2e-6)
    for n in (1, 3, 50):
        np.testing.assert_array_equal(tsched.ddim_timesteps(n).numpy(),
                                      np.asarray(jsched.ddim_timesteps(n)))
        np.testing.assert_array_equal(
            tsched.euler_timestep_indices(ts, n).numpy(),
            np.asarray(jsched.euler_timestep_indices(js, n)))
        np.testing.assert_allclose(tsched.euler_sigmas(ts, n).numpy(),
                                   np.asarray(jsched.euler_sigmas(js, n)),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["ddim", "euler", "turbo"])
@pytest.mark.parametrize("steps", [1, 3, 5])
def test_plans_and_steps_match(name, steps):
    js, ts = jsched.NoiseSchedule(), tsched.NoiseSchedule()
    padded = steps_bucket(steps)
    assert padded == jde.steps_bucket(steps)
    jplan = jsamp.get_sampler(name).plan(js, steps, padded)
    tplan = tsamp.get_sampler(name).plan(ts, steps, padded)
    assert sorted(jplan) == sorted(tplan)
    for k in jplan:
        np.testing.assert_allclose(tplan[k].numpy(), np.asarray(jplan[k]),
                                   rtol=1e-5)
    x = np.random.default_rng(0).standard_normal((2, 4, 4, 4)).astype(np.float32)
    eps = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    jsm, tsm = jsamp.get_sampler(name), tsamp.get_sampler(name)
    jx = jsm.init_latent(jnp.asarray(x), jplan)
    tx = tsm.init_latent(torch.from_numpy(x), tplan)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    jstep = {k: v[0] for k, v in jplan.items()}
    tstep = {k: v[0] for k, v in tplan.items()}
    np.testing.assert_allclose(
        tsm.update(ts, tx, torch.from_numpy(eps), tstep).numpy(),
        np.asarray(jsm.update(js, jx, jnp.asarray(eps), jstep)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampler,guidance", [("ddim", 1.0), ("ddim", 3.0),
                                              ("euler", 1.0)])
def test_two_step_images_match(params, sampler, guidance):
    toks = _tokens(2, seed=3)
    specs = [dict(rid=i, tokens=toks[i], seed=20 + i, sampler=sampler,
                  steps=2, guidance_scale=guidance) for i in range(2)]
    if guidance != 1.0:
        specs[1]["neg_tokens"] = toks[0]
    jimg, timg = run_pair(params, specs)
    if guidance == 1.0:
        assert_images_close(jimg, timg)
    else:
        assert_images_close(jimg, timg, corr=0.999, max_abs=0.1)


def test_generate_matches_with_injected_noise(params, monkeypatch):
    """``pipeline.generate`` (single shot, default sampler) against the
    reference with the same bf16 noise draw."""
    jp, tp = params
    toks = np.asarray(_tokens(2, seed=4))
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (2, 8, 8, 4), jnp.bfloat16),
                       np.float32)
    want = np.asarray(jpipe.generate(jp, jde.TINY_SD, jnp.asarray(toks), key),
                      np.float32)
    monkeypatch.setattr(torch, "randn",
                        lambda *a, **k: torch.from_numpy(noise.copy()))
    got = tpipe.generate(tp, TINY_SD, toks, 7, device="cpu")
    monkeypatch.undo()
    assert_images_close({0: want}, {0: got.float().numpy()})


def test_event_sequence_matches(params):
    """Same request stream, one queued request cancelled: the (type, rid)
    sequences of the two engines are identical."""
    jp, tp = params
    toks = _tokens(4, seed=1)
    specs = [dict(rid=10, tokens=toks[0], seed=1),
             dict(rid=11, tokens=toks[1], seed=2, deadline_ms=1e6),
             dict(rid=12, tokens=toks[2], seed=3, sampler="ddim", steps=2),
             dict(rid=13, tokens=toks[3], seed=4, priority=5)]
    clock = iter(range(10_000))
    je = JEngine(jp, jde.TINY_SD, max_batch=2, clock=lambda: next(clock))
    tclock = iter(range(10_000))
    te = TEngine(tp, TINY_SD, max_batch=2, device="cpu", noise_fn=jax_noise,
                 clock=lambda: next(tclock))
    for eng, req_cls in ((je, JRequest), (te, TRequest)):
        for spec in specs:
            eng.submit(req_cls(**spec))
        assert eng.cancel(12)
        assert not eng.cancel(99)
        eng.run()
    seq_j = [(type(e).__name__, e.rid) for e in je.bus.log]
    seq_t = [(type(e).__name__, e.rid) for e in te.bus.log]
    assert seq_t == seq_j
    assert ("Cancelled", 12) in seq_t
    fin = [e for e in te.bus.log if isinstance(e, tev.Finished)]
    assert sorted(e.rid for e in fin) == [10, 11, 13]
    assert te.handle(10).result().finished
