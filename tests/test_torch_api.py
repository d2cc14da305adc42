"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback.

* Importing ``repro_torch`` and driving its engines (the ASR engine and
  the audio frontend too), the router, a fleet with a cost model and
  telemetry, and ``launch/serve.py`` (``--asr`` too) leaves ``jax`` and
  ``repro`` out of ``sys.modules`` (checked in a fresh interpreter).
* Without a cost model and metrics the engines never synchronise the
  device; the observation sync is ``torch.cuda.synchronize`` on a card.
* No file of the package, and not ``chip_smoke.py``, imports ``jax`` or
  any ``repro`` module.
* Asking for the card without one raises; it never runs on the CPU.
"""
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from repro_torch.configs import TINY_SD  # noqa: E402
from repro_torch.engine import (DiffusionEngine, GenerateRequest,  # noqa: E402
                                init_pipeline)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite's six xdist
    workers share eight cores, and torch's default pool of one thread per
    core oversubscribes them (six port test files took 469 s on six
    workers with the default pool, 218 s with one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro|ml_dtypes)\b(?!_torch)"
    r"|from\s+(jax|repro|ml_dtypes)(\.|\s)(?!_torch))",
    re.M)


def test_no_port_file_imports_jax_or_repro():
    assert len(PORT_FILES) > 20
    bad = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
           for p in PORT_FILES for m in FORBIDDEN.finditer(p.read_text())]
    assert not bad, bad


def test_import_and_engine_leave_jax_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.engine, repro_torch.weights\n"
        "import repro_torch.diffusion.pipeline\n"
        "from repro_torch.configs import TINY_SD\n"
        "from repro_torch.engine import DiffusionEngine, GenerateRequest, "
        "init_pipeline\n"
        "eng = DiffusionEngine(init_pipeline(0, TINY_SD, device='cpu'), "
        "TINY_SD, device='cpu', weight_quant='q8_0')\n"
        "eng.submit(GenerateRequest(rid=0, tokens=[1] * 77))\n"
        "assert len(eng.run()) == 1\n"
        "import repro_torch.serving, repro_torch.models.transformer as T\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.serving import ContinuousBatcher, Request\n"
        "cfg = reduced(get_config('granite-8b'))\n"
        "import torch\n"
        "p = T.init_lm(torch.Generator().manual_seed(0), cfg)\n"
        "for kw in ({}, {'quantized_kv': True, 'fused_prefill': False}):\n"
        "    cb = ContinuousBatcher(p, cfg, max_len=12, device='cpu', "
        "prefix_share=True, **kw)\n"
        "    cb.submit(Request(rid=0, prompt=[3] * 9, max_new=3))\n"
        "    assert len(cb.run()[0].out) == 3\n"
        "from repro_torch.core.policy import get_policy\n"
        "from repro_torch.core.qlinear import quantize_params\n"
        "from repro_torch.train.serve_step import greedy_generate\n"
        "q4 = quantize_params(p, get_policy('q4_0'))\n"
        "assert greedy_generate(q4, cfg, [[3] * 4], 2, device='cpu').shape == (1, 6)\n"
        "import repro_torch.obs, repro_torch.distributed.fault_tolerance\n"
        "import repro_torch.engine.router, repro_torch.engine.fleet\n"
        "import repro_torch.engine.costmodel, repro_torch.launch.serve as S\n"
        "from repro_torch.engine import (CostModel, EngineConfig, FleetManager,\n"
        "    LMEngineConfig, ReplicaSpec, EngineRouter, FaultInjector)\n"
        "from repro_torch.obs import Telemetry, TraceRecorder\n"
        "tele = Telemetry(tracer=TraceRecorder())\n"
        "conf = EngineConfig(cost_model=CostModel(), metrics=tele,\n"
        "    lm=LMEngineConfig(slots=2, max_len=12))\n"
        "fleet = FleetManager([ReplicaSpec(n, params=p, model_cfg=cfg, config=conf,\n"
        "    device='cpu') for n in 'ab'], injector=FaultInjector().kill('a', 1),\n"
        "    watchdog_threshold=1e9)\n"
        "tele.attach(fleet.bus)\n"
        "for i in range(3):\n"
        "    fleet.submit(Request(rid=i, prompt=[3 + i] * 6, max_new=3))\n"
        "assert len(fleet.run()) == 3 and fleet.stats()['migrations']\n"
        "assert 'phase_seconds' in tele.registry.to_prometheus()\n"
        "sys.argv = ['serve', '--arch', 'granite-8b', '--device', 'cpu',\n"
        "    '--slots', '2', '--requests', '2', '--gen', '2', '--admission',\n"
        "    '--replicas', '2', '--deadline-ms', '60000']\n"
        "S.main()\n"
        "import repro_torch.engine.asr_engine, repro_torch.models.frontend as F\n"
        "from repro_torch.engine import AsrEngine, TranscribeRequest\n"
        "wcfg = reduced(get_config('whisper-large-v3'))\n"
        "wp = T.init_lm(torch.Generator().manual_seed(0), wcfg)\n"
        "asr = AsrEngine(wp, wcfg, slots=2, max_len=8, audio_chunk=32, device='cpu')\n"
        "a = F.synthetic_audio(torch.Generator().manual_seed(1), wcfg)\n"
        "for i in range(3):\n"
        "    asr.submit(TranscribeRequest(rid=i, audio=a, prompt=[1, 2], max_new=3))\n"
        "assert len(asr.run()) == 3 and asr.audio_hits == 1\n"
        "sys.argv = ['serve', '--arch', 'whisper-large-v3', '--asr', '--device', 'cpu',\n"
        "    '--slots', '2', '--requests', '3', '--gen', '2']\n"
        "S.main()\n"
        "import repro_torch.models.ssm\n"
        "for arch in ('xlstm-1.3b', 'jamba-1.5-large-398b'):\n"
        "    sys.argv = ['serve', '--arch', arch, '--device', 'cpu',\n"
        "        '--slots', '2', '--requests', '3', '--gen', '2']\n"
        "    S.main()\n"
        "import tempfile\n"
        "import repro_torch.launch.train as LT, repro_torch.checkpoint.ckpt\n"
        "import repro_torch.optim.adamw, repro_torch.optim.compression\n"
        "import repro_torch.data.pipeline, repro_torch.train.train_step\n"
        "vcfg = reduced(get_config('qwen2-vl-72b'))\n"
        "vp = T.init_lm(torch.Generator().manual_seed(0), vcfg)\n"
        "pre = F.synthetic_frontend(torch.Generator().manual_seed(2), (1, 8, vcfg.d_model))\n"
        "assert T.lm_forward(vp, vcfg, torch.tensor([[3] * 4]), prefix_embeds=pre)[0]"
        ".shape == (1, 4, vcfg.vocab_size)\n"
        "assert greedy_generate(vp, vcfg, [[3] * 4], 2, device='cpu').shape == (1, 6)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    LT.main(['--arch', 'qwen2-vl-72b', '--device', 'cpu', '--steps', '2',\n"
        "             '--batch', '1', '--seq', '8', '--ckpt-every', '1', '--ckpt-dir', d])\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', 'ml_dtypes') or "
        "m.startswith(('jax.', 'repro.', 'ml_dtypes.')))\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}          # as _one_torch_thread
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card error")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_pipeline(0, TINY_SD, device="cuda")
    params = init_pipeline(0, TINY_SD, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffusionEngine(params, TINY_SD)          # device defaults to cuda


def test_engine_validates_requests():
    eng = DiffusionEngine(init_pipeline(0, TINY_SD, device="cpu"), TINY_SD,
                          device="cpu")
    with pytest.raises(KeyError):
        eng.submit(GenerateRequest(rid=0, tokens=[0] * 77, sampler="nope"))
    with pytest.raises(ValueError):
        eng.submit(GenerateRequest(rid=0, tokens=[0] * 77, steps=0))
    with pytest.raises(ValueError):
        eng.submit(GenerateRequest(rid=0, tokens=[0] * 77, latent_hw=3))
    with pytest.raises(ValueError):
        eng.submit(GenerateRequest(rid=0, tokens=[0] * 77, preview_every=-1))
    eng.submit(GenerateRequest(rid=1, tokens=[0] * 77, preview_every=1))
    eng.submit(GenerateRequest(rid=0, tokens=[0] * 77))
    with pytest.raises(ValueError):
        eng.submit(GenerateRequest(rid=0, tokens=[0] * 77))
    with pytest.raises(KeyError):
        DiffusionEngine({}, TINY_SD, device="cpu", weight_quant="q9_9")


def test_default_noise_is_seeded_and_batch_transparent():
    """A request's image depends on its seed only, alone or co-batched."""
    params = init_pipeline(0, TINY_SD, device="cpu")
    alone = DiffusionEngine(params, TINY_SD, device="cpu", max_batch=1)
    alone.submit(GenerateRequest(rid=0, tokens=[5] * 77, seed=3))
    both = DiffusionEngine(params, TINY_SD, device="cpu", max_batch=2)
    both.submit(GenerateRequest(rid=0, tokens=[5] * 77, seed=3))
    both.submit(GenerateRequest(rid=1, tokens=[6] * 77, seed=4))
    a = alone.run()[0].image
    b = {r.rid: r.image for r in both.run()}
    assert torch.equal(a, b[0]) and not torch.equal(b[0], b[1])


def test_modules_run_the_functions():
    """``CLIPTextEncoder``/``UNet``/``VAEDecoder`` are the module faces of
    ``clip_encode``/``apply_unet``/``apply_vae_decoder``."""
    from repro_torch.models import clip, unet, vae
    p = init_pipeline(1, TINY_SD, device="cpu")
    toks = torch.randint(0, 512, (2, 77), generator=torch.Generator().manual_seed(0))
    ctx = clip.CLIPTextEncoder(p["clip"], TINY_SD.clip_cfg())(toks)
    assert torch.equal(ctx, clip.clip_encode(p["clip"], TINY_SD.clip_cfg(), toks))
    x = torch.randn(2, 8, 8, 4).to(torch.bfloat16)
    t = torch.tensor([999, 1])
    eps = unet.UNet(p["unet"], TINY_SD.unet)(x, t, ctx)
    assert torch.equal(eps, unet.apply_unet(p["unet"], TINY_SD.unet, x, t, ctx))
    img = vae.VAEDecoder(p["vae"], TINY_SD.vae)(eps)
    assert torch.equal(img, vae.apply_vae_decoder(p["vae"], TINY_SD.vae, eps))
    assert img.shape == (2, 16, 16, 3)


def test_engines_add_no_device_sync_without_cost_model_or_metrics(monkeypatch):
    """``torch.cuda.synchronize`` patched with a counter: a router over
    the three engines and a fleet, run with ``cost_model=None,
    metrics=None``, never call it; the engines' observation sync calls it
    on a CUDA device and not on the CPU."""
    import repro_torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.engine import (AsrEngine, EngineRouter, FleetManager,
                                    ReplicaSpec, TranscribeRequest)
    from repro_torch.models.frontend import synthetic_audio
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving import ContinuousBatcher, Request
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    cfg = reduced(get_config("granite-8b"))
    lm = init_lm(torch.Generator().manual_seed(0), cfg)
    sd = init_pipeline(0, TINY_SD, device="cpu")
    wcfg = reduced(get_config("whisper-large-v3"))
    wp = init_lm(torch.Generator().manual_seed(0), wcfg)
    router = EngineRouter(
        diffusion=DiffusionEngine(sd, TINY_SD, device="cpu", max_batch=2),
        lm=ContinuousBatcher(lm, cfg, max_len=16, device="cpu"),
        asr=AsrEngine(wp, wcfg, slots=1, max_len=8, audio_chunk=24, device="cpu"))
    router.submit(GenerateRequest(rid=0, tokens=[1] * 77))
    router.submit(GenerateRequest(rid=1, tokens=[2] * 77, sampler="euler",
                                  steps=2, preview_every=1, preview_decode=True))
    router.submit(Request(rid=2, prompt=[3] * 9, max_new=3))
    audio = synthetic_audio(torch.Generator().manual_seed(1), wcfg)
    for rid in (3, 4):
        router.submit(TranscribeRequest(rid=rid, audio=audio, prompt=[1, 2],
                                        max_new=3))
    assert len(router.run()) == 5 and router.asr.audio_hits == 1
    fleet = FleetManager([ReplicaSpec(n, lambda: ContinuousBatcher(
        lm, cfg, max_len=16, device="cpu")) for n in "ab"],
        watchdog_threshold=1e9)
    for i in range(3):
        fleet.submit(Request(rid=i, prompt=[4 + i] * 5, max_new=2))
    assert len(fleet.run()) == 3
    assert calls == []
    repro_torch.sync_device(torch.device("cpu"))
    assert calls == []
    repro_torch.sync_device(torch.device("cuda", 0))
    assert calls == [torch.device("cuda", 0)]
