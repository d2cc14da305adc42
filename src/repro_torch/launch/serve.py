"""Serving launcher of the port: LM or diffusion serving through the
engine API (the twin of ``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch granite-8b [--policy q8_0] \
      [--slots 4] [--requests 8] [--gen 16] [--deadline-ms 500] \
      [--admission] [--replicas 2] [--cost-model-path cm.json] \
      [--metrics-out m.json] [--trace-out t.json] [--device cuda]
  python -m repro_torch.launch.serve --arch sd-turbo [--steps 1] \
      [--batch 2] [--requests 4] [--deadline-ms 2000] [--admission]

An LM ``--arch`` is served by ``ContinuousBatcher`` (paged KV pool,
chunked-prefill admission, ``--spec-draft`` speculation); ``sd-turbo``
by ``DiffusionEngine`` (``--steps 1`` runs the turbo sampler, more steps
DDIM; ``--preview-every`` streams decoded previews).  The host loop
consumes the typed event stream and reports time to first token (or
first image) per request.  ``--deadline-ms`` gives every request an SLO
budget (EDF admission).  ``--admission`` attaches a ``CostModel``,
seeded by a deadline-free calibration run: requests whose estimated
service time exceeds their budget are rejected up front.
``--cost-model-path`` loads a saved table if the file exists (skipping
the calibration) and writes the refined table back (the reference's
JSON format).  ``--replicas N`` fronts N replicas, sharing one weight
tree, with a ``FleetManager``.  ``--metrics-out`` / ``--trace-out``
attach ``Telemetry`` and write the metrics snapshot (or Prometheus text
for a ``.prom`` path) and a Chrome trace.

Everything runs on ``--device`` (``cuda`` by default; ``cpu`` runs the
plain kernels at the reduced config, TINY_SD for ``sd-turbo``).
``--asr`` raises: the ASR engine is not ported yet (ROADMAP section 1,
item 6).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import (SD_TURBO, TINY_SD, get_config, reduced,
                                 smoke_inputs)
from repro_torch.core.policy import get_policy
from repro_torch.core.qlinear import param_bytes, quantize_params
from repro_torch.engine import (CostModel, DiffusionEngineConfig,
                                EngineConfig, Finished, FleetManager,
                                GenerateRequest, LMEngineConfig, PreviewLatent,
                                Rejected, ReplicaSpec, SpecDecodeConfig,
                                TokenDelta, calibrate, default_sampler,
                                init_pipeline)
from repro_torch.models.transformer import init_lm
from repro_torch.serving import ContinuousBatcher, Request

DIFFUSION_ARCHS = ("sd-turbo",)


def _args() -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a dense LM (granite-8b, h2o-danube-3-4b, ...) or "
                         "sd-turbo for text-to-image")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (reduced configs)")
    ap.add_argument("--policy", default=None,
                    help="LM weight preset (default: the arch's own); "
                         "diffusion weight_quant (default: none)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=None,
                    help="default: one per slot (per batch row)")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--steps", type=int, default=1,
                    help="denoise steps per image (diffusion)")
    ap.add_argument("--batch", type=int, default=2,
                    help="diffusion micro-batch bucket")
    ap.add_argument("--preview-every", type=int, default=0,
                    help="diffusion: stream a decoded preview every N steps")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO budget (EDF admission)")
    ap.add_argument("--asr", action="store_true",
                    help="streaming transcription (not ported yet: raises)")
    ap.add_argument("--spec-draft", default=None, metavar="ARCH",
                    help="draft-model speculative decoding with this arch "
                         "(same vocabulary as --arch; LM only)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative round")
    ap.add_argument("--admission", action="store_true",
                    help="attach a cost model: reject requests whose "
                         "estimated service time exceeds their budget")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a FleetManager of N replicas")
    ap.add_argument("--cost-model-path", default=None, metavar="PATH",
                    help="load the cost table from PATH if it exists and "
                         "write it back after the run (implies a cost model)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot (JSON, or Prometheus "
                         "text for a .prom path)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of every request")
    return ap.parse_args()


def main() -> None:
    args = _args()
    if args.asr:
        raise NotImplementedError(
            "--asr: the ASR engine is not ported yet (ROADMAP section 1, "
            "item 6)")
    device = torch.device(args.device)
    diffusion = args.arch in DIFFUSION_ARCHS
    n_requests = args.requests or (args.batch if diffusion else args.slots)

    tele = None
    if args.metrics_out or args.trace_out:
        from repro_torch.obs import Telemetry, TraceRecorder
        tele = Telemetry(tracer=TraceRecorder() if args.trace_out else None)
    cm, restored = None, False
    if args.admission or args.cost_model_path:
        if args.cost_model_path and os.path.exists(args.cost_model_path):
            cm = CostModel.load(args.cost_model_path)
            restored = True
            print(f"cost model restored from {args.cost_model_path} "
                  f"({len(cm.snapshot())} phase entries)")
        else:
            cm = CostModel()
        cm.metrics = tele       # estimate-vs-actual error histograms

    if diffusion:
        cfg = TINY_SD if device.type == "cpu" else SD_TURBO
        wq = None if args.policy in (None, "none") else args.policy
        params = init_pipeline(0, cfg, device=device)
        print(f"{cfg.name} [{wq or 'bf16'}]: "
              f"{param_bytes(params) / 1e6:.1f} MB")
        kind = "diffusion"
        econf = EngineConfig(cost_model=cm, metrics=tele, weight_quant=wq,
                             diffusion=DiffusionEngineConfig(
                                 max_batch=args.batch))
        vocab = cfg.clip_cfg().vocab_size
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, vocab, (n_requests, cfg.text_len),
                                generator=gen).tolist()
        sampler = default_sampler(args.steps)

        def make_req(rid, i, deadline_ms=None):
            return GenerateRequest(
                rid=rid, tokens=prompts[i % n_requests], seed=i,
                sampler=sampler, steps=args.steps, deadline_ms=deadline_ms,
                preview_every=args.preview_every,
                preview_decode=bool(args.preview_every))
    else:
        cfg = get_config(args.arch)
        if device.type == "cpu":
            cfg = reduced(cfg)
        policy = get_policy(args.policy or cfg.default_policy)
        params = init_lm(torch.Generator(device=device).manual_seed(0), cfg)
        params = quantize_params(params, policy)
        print(f"{cfg.name} [{policy.name}]: {param_bytes(params) / 1e6:.1f} MB")
        spec_decode = None
        if args.spec_draft:
            dcfg = get_config(args.spec_draft)
            if device.type == "cpu":
                dcfg = reduced(dcfg)
            if dcfg.vocab_size != cfg.vocab_size:
                raise SystemExit(
                    f"--spec-draft {dcfg.name} vocab {dcfg.vocab_size} != "
                    f"target vocab {cfg.vocab_size}")
            dparams = init_lm(torch.Generator(device=device).manual_seed(2),
                              dcfg)
            print(f"speculative draft {dcfg.name}: k={args.spec_k}")
            spec_decode = SpecDecodeConfig(draft_params=dparams,
                                           draft_cfg=dcfg, k=args.spec_k)
        max_len = ContinuousBatcher.required_len(n_requests, args.slots,
                                                 args.prompt_len, args.gen)
        kind = "lm"
        econf = EngineConfig(cost_model=cm, metrics=tele, lm=LMEngineConfig(
            slots=args.slots, max_len=max_len, spec_decode=spec_decode))
        prompts = smoke_inputs(1, cfg, batch=args.slots,
                               seq=args.prompt_len)["tokens"].tolist()

        def make_req(rid, i, deadline_ms=None):
            return Request(rid=rid, prompt=prompts[i % args.slots],
                           max_new=args.gen, deadline_ms=deadline_ms)

    # One EngineConfig and one weight tree describe every replica; each
    # replica owns its caches.
    def make_spec(name):
        return ReplicaSpec(name, params=params, model_cfg=cfg, engine=kind,
                           config=econf, device=device)

    if args.replicas > 1:
        engine = FleetManager([make_spec(f"replica{i}")
                               for i in range(args.replicas)], metrics=tele)
        engines = [r.engine for r in engine.replicas]
    else:
        engine = make_spec("solo").make()
        engines = [engine]
    if tele is not None:
        # After the fleet rebinds the buses: subscriptions live on a bus.
        tele.attach(engine.bus)

    if cm is not None and not restored:
        # Calibration: deadline-free requests seed the phase table (and
        # pay every first call, which the engines leave unobserved).
        calibrate(engine, [make_req(-1 - w, 0)
                           for w in range(2 * args.replicas)])
    if cm is not None:
        if diffusion:
            keys = cm._diff_keys(engines[0], make_req(0, 0))
            print("calibrated: " + ", ".join(
                f"{name} {(cm.cost(keys[name]) or 0) * 1e3:.1f} ms"
                for name in ("fused", "clip", "unet", "vae")))
        else:
            kp, kd = cm.lm_keys(engines[0])
            print(f"calibrated: prefill chunk {(cm.cost(kp) or 0) * 1e3:.1f}"
                  f" ms, decode token {(cm.cost(kd) or 0) * 1e3:.1f} ms")
    q0 = sum(getattr(e, "quanta", 0) + getattr(e, "prefill_quanta", 0)
             + getattr(e, "decode_quanta", 0) for e in engines)
    submit_ts = {}
    for r in range(n_requests):
        submit_ts[r] = engine.bus.clock()
        engine.submit(make_req(r, r, deadline_ms=args.deadline_ms))
    t0 = time.time()
    done, first, rejected, previews = [], {}, [], 0
    for e in engine.stream():
        if isinstance(e, (TokenDelta, Finished)) and e.rid in submit_ts \
                and e.rid not in first:
            first[e.rid] = e.ts - submit_ts[e.rid]
        if isinstance(e, Finished) and e.rid >= 0:
            done.append(e.result)
        elif isinstance(e, Rejected):
            rejected.append(e)
        elif isinstance(e, PreviewLatent):
            previews += 1
    dt = time.time() - t0
    quanta = sum(getattr(e, "quanta", 0) + getattr(e, "prefill_quanta", 0)
                 + getattr(e, "decode_quanta", 0) for e in engines) - q0
    if diffusion:
        print(f"served {len(done)} images in {dt:.2f}s ({quanta} quanta, "
              f"{previews} previews, batch bucket {args.batch})")
    else:
        n_tok = sum(len(d.prompt) + len(d.out) for d in done)
        print(f"served {len(done)} requests / {n_tok} tokens in {dt:.2f}s "
              f"({quanta} prefill + decode quanta)")
        if args.spec_draft:
            prop = sum(b.spec_proposed for b in engines)
            acc = sum(b.spec_accepted for b in engines)
            print(f"speculation: {acc}/{prop} draft tokens accepted "
                  f"({acc / max(1, prop):.0%})")
    if args.replicas > 1:
        for rs in engine.stats()["replicas"]:
            print(f"  {rs['name']}: {rs['state']}, {rs['steps']} quanta")
    for e in rejected:
        print(f"rejected rid {e.rid} ({e.reason}): estimated "
              f"{e.estimated_s * 1e3:.1f} ms > budget "
              f"{e.budget_s * 1e3:.1f} ms")
    if first:
        what = "first image" if diffusion else "ttft"
        print(f"{what}: first {min(first.values()):.2f}s / worst "
              f"{max(first.values()):.2f}s")
    if done and not diffusion:
        print("first request:", done[0].prompt + done[0].out)
    if cm is not None and args.cost_model_path:
        cm.save(args.cost_model_path)
        print(f"cost model saved to {args.cost_model_path} "
              f"({len(cm.snapshot())} phase entries)")
    if tele is not None:
        if args.metrics_out:
            if args.metrics_out.endswith(".prom"):
                with open(args.metrics_out, "w") as f:
                    f.write(tele.registry.to_prometheus())
            else:
                tele.registry.write_snapshot(args.metrics_out)
            print(f"metrics snapshot written to {args.metrics_out} "
                  f"({len(tele.registry.instruments())} instruments)")
        if args.trace_out and tele.tracer is not None:
            tele.tracer.export(args.trace_out)
            print(f"trace written to {args.trace_out} "
                  f"({len(tele.tracer.spans)} spans, "
                  f"{len(tele.tracer.markers)} markers)")


if __name__ == "__main__":
    main()
