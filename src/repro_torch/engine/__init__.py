"""Serving engines of the port: the diffusion engine (fused and segmented
preview paths), the streaming ASR engine, the shared ``EngineConfig``,
the cost model, the router and the replica fleet."""
from repro_torch.engine.api import (Engine, GenerateRequest,  # noqa: F401
                                    GenerateResult, TranscribeRequest,
                                    default_sampler, is_transcribe, uses_cfg)
from repro_torch.engine.asr_engine import AsrEngine  # noqa: F401
from repro_torch.engine.config import (AsrEngineConfig,  # noqa: F401
                                       DiffusionEngineConfig, EngineConfig,
                                       LMEngineConfig, SpecDecodeConfig,
                                       build_engine)
from repro_torch.engine.diffusion_engine import (SD_TURBO, TINY_SD,  # noqa: F401
                                                 DiffusionEngine, SDConfig,
                                                 build_denoise,
                                                 build_denoise_step,
                                                 build_encode,
                                                 build_finalize_decode,
                                                 init_pipeline,
                                                 quantize_pipeline,
                                                 request_noise, steps_bucket)
from repro_torch.engine.costmodel import CostModel, calibrate  # noqa: F401
from repro_torch.engine.events import (Admitted, Cancelled, Event,  # noqa: F401
                                       EventBus, Finished, Preempted,
                                       PreviewLatent, Progress, Rejected,
                                       RequestHandle, TokenDelta)
from repro_torch.engine.fleet import (FaultInjector, FleetManager,  # noqa: F401
                                      ReplicaFault, ReplicaSpec)
from repro_torch.engine.router import EngineRouter  # noqa: F401
from repro_torch.engine.samplers import get_sampler, list_samplers  # noqa: F401
