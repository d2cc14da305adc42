"""Serving engines of the port: the diffusion engine (fused and segmented
preview paths) and the shared ``EngineConfig``."""
from repro_torch.engine.api import (GenerateRequest,  # noqa: F401
                                    GenerateResult, default_sampler,
                                    uses_cfg)
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
from repro_torch.engine.events import (Admitted, Cancelled, Event,  # noqa: F401
                                       EventBus, Finished, Preempted,
                                       PreviewLatent, Progress, Rejected,
                                       RequestHandle, TokenDelta)
from repro_torch.engine.samplers import get_sampler, list_samplers  # noqa: F401
