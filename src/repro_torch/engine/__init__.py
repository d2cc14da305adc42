"""Serving engines of the port.  This slice has the diffusion engine."""
from repro_torch.engine.api import (GenerateRequest,  # noqa: F401
                                    GenerateResult, default_sampler,
                                    uses_cfg)
from repro_torch.engine.diffusion_engine import (SD_TURBO, TINY_SD,  # noqa: F401
                                                 DiffusionEngine, SDConfig,
                                                 build_denoise, init_pipeline,
                                                 quantize_pipeline,
                                                 request_noise, steps_bucket)
from repro_torch.engine.events import (Admitted, Cancelled, Event,  # noqa: F401
                                       EventBus, Finished, RequestHandle)
from repro_torch.engine.samplers import get_sampler, list_samplers  # noqa: F401
