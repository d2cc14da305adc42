from repro_torch.configs.base import (SD15_UNET, SD15_VAE, SD_TURBO,  # noqa: F401
                                      TINY_CLIP, TINY_SD, TINY_UNET,
                                      TINY_VAE, ModelConfig, SDConfig,
                                      UNetConfig, VAEConfig, clip_config)
