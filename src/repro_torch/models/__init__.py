"""Model definitions of the port: CLIP, the SD UNet and the VAE decoder."""
