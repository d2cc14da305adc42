"""PyTorch / CUDA port of the ``repro`` package for one NVIDIA H100.

The layout mirrors ``repro`` (``configs``, ``core``, ``kernels``,
``models``, ``diffusion``, ``engine``) with the same module and function
names, so each counterpart is easy to find.  This package imports
``torch`` and never ``jax`` or anything of ``repro``.

Entry points (``DiffusionEngine``, ``init_pipeline``, ``generate``) run
on the card (``device="cuda"``) unless the caller asks for the CPU.  On
the card the Pallas kernels of the reference are replaced by CUDA C++
kernels under ``csrc/`` (built with ``nvcc`` at first use); a CPU tensor
takes each kernel's plain PyTorch version.

The reference computes every float32 product in full float32, so TF32
is switched off here for both cuBLAS and cuDNN, and reduced-precision
reductions inside bf16/f16 GEMMs are disallowed (the reference
accumulates those in float32).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    A CUDA device with no card is an error: a run asked for the card
    never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but CUDA is not "
                           "available (pass device='cpu' to run the plain "
                           "PyTorch path)")
    return dev


def sync_device(device: torch.device) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize``
    on a card, nothing on the CPU (where every op has finished when it
    returns).  The engines call it only to time an observed quantum."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
