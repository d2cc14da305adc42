"""Hopper kernels of the port and their plain PyTorch versions.

========================  ==============================================
``flash_attention``       ``csrc/flash_attention.cu`` (replaces
                          ``repro/kernels/flash_attention.py``)
``q8_matmul``             ``csrc/q8_matmul.cu`` (replaces
                          ``repro/kernels/q8_matmul.py:q8_matmul``)
``q3k_matmul``            ``csrc/q3k_matmul.cu`` (replaces
                          ``repro/kernels/q3k_matmul.py``)
========================  ==============================================

Plain versions live in :mod:`repro_torch.kernels.ref`; dispatch by the
tensor's device in :mod:`repro_torch.kernels.ops`; the ``nvcc`` build
in :mod:`repro_torch.kernels.build`.
"""
