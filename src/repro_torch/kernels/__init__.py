"""Hopper kernels of the port and their plain PyTorch versions.

============================  ==========================================
``flash_attention``           ``csrc/flash_attention.cu`` (replaces
                              ``repro/kernels/flash_attention.py``)
``q8_matmul``                 ``csrc/q8_matmul.cu`` (replaces
                              ``repro/kernels/q8_matmul.py:q8_matmul``)
``q3k_matmul``                ``csrc/q3k_matmul.cu`` (replaces
                              ``repro/kernels/q3k_matmul.py``)
``flash_prefill_paged``       ``csrc/flash_prefill.cu`` (replaces
                              ``repro/kernels/flash_prefill.py:
                              flash_prefill_paged``)
``flash_prefill_paged_q8``    ``csrc/flash_prefill.cu``, second entry
                              (replaces ``flash_prefill_paged_q8``)
``flash_decode_paged``        ``csrc/flash_decode.cu`` (replaces
                              ``repro/kernels/flash_decode.py:
                              flash_decode_paged``)
``flash_decode``              ``csrc/flash_decode.cu``, second entry
                              (replaces ``flash_decode``)
``q4_matmul``                 ``csrc/q4_matmul.cu`` (replaces
                              ``repro/kernels/q4_matmul.py``)
``q8_matmul_w8a8``            ``csrc/q8_matmul_w8a8.cu`` (replaces
                              ``repro/kernels/q8_matmul.py:
                              q8_matmul_w8a8``)
============================  ==========================================

Plain versions live in :mod:`repro_torch.kernels.ref` and, for the
attention kernels of the KV caches, beside their wrappers; dispatch by the
tensor's device in :mod:`repro_torch.kernels.ops`; the ``nvcc`` build
in :mod:`repro_torch.kernels.build`.
"""
