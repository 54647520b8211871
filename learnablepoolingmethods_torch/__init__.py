"""PyTorch/CUDA port of the YouTube-8M learnable-pooling framework.

Sits beside the JAX package ``learnablepoolingmethods_tpu`` (the reference)
and imports nothing from it.  Plain tensor code is PyTorch; each Pallas
kernel of the reference becomes a CUDA kernel written by hand for Hopper
(sm_90a) under ``csrc/``, built with ``nvcc`` at first use and bound through
``ctypes``.  Every kernel wrapper keeps its plain PyTorch version beside it:
the CPU tests run that version, and ``chip_smoke.py`` holds the kernel
against it on the card.

Ported so far: ``NetVLADModelLF`` inference through the fast path
(``python -m learnablepoolingmethods_torch.inference --fast_infer``).
"""
