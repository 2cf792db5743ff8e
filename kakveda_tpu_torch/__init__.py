"""kakveda-tpu on PyTorch and CUDA: the failure-memory loop on an NVIDIA H100.

A port of ``kakveda_tpu`` (the JAX package, which stays the reference) that
imports ``torch`` and nothing of JAX or of ``kakveda_tpu``. The layout
mirrors the JAX package — ``core/``, ``ops/``, ``index/``, ``pipeline/``,
``events/``, ``platform.py`` — so each module's counterpart is found by
name. Entry points run on the CUDA card unless the caller passes another
``device`` (the tests pass ``"cpu"``); the one TPU kernel on this path,
``fused_topk``, is a hand-written CUDA kernel (``csrc/fused_topk.cu``).
"""

__version__ = "0.1.0"
