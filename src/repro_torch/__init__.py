"""PyTorch/CUDA port of the GP training and model-comparison system.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``repro_torch.core.engine`` is the counterpart of
``repro.core.engine``) and ports it slice by slice (ROADMAP.md, queue A).
It imports torch, numpy and the standard library only.
"""
