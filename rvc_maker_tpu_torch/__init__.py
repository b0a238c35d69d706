"""PyTorch/CUDA port of rvc_maker_tpu for NVIDIA Hopper (H100).

The voice-conversion main path (RMVPE f0 -> HuBERT/ContentVec features
-> exact top-8 retrieval blend -> NSF-HiFiGAN synthesizer) in PyTorch.
The HiFi-GAN resblock chain of the decode runs as a hand-written CUDA
kernel (`ops/resblock.py`, `csrc/resblock.cu`).

This package imports torch, numpy and scipy only: no JAX, and nothing of
the `rvc_maker_tpu` package.  Entry points run on `cuda` unless the
caller passes `device="cpu"`; they raise when no card is present.
"""
