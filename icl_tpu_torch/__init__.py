"""icl_tpu_torch: the PyTorch + CUDA port of icl_tpu.

A package of its own beside `icl_tpu` (the JAX reference). It imports
torch, numpy and scipy, and nothing of JAX or of `icl_tpu`. Module names
mirror `icl_tpu`'s so each counterpart is easy to find. Entry points run
on the CUDA card unless the caller passes `device="cpu"`.
"""
