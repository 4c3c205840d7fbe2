"""vidcap_tpu_torch: the PyTorch/CUDA port of vidcap_tpu for NVIDIA Hopper.

Beam-5 captioning of precomputed video features, with the beam step's
recurrent core and vocab projection + top-K as hand-written sm_90a kernels
(ops/beam_core.py, ops/topk_project.py). Imports torch and numpy only.
"""
