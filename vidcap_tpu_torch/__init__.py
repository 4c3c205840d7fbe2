"""vidcap_tpu_torch: the PyTorch/CUDA port of vidcap_tpu for NVIDIA Hopper.

Beam-5, greedy and sampled captioning of precomputed video features, and
staged XE → SCST training, with the beam step's recurrent core and vocab
projection + top-K (ops/beam_core.py, ops/topk_project.py) and the whole
greedy or sampled rollout (ops/rollout.py) as hand-written sm_90a kernels.
Imports torch and numpy only.
"""
