"""PyTorch + CUDA port of triforce-tpu for one NVIDIA Hopper card.

Beside the JAX package (``triforce_tpu``), which stays the reference: the
same module names, the same cache layouts and the same decode algorithms,
with the TPU's Pallas kernels replaced by CUDA kernels written for
``sm_90a`` (``csrc/``, built at first CUDA use by ``_build.py``). Every entry
point runs on the card unless the caller passes ``device="cpu"``; on the
CPU each kernel wrapper takes its plain PyTorch version. On the card the
decode forwards replay captured CUDA graphs (``graphs.py``).
"""
