"""centrifuge_tpu_torch: the PyTorch/CUDA port of centrifuge_tpu.

Classifies metagenomic reads on one NVIDIA GPU (written for the H100,
sm_90a), byte-identical to the JAX package and to the reference
Centrifuge outputs. The layout follows centrifuge_tpu/ so each module
has a counterpart there:

  csrc/      hand-written CUDA kernels: rank (K0), greedy FM search (K1),
             SA resolve walk (K3), depth-12 ftab (K4), presolve (K5), the
             sharded search and walk (K6), and their shared per-lane header
  _cuda.py   nvcc -> shared library -> ctypes loader, launch counters
  ops/       the device FM index (fm_torch) and the rank kernel wrapper
  classify/  the search engine (K1, K5) and the GPU classification pipeline
  parallel/  the (dp, fm) mesh path (K6) and one pipeline per process
  cli/       the tools of `python -m centrifuge_tpu_torch <tool>`
  evaluation/  simulate, evaluate, the 256 Mbp database, the tile sweep
             and prof (the main path's cost breakdown on the card)
  native/    the C++ host tail: assignment, SA resolve walk, read packing
  index/ io/ report/ build/ utils/   host modules (copies of the JAX
             package's jax-free modules)

Entry points run on "cuda" unless the caller passes device="cpu", which
runs the plain PyTorch versions of the kernels (the tests do).
"""

__version__ = "0.1.0"
