"""PyTorch + CUDA port of tpu_smc: Smart Monte Carlo of a confined
Lennard-Jones fluid, chain ensembles on one NVIDIA GPU, with the
whole-sweep kernel written in CUDA C++ (kernels/csrc/sweep.cu)."""
