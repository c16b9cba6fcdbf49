"""PyTorch + CUDA port of mapquik-tpu for NVIDIA Hopper.

Builds the hash index of a reference, maps HiFi reads in length-binned
batches and writes PAF lines identical to `mapquik_tpu`'s. The two seeding
kernels are CUDA C++ under `csrc/`, built with nvcc at first use.
"""
