"""Hand-written Hopper kernels and their plain PyTorch versions.

``ops`` is the dispatch layer the engine calls: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version.
"""
