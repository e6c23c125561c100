"""HashMem in PyTorch and CUDA for the NVIDIA H100.

A port of the JAX package ``repro`` (the reference, which it never imports):
``configs`` (HashMemConfig), ``data.kv_synth`` (the paper's workload),
``core`` (hashing, PageStore, the HashMem structure, probe dispatch) and
``kernels`` (the CUDA probe kernel, its plain PyTorch version and its build).
"""
