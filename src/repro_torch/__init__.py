"""HashMem in PyTorch and CUDA for the NVIDIA H100.

A port of the JAX package ``repro`` (the reference, which it never imports):
``configs`` (HashMemConfig), ``data.kv_synth`` (the paper's workload and the
YCSB mixes), ``core`` (hashing, PageStore, the HashMem structure, probe
dispatch, the host shard router), ``kernels`` (the CUDA probe kernels, their
plain PyTorch versions and their build), ``serving`` (the multi-tenant
continuous-batching engine on host shards, its tenancy, metrics, tracing and
YCSB load generator) and ``launch`` (the ``kv`` serve CLI).
"""
