"""HashMem in PyTorch and CUDA for the NVIDIA H100.

A port of the JAX package ``repro`` (the reference, which it never imports):
``configs`` (HashMemConfig), ``data.kv_synth`` (the paper's workload and the
YCSB mixes), ``core`` (hashing, PageStore, the HashMem structure and its
stacked shards, probe dispatch, the sharded RLU), ``kernels`` (the CUDA
probe kernels, their plain PyTorch versions and their build), ``serving``
(the multi-tenant continuous-batching engine on host shards or on a mesh of
stacked shards, its tenancy, metrics, tracing and YCSB load generator),
``distributed.sharding`` (placement of stacked tables), ``launch`` (the
``kv`` serve CLI and the serving mesh) and the examples ``quickstart``,
``serve_multitenant`` and ``channels_demo``.
"""
