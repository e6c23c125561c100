"""HashMem in PyTorch and CUDA for the NVIDIA H100.

A port of the JAX package ``repro`` (the reference, which it never imports):
``configs`` (HashMemConfig, the model zoo's configs, shapes, optimizer,
training and serving configs), ``data`` (the paper's workload, the YCSB
mixes, the synthetic LM token stream), ``core`` (hashing, PageStore, the
HashMem structure and its stacked shards, probe dispatch, the sharded RLU,
the paged KV cache and its page table), ``kernels`` (the CUDA probe
kernels, their plain PyTorch versions and their build), ``models`` (the
dense LM family), ``optim`` (AdamW), ``checkpoint`` (the JAX package's
on-disk format), ``serving`` (the multi-tenant continuous-batching engine
on host shards or on a mesh of stacked shards, its tenancy, metrics,
tracing and YCSB load generator), ``distributed`` (placement of stacked
tables, the train and decode steps, gradient compression, fault
tolerance), ``launch`` (the serve and train CLIs and the serving mesh) and
the examples ``quickstart``, ``serve_multitenant``, ``channels_demo``,
``serve_paged`` and ``train_lm``.
"""
