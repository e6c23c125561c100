"""Workload generators (numpy only): the paper's key/value workload and the
YCSB mixes (``kv_synth``), and the synthetic LM token stream (``pipeline``)."""
from repro_torch.data.pipeline import SyntheticLMData
