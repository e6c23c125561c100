"""Workload generators (numpy only): the paper's key/value workload, the
mutation streams, the YCSB mixes and the Fig. 4 dictionary words
(``kv_synth``), and the synthetic LM token stream (``pipeline``)."""
from repro_torch.data.kv_synth import dictionary_words, kv_dataset
from repro_torch.data.pipeline import SyntheticLMData
