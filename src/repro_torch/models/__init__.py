"""The model zoo of the port as ``nn.Module`` trees: the dense family
(llama3-8b, qwen3-8b, phi4-mini-3.8b, h2o-danube-1.8b), the moe family
(olmoe-1b-7b, llama4-maverick-400b-a17b), the hybrid family
(jamba-v0.1-52b), the ssm family (xlstm-1.3b), the encdec family
(whisper-tiny) and the vlm family (internvl2-2b)."""
