"""The model zoo of the port: the dense family (llama3-8b, qwen3-8b,
phi4-mini-3.8b, h2o-danube-1.8b) as ``nn.Module`` trees."""
